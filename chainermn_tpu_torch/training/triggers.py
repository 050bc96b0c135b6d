"""Interval triggers: a copy of ``chainermn_tpu/training/triggers.py``
(Chainer's ``training.triggers.IntervalTrigger``)."""

from __future__ import annotations

from typing import Tuple, Union


class IntervalTrigger:
    """Fires every ``period`` iterations or epochs.

    Epoch triggering uses ``epoch_detail`` (fractional epochs from the
    iterator) so uneven shard sizes and mid-epoch resumes stay correct —
    the same contract Chainer's trigger relied on.
    """

    def __init__(self, period: Union[int, float], unit: str):
        if unit not in ("iteration", "epoch"):
            raise ValueError(f"unit must be iteration|epoch, got {unit!r}")
        self.period = period
        self.unit = unit
        self._last_epoch_detail = 0.0

    def __call__(self, trainer) -> bool:
        if self.unit == "iteration":
            return trainer.iteration % self.period == 0
        prev, cur = self._last_epoch_detail, trainer.epoch_detail
        self._last_epoch_detail = cur
        return int(prev / self.period) != int(cur / self.period)

    def state_dict(self) -> dict:
        return {"last_epoch_detail": self._last_epoch_detail}

    def load_state_dict(self, state: dict) -> None:
        self._last_epoch_detail = float(state["last_epoch_detail"])


def get_trigger(trigger) -> IntervalTrigger:
    """Normalize ``(period, unit)`` tuples / None / callables to a trigger."""
    if trigger is None:
        return IntervalTrigger(1, "iteration")
    if isinstance(trigger, tuple):
        return IntervalTrigger(*trigger)
    if callable(trigger):
        return trigger
    raise TypeError(f"cannot interpret trigger {trigger!r}")
