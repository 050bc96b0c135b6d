"""The Trainer: run the updater until a stop trigger, firing extensions.

Counterpart of ``chainermn_tpu/training/trainer.py`` (Chainer's
``Trainer``).  Extensions are callables ``ext(trainer)`` registered with
an interval trigger and a priority; higher priority runs first within an
iteration so aggregators (ObservationAggregator) run before writers
(LogReport) before readers (PrintReport), Chainer's three bands
(PRIORITY_EDITOR / WRITER / READER).  Each iteration is a ``step`` span
holding the updater's ``step/data`` and ``step/compute`` spans and
``step/extensions`` (one ``ext/<name>`` span each), and each completed
update is noted in the flight recorder's ring (``phase``), as in the JAX
package.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..observability import flight as _flight
from ..observability import trace as _trace
from .triggers import get_trigger

PRIORITY_EDITOR = 300   # mutate trainer.observation (aggregators)
PRIORITY_WRITER = 200   # persist observations (LogReport, snapshots)
PRIORITY_READER = 100   # consume logs (PrintReport)


class Extension:
    """Optional base class; any callable(trainer) works."""

    trigger = (1, "iteration")
    priority = PRIORITY_READER
    name: Optional[str] = None

    def __call__(self, trainer) -> None:
        raise NotImplementedError

    def initialize(self, trainer) -> None:
        pass

    def finalize(self) -> None:
        pass


def make_extension(trigger=(1, "iteration"), priority=PRIORITY_READER,
                   name=None):
    """Decorator stamping trigger/priority onto a plain function."""
    def wrap(fn):
        fn.trigger = trigger
        fn.priority = priority
        fn.name = name or fn.__name__
        return fn
    return wrap


class _Entry:
    def __init__(self, ext, trigger, priority, name):
        self.extension = ext
        self.trigger = get_trigger(trigger)
        self.priority = priority
        self.name = name


class Trainer:
    """Drive ``updater.update()`` until ``stop_trigger``; fire extensions."""

    def __init__(self, updater, stop_trigger, out: str = "result"):
        self.updater = updater
        period, unit = stop_trigger
        self._stop_period, self._stop_unit = period, unit
        self.out = out
        self.observation: Dict[str, Any] = {}
        self._extensions: Dict[str, _Entry] = {}
        self._start_time: Optional[float] = None
        # Monotonic stamp of the last completed unit of work (a step or any
        # single extension).  Liveness monitors (extensions.Watchdog) read
        # this so a slow-but-progressing extension pass is not mistaken for
        # a hang — only one stuck unit can exceed the timeout.
        self.last_progress: Optional[float] = None
        # Name of the last COMPLETED unit ("update" or "extension:<name>")
        # — the Watchdog includes it in stall reports, and the step-time
        # breakdown reads last_extension_time (the previous iteration's
        # whole extension pass, seconds).
        self.last_phase: Optional[str] = None
        self.last_extension_time: Optional[float] = None

    # ---- passthroughs the extensions read ----
    @property
    def iteration(self) -> int:
        return self.updater.iteration

    @property
    def epoch(self) -> int:
        return self.updater.epoch

    @property
    def epoch_detail(self) -> float:
        return self.updater.epoch_detail

    @property
    def is_new_epoch(self) -> bool:
        return self.updater.is_new_epoch

    @property
    def elapsed_time(self) -> float:
        return 0.0 if self._start_time is None else time.time() - self._start_time

    # ---- extension registry ----
    def extend(self, extension: Callable, trigger=None, priority=None,
               name: Optional[str] = None) -> None:
        trigger = trigger if trigger is not None else getattr(
            extension, "trigger", (1, "iteration"))
        priority = priority if priority is not None else getattr(
            extension, "priority", PRIORITY_READER)
        name = name or getattr(extension, "name", None) \
            or type(extension).__name__
        base, i = name, 0
        while name in self._extensions:
            i += 1
            name = f"{base}_{i}"
        self._extensions[name] = _Entry(extension, trigger, priority, name)

    def get_extension(self, name: str):
        return self._extensions[name].extension

    # ---- the loop ----
    def _stopped(self) -> bool:
        if self._stop_unit == "iteration":
            return self.iteration >= self._stop_period
        return self.epoch >= self._stop_period

    def run(self) -> None:
        if self._start_time is None:  # a resumed trainer keeps its offset
            self._start_time = time.time()
        for e in self._extensions.values():
            if hasattr(e.extension, "initialize"):
                e.extension.initialize(self)
        tracer = _trace.get_tracer()
        try:
            while not self._stopped():
                with tracer.span("step", cat="step",
                                 iteration=self.iteration + 1):
                    self.observation = self.updater.update()
                    self.last_progress = time.monotonic()
                    self.last_phase = "update"
                    _flight.note("phase", name="update",
                                 iteration=self.iteration)
                    t_ext = time.perf_counter()
                    with tracer.span("step/extensions", cat="phase"):
                        for e in sorted(self._extensions.values(),
                                        key=lambda e: -e.priority):
                            # Extensions with an ``observe`` hook see EVERY
                            # iteration (e.g. LogReport folding per-step stats
                            # into its means); ``__call__`` still fires only on
                            # the trigger — the same split Chainer's reporter/
                            # summary machinery provided.
                            with tracer.span(f"ext/{e.name}", cat="extension"):
                                if hasattr(e.extension, "observe"):
                                    e.extension.observe(self)
                                if e.trigger(self):
                                    e.extension(self)
                            self.last_progress = time.monotonic()
                            self.last_phase = f"extension:{e.name}"
                    self.last_extension_time = time.perf_counter() - t_ext
        except BaseException:
            # Liveness monitors (Watchdog) MUST stop on the exception path —
            # a still-armed watchdog would os._exit a process that is busy
            # saving diagnostics.  Everything else keeps the no-finalize-on-
            # crash contract (see below).
            for e in self._extensions.values():
                if (getattr(e.extension, "finalize_on_error", False)
                        and hasattr(e.extension, "finalize")):
                    e.extension.finalize()
            raise
        # Finalize ONLY on clean completion (divergence from Chainer's
        # finally-block, deliberately): extensions like the
        # checkpointer delete their fault-tolerance artifacts in finalize,
        # and doing that on the exception path would destroy exactly the
        # state a crashed job needs to resume from.
        for e in self._extensions.values():
            if hasattr(e.extension, "finalize"):
                e.extension.finalize()

    # ---- resume contract (MultiNodeCheckpointer calls checkpoint_state) ----
    def checkpoint_state(self) -> dict:
        state = {"updater": self.updater.state_dict(), "extensions": {},
                 "elapsed_time": self.elapsed_time}
        for name, e in self._extensions.items():
            if hasattr(e.extension, "state_dict"):
                state["extensions"][name] = e.extension.state_dict()
            if hasattr(e.trigger, "state_dict"):
                state["extensions"][f"{name}/trigger"] = e.trigger.state_dict()
        return state

    def load_checkpoint_state(self, state: dict) -> None:
        self.updater.load_state_dict(state["updater"])
        # Keep elapsed_time monotonic across the resume boundary.
        self._start_time = time.time() - float(state.get("elapsed_time", 0.0))
        for name, e in self._extensions.items():
            if name in state["extensions"] and hasattr(e.extension, "load_state_dict"):
                e.extension.load_state_dict(state["extensions"][name])
            tkey = f"{name}/trigger"
            if tkey in state["extensions"] and hasattr(e.trigger, "load_state_dict"):
                e.trigger.load_state_dict(state["extensions"][tkey])
