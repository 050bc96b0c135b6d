"""Stock trainer extensions: LogReport, PrintReport, StepTimer,
TorchProfiler, EvaluatorExtension and snapshot.

Counterpart of ``chainermn_tpu/training/extensions.py`` (Chainer's
``training/extensions``).  One name changes: the JAX package's
``JaxProfiler`` (a ``jax.profiler`` trace of an iteration window) is
:class:`TorchProfiler` here, a ``torch.profiler`` trace of the same
window (same ``logdir``, ``start`` and ``stop``, the same refusal of an
empty window), written as a Chrome trace.  Device scalars in observations
are read when LogReport folds them in.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .trainer import PRIORITY_READER, PRIORITY_WRITER


def _scalarize(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.detach().cpu())
    return float(np.asarray(v))


class LogReport:
    """Accumulate observations; write mean entries every trigger.

    Entries land in ``trainer.out/log`` (JSON list, Chainer-compatible
    layout) and stay available in ``.log`` for PrintReport.
    """

    trigger = (1, "epoch")
    priority = PRIORITY_WRITER

    def __init__(self, keys: Optional[Sequence[str]] = None,
                 trigger=(1, "epoch"), filename: str = "log"):
        self.keys = keys
        self.trigger = trigger
        self.filename = filename
        self.log: List[Dict[str, Any]] = []
        self._accum: Dict[str, List[float]] = {}

    def initialize(self, trainer) -> None:
        os.makedirs(trainer.out, exist_ok=True)

    def _accumulate(self, observation) -> None:
        for k, v in observation.items():
            if self.keys is not None and k not in self.keys:
                continue
            try:
                self._accum.setdefault(k, []).append(_scalarize(v))
            except (TypeError, ValueError, RuntimeError):
                pass  # non-scalar observation; LogReport only handles scalars

    def observe(self, trainer) -> None:
        # Trainer calls this every iteration: fold the step's observation
        # into the running means regardless of when the write trigger fires.
        self._accumulate(trainer.observation)

    def __call__(self, trainer) -> None:
        entry = {k: float(np.mean(vs)) for k, vs in self._accum.items()}
        entry.update({
            "iteration": trainer.iteration,
            "epoch": trainer.epoch,
            "elapsed_time": trainer.elapsed_time,
        })
        self.log.append(entry)
        self._accum = {}
        with open(os.path.join(trainer.out, self.filename), "w") as f:
            json.dump(self.log, f, indent=2)

    def state_dict(self) -> dict:
        # In-flight accumulators are part of the resume contract: a
        # mid-epoch checkpoint must reproduce the same epoch means as an
        # uninterrupted run.
        return {"log": self.log, "accum": self._accum}

    def load_state_dict(self, state: dict) -> None:
        self.log = list(state["log"])
        self._accum = {k: list(v) for k, v in state.get("accum", {}).items()}


class PrintReport:
    """Print selected LogReport columns as they appear (rank-0 style)."""

    trigger = (1, "epoch")
    priority = PRIORITY_READER

    def __init__(self, entries: Sequence[str], log_report: LogReport,
                 trigger=(1, "epoch")):
        self.entries = list(entries)
        self.log_report = log_report
        self.trigger = trigger
        self._printed = 0
        self._header_done = False

    def state_dict(self) -> dict:
        # Resume without re-printing the restored history.
        return {"printed": self._printed, "header_done": self._header_done}

    def load_state_dict(self, state: dict) -> None:
        self._printed = int(state["printed"])
        self._header_done = bool(state["header_done"])

    def __call__(self, trainer) -> None:
        if not self._header_done:
            print("  ".join(f"{e:>14}" for e in self.entries), flush=True)
            self._header_done = True
        for entry in self.log_report.log[self._printed:]:
            cells = []
            for e in self.entries:
                v = entry.get(e, "")
                cells.append(f"{v:14.6g}" if isinstance(v, float) else f"{v!s:>14}")
            print("  ".join(cells), flush=True)
        self._printed = len(self.log_report.log)


class StepTimer:
    """Per-step wall time (s) into ``observation['time/step']``.

    LogReport folds the value into epoch means, giving
    throughput directly from the training log.  Priority above the writers
    so the stamp lands before LogReport.observe reads the observation.
    """

    trigger = (1, "iteration")
    priority = PRIORITY_WRITER + 50

    def __init__(self, key: str = "time/step"):
        self.key = key
        self._last: Optional[float] = None

    def observe(self, trainer) -> None:
        import time

        now = time.perf_counter()
        if self._last is not None:
            trainer.observation[self.key] = now - self._last
        self._last = now

    def __call__(self, trainer) -> None:
        pass

    def state_dict(self) -> dict:
        return {}  # wall-clock gaps across a resume are meaningless; restart

    def load_state_dict(self, state: dict) -> None:
        self._last = None


class TorchProfiler:
    """Capture a ``torch.profiler`` trace of iterations [start, stop).

    The port of the JAX package's ``JaxProfiler``: the trace lands in
    ``logdir`` as a Chrome trace (``trace.<host>.<pid>.json``, one per
    process), holding the card's kernels when CUDA is available.  The
    defaults skip iterations 0-1 so warm-up does not drown the steady
    state.  ``profile`` keeps the stopped profiler (``key_averages()``).
    """

    trigger = (1, "iteration")
    priority = PRIORITY_WRITER + 60  # bracket the step before observers run

    def __init__(self, logdir: str = "profile", start: int = 2,
                 stop: int = 5):
        if stop <= start:
            raise ValueError(f"need stop > start, got [{start}, {stop})")
        self.logdir = logdir
        self.start_iteration = int(start)
        self.stop_iteration = int(stop)
        self.profile = None
        self.trace_path: Optional[str] = None
        self._active = False
        self._done = False

    def observe(self, trainer) -> None:
        it = trainer.iteration
        if (not self._done and not self._active
                and it + 1 >= self.start_iteration
                and it < self.stop_iteration):
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.profile = profile(activities=activities)
            self.profile.start()
            self._active = True
        elif self._active and it + 1 >= self.stop_iteration:
            self._stop()

    def _stop(self) -> None:
        # wait for the card so the window holds the steps' device work
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.stop()
        self._active = False
        self._done = True
        os.makedirs(self.logdir, exist_ok=True)
        self.trace_path = os.path.join(
            self.logdir, f"trace.{socket.gethostname()}.{os.getpid()}.json")
        self.profile.export_chrome_trace(self.trace_path)

    def __call__(self, trainer) -> None:
        pass

    def finalize(self) -> None:
        if self._active:
            self._stop()

    def state_dict(self) -> dict:
        return {"done": self._done}

    def load_state_dict(self, state: dict) -> None:
        self._done = bool(state.get("done", False))
        self._active = False


# the JAX package's name for the same extension
JaxProfiler = TorchProfiler


class EvaluatorExtension:
    """Run a multi-node evaluator on a trigger, merging results into the
    observation under ``validation/`` keys (Chainer's ``Evaluator`` slot)."""

    trigger = (1, "epoch")
    priority = PRIORITY_WRITER + 50  # before LogReport writes the entry

    def __init__(self, evaluate_fn: Callable[[Any], Dict[str, float]],
                 data, trigger=(1, "epoch"), prefix: str = "validation/"):
        self.evaluate_fn = evaluate_fn
        self.data = data
        self.trigger = trigger
        self.prefix = prefix

    def __call__(self, trainer) -> None:
        results = self.evaluate_fn(self.data)
        trainer.observation.update(
            {f"{self.prefix}{k}": v for k, v in results.items()})


def snapshot(checkpointer, trigger=None):
    """Adapt a checkpointer (any callable ``checkpointer(trainer)`` with a
    ``trigger``: :class:`~chainermn_tpu_torch.extensions.checkpoint
    .MultiNodeCheckpointer` or a ``multi_node_snapshot``) into a trainer
    extension (the reference's ``trainer.extend(checkpointer,
    trigger=...)`` usage).

    Thin wrapper over the checkpointer's own extension ``__call__`` (single
    save path) whose only job is overriding the trigger and shielding the
    trainer from the checkpointer's ``finalize`` (which deletes shards —
    cleanup belongs to explicit job teardown, not loop exit).
    """
    from .trainer import make_extension

    trig = trigger or checkpointer.trigger

    @make_extension(trigger=trig, priority=PRIORITY_WRITER,
                    name="multi_node_snapshot")
    def _snap(trainer):
        checkpointer(trainer)
    return _snap
