"""Hang/deadlock detection for distributed training.

Counterpart of ``chainermn_tpu/extensions/watchdog.py``.  The reference
had deadlock *mitigation* only: the global except hook turns a raised
exception into ``MPI_Abort``, but a rank stuck inside a collective raises
nothing and the gang hangs silently (the classic NCCL failure mode).

This extension closes that gap: a daemon thread watches the wall-clock gap
since the last completed training step and, when it exceeds ``timeout``,
dumps every Python thread's stack (so the hang site is in the log) and
aborts the process loudly (exit 43) — by default through the same bounded
process-group teardown as :mod:`chainermn_tpu_torch.global_except_hook`,
so one hung rank kills the whole gang instead of wedging it.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional


def _default_abort(gap: float, timeout: float) -> None:
    print(f"[chainermn_tpu_torch watchdog] no step completed for "
          f"{gap:.0f}s (timeout {timeout:.0f}s) — dumping stacks and "
          f"aborting the gang", file=sys.stderr, flush=True)
    faulthandler.dump_traceback(file=sys.stderr)
    from ..topology import abort_process_group
    abort_process_group(timeout_s=5.0)
    os._exit(43)


class Watchdog:
    """Abort the job if no training step completes within ``timeout``.

    Register like any trainer extension; ``observe`` (called every
    iteration) feeds the heartbeat, and the watcher ALSO reads the
    trainer's ``last_progress`` stamp, which the loop updates after the
    step and after every individual extension — so a slow-but-progressing
    extension pass (a long eval, a checkpoint flush) never false-triggers;
    only ONE unit of work stuck for longer than ``timeout`` fires.

    ``action(gap, timeout)`` overrides the abort for testing or custom
    escalation; the default tears the process group down and kills the
    process, so the rest of the gang dies loudly rather than waiting in a
    collective.  The timer arms at the FIRST completed unit of work and
    disarms at ``finalize`` (and on the trainer's exception path) — setup
    and the first step's kernel builds cannot false-trigger.

    Evidence flush: before ``action`` runs, the watchdog
    best-effort dumps the stall evidence to ``dump_dir`` (default: the
    trainer's ``out`` directory) — a final trace export
    (``watchdog_trace.json``, rank-sharded when ``rank`` is given) and a
    ``watchdog_health.json`` :func:`observability.export.health_snapshot`
    carrying the span summary and any monitor's findings, and a flight
    bundle.  The dump runs in a side thread bounded by
    ``flush_timeout`` seconds, so a wedged filesystem cannot turn the
    abort path into a second hang; whatever was written survives the
    ``os._exit``.
    """

    trigger = (1, "iteration")
    priority = 10_000  # heartbeat first, before any slow extension runs
    finalize_on_error = True  # the trainer disarms us when run() unwinds —
    # an armed watchdog would os._exit a process saving crash diagnostics

    def __init__(self, timeout: float = 600.0,
                 action: Optional[Callable[[float, float], None]] = None,
                 poll_interval: Optional[float] = None,
                 dump_dir: Optional[str] = None,
                 monitor=None, rank: Optional[int] = None,
                 flush_timeout: float = 10.0):
        if timeout <= 0:
            raise ValueError(f"timeout must be positive, got {timeout}")
        self.timeout = float(timeout)
        self.action = action or _default_abort
        self.poll_interval = poll_interval or max(self.timeout / 4, 0.05)
        self.dump_dir = dump_dir
        self.monitor = monitor
        self.rank = rank
        self.flush_timeout = float(flush_timeout)
        self._last = None
        self._trainer = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- extension surface --
    def initialize(self, trainer) -> None:
        # Armed only from the FIRST completed unit of work: the first
        # step can legitimately exceed any hang timeout (kernel builds),
        # so the clock must not start at initialize time.
        self._trainer = trainer
        self._last = None
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="chainermn-tpu-torch-watchdog", daemon=True)
        self._thread.start()

    def observe(self, trainer) -> None:
        self._trainer = trainer
        self._last = time.monotonic()

    def __call__(self, trainer) -> None:
        pass

    def finalize(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- the watcher --
    def _heartbeat(self) -> Optional[float]:
        """Most recent sign of life: our own observe stamp or the trainer's
        per-unit progress stamp, whichever is newer."""
        beats = [self._last]
        progress = getattr(self._trainer, "last_progress", None)
        if progress is not None:
            beats.append(progress)
        beats = [b for b in beats if b is not None]
        return max(beats) if beats else None

    def _dump_evidence(self, gap: float) -> None:
        """Write the stall evidence (trace flush + health snapshot) to
        disk — runs on a side thread, bounded by ``flush_timeout``."""
        import json

        from ..observability import export as _export
        from ..observability import trace as _trace

        out = self.dump_dir or getattr(self._trainer, "out", None)
        if out is None:
            print("[chainermn_tpu_torch watchdog] no dump_dir/trainer.out — "
                  "skipping evidence files", file=sys.stderr, flush=True)
            return
        os.makedirs(out, exist_ok=True)
        snap = _export.health_snapshot(self._trainer, monitor=self.monitor)
        snap["watchdog"] = {"gap_s": round(gap, 1),
                            "timeout_s": self.timeout,
                            "last_phase": getattr(self._trainer,
                                                  "last_phase", None)}
        health_path = os.path.join(out, "watchdog_health.json")
        if self.rank is not None:
            # rank-sharded like the trace: a gang stall fires every
            # rank's watchdog near-simultaneously into the SAME dump_dir,
            # and last-writer-wins would erase exactly the per-rank
            # attribution this dump exists for
            from ..observability.trace import shard_path
            health_path = shard_path(health_path, self.rank)
        tmp = f"{health_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=2, default=str)
        os.replace(tmp, health_path)
        wrote = [health_path]
        tr = _trace.get_tracer()
        if tr.enabled:
            trace_path = os.path.join(out, "watchdog_trace.json")
            tr.export_chrome_trace(trace_path, rank=self.rank)
            wrote.append(trace_path if self.rank is None else
                         "rank-sharded " + trace_path)
        # the full debug bundle (flight ring + providers + env)
        from ..observability import flight as _flight
        _flight.note("watchdog_abort", gap_s=round(gap, 1),
                     timeout_s=self.timeout,
                     last_phase=getattr(self._trainer, "last_phase", None))
        bundle = _flight.dump_bundle(
            out, "watchdog_abort", trainer=self._trainer,
            monitor=self.monitor, rank=self.rank,
            extra={"gap_s": round(gap, 1), "timeout_s": self.timeout})
        if bundle is not None:
            wrote.append(bundle)
        print(f"[chainermn_tpu_torch watchdog] stall evidence written: "
              f"{', '.join(wrote)}", file=sys.stderr, flush=True)

    def _flush_before_abort(self, gap: float) -> None:
        """Best-effort, time-bounded evidence dump; never raises — the
        abort must proceed even if the dump wedges or explodes."""
        def run():
            try:
                self._dump_evidence(gap)
            except Exception as e:
                print(f"[chainermn_tpu_torch watchdog] evidence dump failed: "
                      f"{e!r}", file=sys.stderr, flush=True)

        t = threading.Thread(target=run, name="chainermn-tpu-torch-watchdog-dump",
                             daemon=True)
        t.start()
        t.join(timeout=self.flush_timeout)
        if t.is_alive():
            print(f"[chainermn_tpu_torch watchdog] evidence dump still running "
                  f"after {self.flush_timeout:.0f}s — aborting anyway",
                  file=sys.stderr, flush=True)

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            last = self._heartbeat()
            if last is None:
                continue
            gap = time.monotonic() - last
            if gap > self.timeout:
                # Name the last COMPLETED unit of work so the stall
                # report says WHERE the job wedged (the stuck unit is
                # whatever comes after it), from the trainer's phase
                # stamps.
                phase = getattr(self._trainer, "last_phase", None)
                if phase is not None:
                    print(f"[chainermn_tpu_torch watchdog] last completed "
                          f"phase: {phase} at iteration "
                          f"{getattr(self._trainer, 'iteration', '?')}",
                          file=sys.stderr, flush=True)
                # Evidence first (bounded): the default action os._exits,
                # and the trace buffer lives only in memory.
                self._flush_before_abort(gap)
                self.action(gap, self.timeout)
                return

    # resume contract: a watchdog carries no durable state
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        self._last = time.monotonic() if self._thread is not None else None
