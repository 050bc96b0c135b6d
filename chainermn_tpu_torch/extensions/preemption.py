"""Bounded-grace preemption handling: SIGTERM → checkpoint, bundle, exit 0.

Counterpart of ``chainermn_tpu/extensions/preemption.py``.  Cloud
schedulers (node drains, maintenance events, spot reclamation) deliver
SIGTERM with a grace window and then SIGKILL.  The
flight recorder's stock SIGTERM path (``observability.flight
.install_signal_handlers``) dumps a debug bundle and dies with the
default disposition — correct for a crash investigation, wrong for a
preemption: the job loses every step since the last periodic checkpoint
and the exit code reads as a failure.

:class:`PreemptionHandler` upgrades that path into the elastic story:

1. The signal handler only sets a flag and stamps a deadline — all real
   work happens at the next step boundary, on the main thread, where
   trainer state is consistent.
2. The train loop (via the extension ``observe`` hook, or an explicit
   :meth:`check` in hand-rolled loops) notices the flag, saves one final
   checkpoint generation through the v2 manifest path (so a restart on a
   DIFFERENT world size reshards and resumes exactly), books the save
   overhead into the goodput ledger's ``checkpoint`` bucket when one is
   given (``observability.slo.GoodputLedger``), dumps a
   ``preempt`` flight bundle recording the grace budget used and the
   generation saved, and exits 0 — a preempted job is a SUCCESS to the
   scheduler, which is what makes it reschedule instead of backoff.
3. A grace watchdog thread guarantees BOUNDED death: if the step never
   reaches a boundary (wedged collective, a long kernel build), the
   deadline fires a bundle explaining why nothing was saved and still
   exits 0.

The bundle records the reason ``preempt``, the grace used, the
generation saved (or why not), and the elastic resume hint.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Optional

from ..observability import flight as _flight


class PreemptionExit(SystemExit):
    """Graceful preemption exit (code 0).  A ``SystemExit`` subclass so
    the Trainer's exception path disarms liveness monitors
    (``finalize_on_error``) WITHOUT running full finalize — the
    checkpointer must keep the shards a resume needs."""

    def __init__(self, generation: Optional[int] = None):
        self.generation = generation
        super().__init__(0)


class PreemptionHandler:
    """Trainer extension + signal handler for bounded-grace preemption.

    Parameters
    ----------
    checkpointer:
        A :class:`~.checkpoint.MultiNodeCheckpointer` (or the replica-set
        wrapper) used for the final save.  ``None`` still gives bounded
        exit-0 + bundle, just without a saved generation.
    grace_s:
        The scheduler's grace window.  The final save must complete (and
        the loop must reach a step boundary) inside it; past the
        deadline the watchdog thread dumps and exits regardless.
    dump_dir:
        Where the ``preempt`` bundle lands (default: the flight
        recorder's configured crash dump dir).
    ledger:
        Optional goodput ledger (anything with ``add(bucket, seconds)``);
        the final save's wall time books into its ``checkpoint`` bucket.
    signals:
        Which signals mean "preempt" (default SIGTERM only; SIGUSR1
        stays the flight recorder's dump-and-continue probe).
    exit_fn:
        Test seam for the hard deadline exit (default ``os._exit``).
    """

    trigger = (1, "iteration")
    priority = 9_500  # right after the Watchdog heartbeat, before any
    #                   slow extension delays the final save
    finalize_on_error = True

    def __init__(self, checkpointer=None, grace_s: float = 30.0,
                 dump_dir: Optional[str] = None,
                 ledger=None, rank: Optional[int] = None,
                 signals=(signal.SIGTERM,),
                 exit_fn: Callable[[int], None] = os._exit):
        if grace_s <= 0:
            raise ValueError(f"grace_s must be positive, got {grace_s}")
        self.checkpointer = checkpointer
        self.grace_s = float(grace_s)
        self.dump_dir = dump_dir
        self.ledger = ledger
        self.rank = rank
        self.signals = tuple(signals)
        self._exit = exit_fn
        self.requested = False
        self.completed = False
        self._signal_name: Optional[str] = None
        self._t_signal: Optional[float] = None
        self._deadline_thread: Optional[threading.Thread] = None
        self._prev_handlers = {}
        self._trainer = None
        self._installed = False

    # ---- installation ----
    def install(self) -> None:
        """Register the signal handlers (idempotent; main thread only —
        CPython restriction).  Installed AFTER the flight recorder's
        handlers, this takes over SIGTERM while leaving SIGUSR1 to the
        dump-and-continue probe."""
        if self._installed:
            return
        for sig in self.signals:
            self._prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, self._on_signal)
        self._installed = True

    def uninstall(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}
        self._installed = False

    # ---- the signal path: flag + deadline, nothing else ----
    def _on_signal(self, signum, frame) -> None:
        if self.requested:
            return  # a second SIGTERM changes nothing; the deadline holds
        self.requested = True
        self._t_signal = time.monotonic()
        self._signal_name = signal.Signals(signum).name
        _flight.note("preempt_requested", signal=self._signal_name,
                     grace_s=self.grace_s)
        print(f"[chainermn_tpu_torch preempt] {self._signal_name} received — "
              f"final checkpoint at the next step boundary "
              f"(grace {self.grace_s:.1f}s)", file=sys.stderr, flush=True)
        t = threading.Thread(target=self._deadline_watch, daemon=True,
                             name="chainermn-tpu-torch-preempt-deadline")
        t.start()
        self._deadline_thread = t

    def _deadline_watch(self) -> None:
        """The bound: past the grace window, dump-and-exit 0 even if the
        loop never reached a step boundary (a wedged collective must not
        turn a preemption into a SIGKILL with no evidence)."""
        deadline = (self._t_signal or time.monotonic()) + self.grace_s
        while not self.completed:
            now = time.monotonic()
            if now >= deadline:
                self._dump(saved_generation=None,
                           why_not_saved="grace budget exhausted before "
                                         "a step boundary was reached",
                           grace_used_s=now - (self._t_signal or now))
                print("[chainermn_tpu_torch preempt] grace exhausted — exiting 0 "
                      "without a final save (older generations remain)",
                      file=sys.stderr, flush=True)
                self._exit(0)
                return  # test exit_fn seams return instead of dying
            time.sleep(min(0.05, deadline - now))

    # ---- the step-boundary path ----
    def observe(self, trainer) -> None:
        self._trainer = trainer
        if self.requested and not self.completed:
            self.finish(trainer.checkpoint_state(), trainer.iteration,
                        trainer=trainer)

    def check(self, state: Any, iteration: int) -> None:
        """Hand-rolled-loop face: call once per iteration with the state
        a resume needs; no-op until a preemption signal arrived."""
        if self.requested and not self.completed:
            self.finish(state, iteration)

    def finish(self, state: Any, iteration: int, trainer=None) -> None:
        """Save, book, dump, exit 0.  Raises :class:`PreemptionExit`."""
        t0 = time.monotonic()
        saved: Optional[int] = None
        why: Optional[str] = None
        try:
            if self.checkpointer is not None:
                self.checkpointer.save(state, iteration)
                self.checkpointer.flush()
                saved = iteration
            else:
                why = "no checkpointer configured"
        except Exception as e:  # noqa: BLE001 — the exit must stay 0
            why = f"final checkpoint save failed: {e!r}"
            print(f"[chainermn_tpu_torch preempt] {why}", file=sys.stderr,
                  flush=True)
        save_s = time.monotonic() - t0
        if self.ledger is not None:
            self.ledger.add("checkpoint", save_s)
        grace_used = time.monotonic() - (self._t_signal or t0)
        _flight.note("preempt", signal=self._signal_name,
                     generation=saved, saved=saved is not None,
                     save_s=round(save_s, 4),
                     grace_used_s=round(grace_used, 4),
                     grace_budget_s=self.grace_s)
        self._dump(saved_generation=saved, why_not_saved=why,
                   grace_used_s=grace_used, save_s=save_s,
                   trainer=trainer)
        self.completed = True
        print(f"[chainermn_tpu_torch preempt] exiting 0 "
              f"(generation={'none' if saved is None else saved}, "
              f"grace used {grace_used:.2f}s of {self.grace_s:.1f}s)",
              file=sys.stderr, flush=True)
        raise PreemptionExit(saved)

    def _dump(self, saved_generation, why_not_saved, grace_used_s,
              save_s: Optional[float] = None, trainer=None) -> None:
        out = self.dump_dir or _flight.crash_dump_dir()
        if not out:
            return
        world = 1
        ckpt_dir = None
        if self.checkpointer is not None:
            ckpt_dir = getattr(self.checkpointer, "path", None)
            try:
                world = self.checkpointer._nproc
            except Exception:
                pass
        extra = {"preempt": {
            "signal": self._signal_name,
            "grace_budget_s": self.grace_s,
            "grace_used_s": round(float(grace_used_s), 4),
            "save_s": None if save_s is None else round(save_s, 4),
            "generation_saved": saved_generation,
            "why_not_saved": why_not_saved,
            "world_size": world,
            "checkpoint_dir": ckpt_dir,
            # the elastic contract: any world size whose shards divide
            # evenly can resume via the v2 manifest (reshard_host)
            "resume_hint": (
                "restart with ANY process count; maybe_load reshards "
                f"the manifest generation (saved at world={world}) "
                "host-side (elastic resume)"),
        }}
        _flight.dump_bundle(out, "preempt", trainer=trainer,
                            rank=self.rank, extra=extra)

    # ---- extension plumbing ----
    def initialize(self, trainer) -> None:
        self._trainer = trainer
        self.install()

    def __call__(self, trainer) -> None:
        pass

    def finalize(self) -> None:
        self.uninstall()

    def state_dict(self) -> dict:
        return {}  # preemption state never survives a restart

    def load_state_dict(self, state: dict) -> None:
        pass
