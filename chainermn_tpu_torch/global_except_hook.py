"""Global exception hook: one rank's crash kills the whole job, loudly.

Counterpart of ``chainermn_tpu/global_except_hook.py`` (reference:
``chainermn/global_except_hook.py``, which prints the traceback and
calls ``MPI_Abort`` so an uncaught exception on any rank aborts the gang
instead of leaving the other ranks deadlocked inside a collective).

Here a process that exits non-zero is noticed by its peers through the
process group: their next collective fails (gloo) or times out (NCCL).
The hook dumps a flight bundle, prints a rank-prefixed traceback, tears
the process group down from a bounded side thread (where JAX shuts its
distributed runtime down), then hard-exits 1, so a peer wedged in the
collective the crash abandoned can never turn the loud abort into a
hang.  In a one-process job it passes the exception to the stock hook.
"""

from __future__ import annotations

import os
import sys
import traceback

_installed = False
_orig_hook = None


def _flight_dump(exc_type, exc_value) -> None:
    """Best-effort debug bundle before the process dies.  Bounded side
    thread: the bundle writes files, and a wedged filesystem must not
    turn the loud abort into a hang."""
    import threading

    def run():
        try:
            from .observability import flight
            flight.dump_on_crash(exc_type, exc_value)
        except Exception:
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=10.0)


def _world() -> tuple:
    """``(rank, size)`` of the default process group, ``(0, 1)`` without
    one."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return 0, 1


def _global_except_hook(exc_type, exc_value, tb) -> None:
    _flight_dump(exc_type, exc_value)
    rank, nproc = _world()
    if nproc <= 1:
        (_orig_hook or sys.__excepthook__)(exc_type, exc_value, tb)
        return
    sys.stderr.write(
        f"[chainermn_tpu_torch] uncaught exception on process "
        f"{rank}/{nproc} — aborting the whole job (reference analog: "
        "MPI_Abort):\n")
    sys.stderr.write("".join(traceback.format_exception(exc_type, exc_value,
                                                        tb)))
    sys.stderr.flush()
    from .topology import abort_process_group
    abort_process_group(timeout_s=5.0)
    os._exit(1)


def add_hook() -> None:
    """Install the hook (idempotent).  The reference installed it at
    ``import chainermn``; here it is an explicit call, so importing the
    package never changes interpreter state."""
    global _installed, _orig_hook
    if _installed:
        return
    _orig_hook = sys.excepthook
    sys.excepthook = _global_except_hook
    _installed = True


def remove_hook() -> None:
    global _installed
    if _installed:
        sys.excepthook = _orig_hook or sys.__excepthook__
        _installed = False
