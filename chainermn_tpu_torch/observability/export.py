"""The health snapshot every debug bundle and watchdog dump carries.

Counterpart of ``chainermn_tpu/observability/export.py ::
health_snapshot``.  The JAX snapshot also reports the comm ledger
(``comm``) and the last step's collectives (``last_step_comm``); the
ledger is ROADMAP.md's A12, so here both keys are present and ``null``.
The metrics stream (``MetricsWriter``, ``MetricsReport``) is A12 too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from . import trace

#: The JAX package's schema stamp of its metrics records.
SCHEMA = "chainermn_tpu.metrics.v1"


def health_snapshot(trainer=None, monitor=None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """One dict answering "what was this process doing": tracer summary,
    counters and gauges, the trainer's position, anomaly findings.
    Everything host-side; safe to call from the Watchdog's abort path."""
    tr = trace.get_tracer()
    snap: Dict[str, Any] = {
        "schema": SCHEMA,
        "kind": "health_snapshot",
        "t": round(time.time(), 3),
        "tracing_enabled": tr.enabled,
        "spans": tr.summary()["spans"],
        "counters": tr.counters(),
        "gauges": tr.gauges(),
        "comm": None,
        "last_step_comm": None,
    }
    if trainer is not None:
        snap["iteration"] = getattr(trainer, "iteration", None)
        snap["last_phase"] = getattr(trainer, "last_phase", None)
        snap["elapsed_time"] = getattr(trainer, "elapsed_time", None)
    if monitor is not None and hasattr(monitor, "health"):
        snap["anomalies"] = monitor.health()
    if extra:
        snap.update(extra)
    return snap
