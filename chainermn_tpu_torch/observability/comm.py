"""Collective-communication accounting: the comm ledger.

Counterpart of ``chainermn_tpu/observability/comm.py``'s ledger: op name,
axis, payload bytes, wire dtype and host-side latency per booked call,
aggregated per ``op@axis`` row.  The Prometheus exporter
(``export.prometheus_text``) reads it, and the serving spill restore
books its slab bytes here (``kv_spill_restore@host``).

Every call in the port runs eagerly, so there is no trace-time booking
and no per-program replay: a booked call is an executed call.  The
wrappers that would book each collective (JAX's ``collective`` and
``accounted_method``) and the step capture come with ROADMAP.md's A12.
:meth:`CommAccountant.record` always books; its callers book only while
the tracer is enabled, as the reference's do.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from . import trace


class CommAccountant:
    """Ledger of collective calls: cumulative totals per ``op@axis``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, Dict[str, Any]] = {}

    def reset(self) -> None:
        with self._lock:
            self.totals = {}

    def record(self, op: str, axis, nbytes: int, dtype: str,
               latency_s: Optional[float] = None,
               noted: bool = False) -> None:
        """Book one call.  ``noted=True`` marks traffic no collective
        wrapper sees (a slab copied through host memory); its bytes also
        accumulate in the row's ``noted_bytes``."""
        axis_key = ("+".join(axis) if isinstance(axis, (tuple, list))
                    else str(axis))
        key = f"{op}@{axis_key}"
        with self._lock:
            row = self.totals.setdefault(
                key, {"calls": 0, "bytes": 0, "host_time_s": 0.0})
            row["calls"] += 1
            row["bytes"] += int(nbytes)
            if latency_s is not None:
                row["host_time_s"] += float(latency_s)
            if noted:
                row["noted_bytes"] = row.get("noted_bytes", 0) + int(nbytes)
            dts = row.setdefault("dtypes", [])
            if str(dtype) not in dts:
                dts.append(str(dtype))
        tr = trace.get_tracer()
        tr.add_counter(f"comm/{op}/bytes", nbytes)
        tr.add_counter(f"comm/{op}/calls", 1)
        from . import flight as _flight
        _flight.note("comm", op=op, axis=axis_key, bytes=int(nbytes),
                     dtype=str(dtype), in_jit=False)

    @staticmethod
    def _summarize(accum: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        def snap(v):
            out = dict(v)
            if "dtypes" in out:
                out["dtypes"] = list(out["dtypes"])
            return out

        return {
            "per_op": {k: snap(v) for k, v in accum.items()},
            "bytes": int(sum(v["bytes"] for v in accum.values())),
            "calls": int(sum(v["calls"] for v in accum.values())),
            "host_time_s": float(sum(v.get("host_time_s", 0.0)
                                     for v in accum.values())),
        }

    def report(self) -> Dict[str, Any]:
        """Cumulative per-op totals since construction or reset."""
        with self._lock:
            return self._summarize(self.totals)


_ACCOUNTANT = CommAccountant()


def get_accountant() -> CommAccountant:
    return _ACCOUNTANT
