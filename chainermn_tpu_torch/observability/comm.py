"""Collective-communication accounting: the comm ledger.

Counterpart of ``chainermn_tpu/observability/comm.py``: every collective of
the in-step face (``ops.collective``), the eager communicators
(``communicators/``) and the step builders' declared traffic reports here:
op name, axis, payload bytes, wire dtype and host-side latency, aggregated
per ``op@axis`` row.  The Prometheus exporter (``export.prometheus_text``),
the step breakdown (``metrics.StepBreakdownReport``), the anomaly
detectors and the health snapshot read it; the serving spill restore and
the KV transfer book their slab bytes here.

One call regime: every collective of the port runs eagerly, so a booked
call is an executed call.  JAX books a collective inside a jitted step
once, when it traces the program, and replays that profile on every
execution that hits the cache; here nothing is replayed.  On a step
without loops the two give the same per-step rows.  A collective inside
a loop that JAX traces once (a ``lax.scan`` over ring hops or pipeline
ticks) is booked here once per hop or tick, as it runs.  Every booked
call carries its host latency and a ``comm/<op>`` span.

:meth:`CommAccountant.step` brackets one training step;
``last_step_report`` then holds that step's rows.  The wrappers
(:func:`collective`, :func:`accounted_method`) and :func:`note` book only
while the tracer is enabled; with tracing off a wrapper costs one
attribute read (and global reads for the collective guard and the
recording bracket).

:func:`record_collectives` brackets a call and collects the ordered
``(op, axis)`` of every outermost collective it runs, tracing on or off:
the trace engine's collective sequence (``analysis/trace_engine.py``).
The shard-flow analyzer's dispatch-graph recorder
(``analysis/dispatch_graph.py``) opens a bracket of its own
(:func:`collective_bracket`) that makes each accounted call one node of
its graph.
The schedule-execution counters (:func:`record_schedule_exec`, the
``schedule_exec/*`` gauges of ``/metricsz``) and the active calibration
(the ``/statusz`` ``calibration`` provider) are copies of JAX's.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

import numpy as np

from . import trace
# stdlib-only at import time, so the guarded hot path stays one global
# read; _EAGER_DEPTH is the one nesting depth the guard and the ledger share
from ..health import _EAGER_DEPTH, _sync_if_cuda
from ..health import collective_guard as _collective_guard

#: Names of JAX's comm module that the port has not: none.
NOT_PORTED: Dict[str, str] = {}

#: The open recording bracket's hook, ``hook(op, axis, x, run,
#: wire_dtype, noted)``, or None (:func:`collective_bracket`).
_RECORDING: Optional[Callable] = None

def _dtype_name(dt) -> str:
    """``torch.bfloat16`` / ``np.dtype('float32')`` / ``"int8"`` →
    numpy's spelling; numpy has no ``bfloat16``, which stays as is."""
    name = str(dt).replace("torch.", "")
    return name if name == "bfloat16" else str(np.dtype(name))


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _leaves(tree):
    import torch

    from .._tree import leaves

    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    return leaves(tree)


def payload_info(tree) -> tuple:
    """``(nbytes, dtype_str, n_elements, in_jit)`` over a tree's leaves:
    the ledger's byte convention, one logical payload per call, shape ×
    itemsize, independent of the group's size.  Leaves are tensors, numpy
    arrays or Python scalars (fp32, as JAX counts them); a module counts
    its parameters and buffers.  ``dtype_str`` is the first leaf's, in
    numpy's spelling (``bfloat16`` for bf16); ``in_jit`` is always False
    (the port has no trace time)."""
    nbytes = 0
    n_elems = 0
    dtype = None
    for leaf in _leaves(tree):
        dt = getattr(leaf, "dtype", None)
        name = _dtype_name(dt) if dt is not None else "float32"
        shape = getattr(leaf, "shape", ())
        n = 1
        for s in shape:
            n *= int(s)
        n_elems += n
        nbytes += n * _itemsize(name)
        dtype = dtype or name
    return nbytes, dtype or "float32", n_elems, False


def _axis_key(axis) -> Any:
    """A mesh books under its axis name, as JAX books ``axis_name`` (a
    tuple of axes, each)."""
    if isinstance(axis, (tuple, list)):
        return tuple(_axis_key(a) for a in axis)
    name = getattr(axis, "axis_name", None)
    return name if name is not None else axis


def _new_row() -> Dict[str, Any]:
    return {"calls": 0, "bytes": 0, "host_time_s": 0.0}


class CommAccountant:
    """Ledger of collective calls: cumulative totals per ``op@axis`` and a
    per-step report."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, Dict[str, Any]] = {}
        self._step_accum: Optional[Dict[str, Dict[str, Any]]] = None
        self.last_step_report: Optional[Dict[str, Any]] = None

    def reset(self) -> None:
        with self._lock:
            self.totals = {}
            self._step_accum = None
            self.last_step_report = None

    # ---- recording ----
    def record(self, op: str, axis, nbytes: int, dtype: str,
               in_jit: bool = False, latency_s: Optional[float] = None,
               noted: bool = False) -> None:
        """Book one call.  ``noted=True`` marks DECLARED traffic (booked by
        :func:`note` or a step builder: the gradient mean that JAX's
        autodiff inserts, a slab copied through host memory); its bytes
        also accumulate in the row's ``noted_bytes``.  ``in_jit`` is
        accepted for the reference's signature; every call here is eager.
        The step report's rows carry no ``dtypes`` (JAX's do not)."""
        axis = _axis_key(axis)
        axis_key = ("+".join(axis) if isinstance(axis, (tuple, list))
                    else str(axis))
        key = f"{op}@{axis_key}"
        dtype = str(dtype)
        with self._lock:
            rows = [self.totals.setdefault(key, _new_row())]
            if self._step_accum is not None:
                rows.append(self._step_accum.setdefault(key, _new_row()))
            for row in rows:
                row["calls"] += 1
                row["bytes"] += int(nbytes)
                if latency_s is not None:
                    row["host_time_s"] += float(latency_s)
                if noted:
                    row["noted_bytes"] = (row.get("noted_bytes", 0)
                                          + int(nbytes))
            dts = rows[0].setdefault("dtypes", [])
            if dtype not in dts:
                dts.append(dtype)
        tr = trace.get_tracer()
        tr.add_counter(f"comm/{op}/bytes", nbytes)
        tr.add_counter(f"comm/{op}/calls", 1)
        from . import flight as _flight
        _flight.note("comm", op=op, axis=axis_key, bytes=int(nbytes),
                     dtype=dtype, in_jit=False)

    # ---- per-step capture ----
    @contextmanager
    def step(self, program_key: Any = "step"):
        """Bracket one training step: the collectives booked inside are
        the step's, and ``last_step_report`` holds their rows afterwards.
        ``program_key`` names the step (JAX keys its replayed profile by
        it; every call here is booked as it runs).  With tracing disabled
        the bracket books nothing and clears ``last_step_report``, so a
        reader does not republish a frozen step."""
        if not trace.get_tracer().enabled:
            with self._lock:
                self.last_step_report = None
            yield None
            return
        with self._lock:
            self._step_accum = {}
        try:
            yield self
        finally:
            with self._lock:
                accum = self._step_accum or {}
                self._step_accum = None
                self.last_step_report = self._summarize(accum)

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


def note(op: str, axis, tree) -> None:
    """Book a collective no wrapper sees, at ``tree``'s size (``noted``).
    JAX notes the gradient psum its autodiff inserts; the step builders of
    the port book the gradient mean they run in its place the same way
    (:func:`collective` with ``noted=True``)."""
    if not trace.get_tracer().enabled:
        return
    nbytes, dtype, _, _ = payload_info(tree)
    _ACCOUNTANT.record(op, axis, nbytes, dtype, noted=True)


def _guarded_call(op, thunk):
    """``thunk()`` under the installed collective guard (outermost call
    only).  A CUDA result synchronises the stream inside the bracket, so
    the guard bounds the collective's completion, not its launch."""
    guard = _collective_guard()
    if guard is None or getattr(_EAGER_DEPTH, "d", 0):
        return thunk()
    tok = guard.enter(op)
    _EAGER_DEPTH.d = 1
    try:
        out = thunk()
        _sync_if_cuda(out)
        return out
    finally:
        _EAGER_DEPTH.d = 0
        guard.exit(tok)


def collective(op: str, axis, x, thunk, wire_dtype=None, noted=False):
    """Run ``thunk()`` (the collective itself) under accounting: bytes and
    dtype from ``x``'s leaves, host latency, a ``comm/<op>`` span.
    ``wire_dtype`` books the call at the wire's item size (the int8
    ring: one byte an element whatever ``x``'s dtype).  ``noted=True``
    also counts the bytes as ``noted_bytes`` (declared traffic, as
    :func:`note` books it).  ``axis`` is an axis name, a tuple of them
    or a :class:`~chainermn_tpu_torch.topology.Mesh` (booked under its
    axis name).

    The installed :class:`~chainermn_tpu_torch.health.CollectiveGuard`
    brackets the outermost call, with tracing on or off: a call that
    outlives the guard's window aborts naming the lost rank(s).  Only the
    OUTERMOST call books: a collective made of other collectives
    (``shift`` → ``ppermute``, the int8 ring's gather,
    ``multi_node_mean_grad`` → ``allreduce``) is one call under its own
    name, as in JAX."""
    hook = _RECORDING
    if hook is not None:
        # an open recording bracket sees every call, nested ones too, and
        # runs it as usual through ``run``
        return hook(op, axis, x, lambda: _collective(
            op, axis, x, thunk, wire_dtype, noted), wire_dtype, noted)
    return _collective(op, axis, x, thunk, wire_dtype, noted)


def _collective(op, axis, x, thunk, wire_dtype, noted):
    tr = trace.get_tracer()
    if not tr.enabled:
        return _guarded_call(op, thunk)
    if getattr(_EAGER_DEPTH, "d", 0):
        return thunk()
    nbytes, dtype, n_elems, _ = payload_info(x)
    if wire_dtype is not None:
        dtype = _dtype_name(wire_dtype)
        nbytes = n_elems * _itemsize(dtype)
    axis = _axis_key(axis)
    guard = _collective_guard()
    tok = guard.enter(op) if guard is not None else None
    _EAGER_DEPTH.d = 1
    t0 = time.perf_counter()
    try:
        with tr.span(f"comm/{op}", cat="comm", axis=str(axis), bytes=nbytes):
            out = thunk()
            if tok is not None:
                _sync_if_cuda(out)
    finally:
        _EAGER_DEPTH.d = 0
        if tok is not None:
            guard.exit(tok)
    _ACCOUNTANT.record(op, axis, nbytes, dtype,
                       latency_s=time.perf_counter() - t0, noted=noted)
    return out


def accounted_method(op: str):
    """Decorator for the eager communicator collectives (``allreduce`` and
    the rest of ``communicators.base._ACCOUNTED_OPS``): a booked call of
    the payload that ``self._ledger_payload(op, x)`` names (by default
    ``x`` itself, the rank-major stack as JAX books it), host latency, a
    ``comm/<op>`` span, and the collective guard.  Applied to every
    backend by ``CommunicatorBase.__init_subclass__``.

    Only the OUTERMOST call books and enters the guard: an override
    delegating to ``super().allreduce(...)`` (both levels wrapped) books
    one call, and a helper made of other collectives
    (``multi_node_mean_grad`` → ``allreduce``) books under its own name."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, x, *args, **kwargs):
            payload = x
            if trace.get_tracer().enabled \
                    and hasattr(self, "_ledger_payload"):
                payload = self._ledger_payload(op, x)
            return collective(
                op, getattr(self, "axis_name", "world"), payload,
                lambda: fn(self, x, *args, **kwargs))
        wrapper._obs_wrapped = True
        return wrapper
    return deco


#: Back-compat alias (the helper predates its public face).
_payload_info = payload_info


@contextmanager
def collective_bracket(hook: Callable, what: str = "collective"):
    """Route every call of :func:`collective` made inside the bracket,
    nested ones too, through ``hook(op, axis, x, run, wire_dtype,
    noted)``, which runs the call with ``run()``.  Brackets do not nest;
    the hook is process-global (the analyzers run one entry at a time)."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError(f"{what} brackets do not nest")
    _RECORDING = hook
    try:
        yield
    finally:
        _RECORDING = None


@contextmanager
def record_collectives():
    """Collect the ordered ``(op, axis)`` of every outermost collective
    run inside the bracket (a list, filled as the calls run), tracing on
    or off: the collectives the ledger books when tracing is on, in
    order.  Brackets do not nest."""
    seq: list = []

    def hook(op, axis, x, run, wire_dtype, noted):
        if getattr(_EAGER_DEPTH, "r", 0):
            return run()
        seq.append((op, _axis_key(axis)))
        _EAGER_DEPTH.r = 1
        try:
            return run()
        finally:
            _EAGER_DEPTH.r = 0

    with collective_bracket(hook, "record_collectives"):
        yield seq


# --------------------------------------------------------------------------
# schedule-execution counters + the /statusz calibration provider
# --------------------------------------------------------------------------

_SCHED_LOCK = threading.Lock()
_SCHED_EXEC: Dict[str, float] = {}
_ACTIVE_CALIBRATION: Optional[Dict[str, Any]] = None
_CAL_PROVIDER_REGISTERED = False


def _register_calibration_provider() -> None:
    global _CAL_PROVIDER_REGISTERED
    if _CAL_PROVIDER_REGISTERED:
        return
    from . import flight as _flight
    _flight.register_provider("calibration", calibration_snapshot)
    _CAL_PROVIDER_REGISTERED = True


def record_schedule_exec(records) -> None:
    """Book one profiled schedule execution's records into the
    ``schedule_exec/*`` counters (/metricsz face) and tracer counters
    (Chrome trace face).  Called by ``reshard._emit_schedule_exec``;
    first booking registers the /statusz ``calibration`` provider."""
    if not records:
        return
    with _SCHED_LOCK:
        for r in records:
            link = r.get("link", "?")
            _SCHED_EXEC[f"schedule_exec/{link}/ops"] = \
                _SCHED_EXEC.get(f"schedule_exec/{link}/ops", 0.0) + 1
            _SCHED_EXEC[f"schedule_exec/{link}/bytes"] = \
                _SCHED_EXEC.get(f"schedule_exec/{link}/bytes", 0.0) \
                + float(r.get("bytes", 0))
            _SCHED_EXEC[f"schedule_exec/{link}/wall_us"] = \
                _SCHED_EXEC.get(f"schedule_exec/{link}/wall_us", 0.0) \
                + float(r.get("wall_us", 0.0))
        _SCHED_EXEC["schedule_exec/records"] = \
            _SCHED_EXEC.get("schedule_exec/records", 0.0) + len(records)
        _SCHED_EXEC["schedule_exec/executions"] = \
            _SCHED_EXEC.get("schedule_exec/executions", 0.0) + 1
    tr = trace.get_tracer()
    if tr.enabled:
        tr.add_counter("schedule_exec/records", float(len(records)))
    _register_calibration_provider()


def schedule_exec_gauges() -> Dict[str, float]:
    """Snapshot of the ``schedule_exec/*`` counters (merged into
    /metricsz the same way the flight drop counts are)."""
    with _SCHED_LOCK:
        return dict(_SCHED_EXEC)


def set_active_calibration(cal: Optional[Dict[str, Any]]) -> None:
    """Install (or clear) the calibration artifact the process is
    currently pricing schedules with; surfaces via the /statusz
    ``calibration`` provider."""
    global _ACTIVE_CALIBRATION
    with _SCHED_LOCK:
        _ACTIVE_CALIBRATION = cal
    if cal is not None:
        _register_calibration_provider()


def calibration_snapshot() -> Dict[str, Any]:
    """The /statusz ``calibration`` provider: live counters plus the
    active artifact's fitted constants (if one is installed)."""
    with _SCHED_LOCK:
        counters = dict(_SCHED_EXEC)
        cal = _ACTIVE_CALIBRATION
    out: Dict[str, Any] = {"counters": counters}
    if cal is None:
        out["calibration"] = None
    else:
        out["calibration"] = {
            "schema": cal.get("schema"),
            "n_records": cal.get("n_records"),
            "links": cal.get("links"),
        }
    return out


def reset_schedule_exec() -> None:
    """Test hook: clear counters and the active calibration."""
    global _ACTIVE_CALIBRATION
    with _SCHED_LOCK:
        _SCHED_EXEC.clear()
        _ACTIVE_CALIBRATION = None
