"""Low-overhead span tracer with Chrome-trace / Perfetto JSON export.

A copy of ``chainermn_tpu/observability/trace.py`` (stdlib only): nested
spans, counters, gauges and instants recorded host-side with microsecond
stamps, exported in the Chrome Trace Event format that
``chrome://tracing`` and ``ui.perfetto.dev`` load.  ``span()`` with
tracing off returns one shared no-op context manager, so the call sites
stay in the hot path; each thread keeps its own span stack.

``export_chrome_trace(path, rank=r)`` writes rank ``r``'s shard
(``trace.json`` → ``trace.rank00003.json``, every event's ``pid`` the
rank); ``observability.aggregate.merge_trace_shards`` merges the shards
into one trace, one lane a rank.

Usage::

    from chainermn_tpu_torch.observability import trace
    trace.enable()
    with trace.span("step", iteration=3):
        with trace.span("step/data", cat="phase"):
            ...
    trace.export_chrome_trace("trace.json")
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing context manager — the disabled-tracer fast path.

    A singleton so ``span()`` with tracing off allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Records one Chrome ``X`` (complete) event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._tracer._stack().append(self.name)
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr._now_us()
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self._t0, "dur": max(t1 - self._t0, 0),
              "pid": tr._pid, "tid": tr._tid()}
        if self.args:
            ev["args"] = self.args
        tr._commit(ev)
        return False


class Tracer:
    """Process-wide event recorder (use the module-level singleton via
    :func:`get_tracer`; independent instances are for tests)."""

    #: Hard cap on buffered events (spans + counters).  At the cap the
    #: tracer stops appending EVENTS (counter/gauge TOTALS stay exact)
    #: and counts drops; the export marks the truncation.  ~200-400 B
    #: per event keeps worst-case buffer memory in the low hundreds of
    #: MB — multi-hour runs with tracing left on degrade gracefully
    #: instead of eating the host.
    DEFAULT_MAX_EVENTS = 1_000_000

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self.enabled = False
        self.max_events = int(max_events)
        self._dropped = 0
        self._events: List[Dict[str, Any]] = []
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}
        self._pid = os.getpid()
        self._epoch_ns = time.perf_counter_ns()
        # Event sinks (the flight-recorder tee): called with every
        # appended event dict, OUTSIDE the buffer lock.  A sink must be
        # cheap and must never call back into the tracer.
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []

    # ---- lifecycle ----
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
            self._counters = {}
            self._gauges = {}
            self._epoch_ns = time.perf_counter_ns()

    # ---- internals ----
    def _now_us(self) -> int:
        return (time.perf_counter_ns() - self._epoch_ns) // 1000

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _append(self, ev: Dict[str, Any]) -> None:
        # holds-lock: _lock  (callers serialize; the concurrency lint
        # verifies every intra-class call site against this contract)
        if len(self._events) >= self.max_events:
            self._dropped += 1
            return
        self._events.append(ev)

    def _commit(self, ev: Dict[str, Any]) -> None:
        """Buffer ``ev`` (under the lock), then fan it out to any
        registered sinks (outside the lock — a sink taking its own lock
        must never nest inside ours)."""
        with self._lock:
            self._append(ev)
        for sink in self._sinks:
            try:
                sink(ev)
            except Exception:
                pass  # a broken tee must never break tracing itself

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        """Register an event tee (e.g. the flight recorder); idempotent
        per callable."""
        if sink not in self._sinks:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    def now_us(self) -> int:
        """Public face of the tracer clock (µs since this tracer's
        epoch) — for callers recording retrospective spans via
        :meth:`complete_event`."""
        return self._now_us()

    # ---- recording surface ----
    def span(self, name: str, cat: str = "span", **args):
        """Context manager timing a nested span; no-op singleton when
        disabled (zero allocation on the hot path)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def traced(self, name: Optional[str] = None, cat: str = "span"):
        """Decorator face of :meth:`span`."""
        import functools

        def wrap(fn: Callable) -> Callable:
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*a, **kw):
                if not self.enabled:
                    return fn(*a, **kw)
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return inner
        return wrap

    def current_span(self) -> Optional[str]:
        """Innermost open span NAME on this thread (the thread-local
        context), or None outside any span."""
        stack = self._stack()
        return stack[-1] if stack else None

    def add_counter(self, name: str, value: float = 1.0) -> float:
        """Accumulate a monotonic counter; emits a Chrome ``C`` event
        carrying the running total.  Returns the new total."""
        if not self.enabled:
            return 0.0
        with self._lock:
            total = self._counters.get(name, 0.0) + value
            self._counters[name] = total
            self._append({
                "name": name, "ph": "C", "ts": self._now_us(),
                "pid": self._pid, "tid": 0,
                "args": {name.rsplit("/", 1)[-1]: total}})
        # counters are too hot for the tee: flight consumers read the
        # comm ledger's deltas instead (observability.comm tees those)
        return total

    def set_gauge(self, name: str, value: float) -> None:
        """Instantaneous value (throughput, MFU); emits a ``C`` event."""
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)
            self._append({
                "name": name, "ph": "C", "ts": self._now_us(),
                "pid": self._pid, "tid": 0,
                "args": {name.rsplit("/", 1)[-1]: float(value)}})

    def instant(self, name: str, cat: str = "instant", **args) -> None:
        """Point-in-time marker (Chrome ``i`` event)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._now_us(), "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._commit(ev)

    def complete_event(self, name: str, t0_us: int, dur_us: int,
                       cat: str = "span", **args) -> None:
        """Record a RETROSPECTIVE span from explicit tracer-clock stamps
        (see :meth:`now_us`) — e.g. a request's queue-wait, whose start
        was observed before anyone knew whether it would be admitted."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "ts": int(t0_us),
              "dur": max(int(dur_us), 0), "pid": self._pid,
              "tid": self._tid()}
        if args:
            ev["args"] = args
        self._commit(ev)

    def async_event(self, ph: str, name: str, async_id, cat: str = "flow",
                    ts_us: Optional[int] = None, **args) -> None:
        """Chrome ASYNC event (``ph`` in ``b``/``n``/``e``): all events
        sharing ``(cat, id)`` render as one flow track in Perfetto —
        the per-request lane keyed by trace id.  ``ts_us`` overrides the
        stamp for retrospective emission."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": ph, "id": str(async_id),
              "ts": self._now_us() if ts_us is None else int(ts_us),
              "pid": self._pid, "tid": self._tid()}
        if ph == "n":
            ev["s"] = "t"
        if args:
            ev["args"] = args
        self._commit(ev)

    # ---- read-out ----
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def summary(self) -> Dict[str, Any]:
        """Aggregate view: per-span-name {count, total_ms} + counters."""
        spans: Dict[str, Dict[str, float]] = {}
        for ev in self.events():
            if ev.get("ph") != "X":
                continue
            s = spans.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
            s["count"] += 1
            s["total_ms"] += ev["dur"] / 1e3
        for s in spans.values():
            s["total_ms"] = round(s["total_ms"], 3)
        return {"spans": spans, "counters": self.counters(),
                "gauges": self.gauges(), "dropped_events": self._dropped}

    def export_chrome_trace(self, path: str,
                            rank: Optional[int] = None) -> Dict[str, Any]:
        """Write the Chrome Trace Event JSON (loadable in Perfetto /
        ``chrome://tracing``); returns the document.

        ``rank`` switches on the **rank-sharded mode** for multi-process
        jobs: the file goes to :func:`shard_path` (``trace.json`` →
        ``trace.rank00003.json``), every event's ``pid`` is rewritten to
        the rank (one Perfetto lane per rank once merged), the process
        lane is named ``rank N``, and the document carries a
        ``metadata.rank`` stamp for the merge.  Each shard is itself a
        valid standalone trace.
        """
        pid = self._pid if rank is None else int(rank)
        pname = "chainermn_tpu_torch" if rank is None else f"rank {int(rank)}"
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "tid": 0, "args": {"name": pname}}]
        with self._lock:
            for ident, tid in sorted(self._tids.items(),
                                     key=lambda kv: kv[1]):
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid,
                             "args": {"name": f"thread-{tid}"
                                      if tid else "main"}})
            events = meta + (
                list(self._events) if rank is None
                else [dict(ev, pid=pid) for ev in self._events])
            if self._dropped:
                events.append({
                    "name": "trace/truncated", "cat": "tracer", "ph": "i",
                    "s": "g", "ts": self._now_us(), "pid": pid,
                    "tid": 0,
                    "args": {"dropped_events": self._dropped,
                             "max_events": self.max_events}})
            doc = {"traceEvents": events, "displayTimeUnit": "ms"}
            if rank is not None:
                doc["metadata"] = {"rank": int(rank),
                                   "host_pid": self._pid}
        if rank is not None:
            path = shard_path(path, rank)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)  # partial runs never leave a truncated file
        return doc


def shard_path(path: str, rank: int) -> str:
    """``trace.json`` → ``trace.rank00002.json`` (stable, sortable)."""
    base, ext = os.path.splitext(path)
    return f"{base}.rank{int(rank):05d}{ext or '.json'}"


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


# ---- module-level conveniences over the global tracer ----
def enable() -> None:
    _GLOBAL.enable()


def disable() -> None:
    _GLOBAL.disable()


def enabled() -> bool:
    return _GLOBAL.enabled


def reset() -> None:
    _GLOBAL.reset()


def span(name: str, cat: str = "span", **args):
    return _GLOBAL.span(name, cat=cat, **args)


def traced(name: Optional[str] = None, cat: str = "span"):
    return _GLOBAL.traced(name, cat=cat)


def instant(name: str, cat: str = "instant", **args) -> None:
    _GLOBAL.instant(name, cat=cat, **args)


def complete_event(name: str, t0_us: int, dur_us: int,
                   cat: str = "span", **args) -> None:
    _GLOBAL.complete_event(name, t0_us, dur_us, cat=cat, **args)


def async_event(ph: str, name: str, async_id, cat: str = "flow",
                ts_us: Optional[int] = None, **args) -> None:
    _GLOBAL.async_event(ph, name, async_id, cat=cat, ts_us=ts_us, **args)


def now_us() -> int:
    return _GLOBAL.now_us()


def add_counter(name: str, value: float = 1.0) -> float:
    return _GLOBAL.add_counter(name, value)


def set_gauge(name: str, value: float) -> None:
    _GLOBAL.set_gauge(name, value)


def export_chrome_trace(path: str,
                        rank: Optional[int] = None) -> Dict[str, Any]:
    return _GLOBAL.export_chrome_trace(path, rank=rank)
