"""Goodput attribution + SLO burn-rate tracking (train and serve).

A copy of ``chainermn_tpu/observability/slo.py`` (pure stdlib):

* :class:`GoodputLedger` — partitions wall-clock into named buckets
  (``compute`` / ``comm`` / ``host`` / ``compile`` / ``queue_wait`` /
  ``stall`` / ...).  Goodput = the compute fraction; everything else is
  attributed badput.  The serving engine measures its step phases into
  one; the ledger is a *partition*, not a sampling.
* :class:`SLOTracker` — target TTFT and tokens/s with multi-window
  burn-rate alerting (a violation-fraction budget burning faster than
  ``burn_threshold``× in BOTH a short and a long window pages).
  Findings fan out three ways: tracer instant, structured stderr JSON,
  and a pluggable ``escalate`` callback (plus a flight-recorder event).
* :class:`RateMeter` — the recent rate of a cumulative counter over a
  sliding window.
* :class:`ReservoirSample` — fixed-size uniform reservoir (algorithm R)
  keeping p50/p99 semantics O(1)-memory for long-running serve loops.
"""

from __future__ import annotations

import json
import random
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import trace
from . import flight as _flight


def percentile_of(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy's default definition) over
    an UNSORTED value list, or None when empty — the one implementation
    behind :meth:`ReservoirSample.percentile` and the router's fleet
    TTFT merge (serving/router.py)."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * (float(q) / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1 - frac) + vals[hi] * frac


class ReservoirSample:
    """Fixed-size uniform sample of an unbounded stream (algorithm R).

    Percentiles over the reservoir converge on the stream's percentiles
    (uniform inclusion probability ``k/n``), so p50/p99 stay meaningful
    after millions of requests at constant memory.  Deterministic given
    ``seed`` — same stream, same reservoir — which keeps tests exact.
    """

    def __init__(self, capacity: int = 1024, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._values: List[float] = []
        self._n = 0
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self._n += 1
        if len(self._values) < self.capacity:
            self._values.append(float(value))
            return
        j = self._rng.randrange(self._n)
        if j < self.capacity:
            self._values[j] = float(value)

    def __len__(self) -> int:
        return len(self._values)

    @property
    def total_seen(self) -> int:
        return self._n

    def values(self) -> List[float]:
        return list(self._values)

    def percentile(self, q: float) -> Optional[float]:
        """Linear-interpolated percentile over the retained sample (the
        same definition numpy uses), or None when empty."""
        return percentile_of(self._values, q)


class RateMeter:
    """Sliding-window rate over a CUMULATIVE counter.

    ``observe(total)`` stamps ``(t, total)``; :meth:`rate` is the delta
    per second between the oldest in-window sample and the newest — the
    *recent* rate a long healthy history cannot pin (the run-cumulative
    average problem the serving SLO throughput observation already
    solves ad hoc).  Used by the drain-aware ``retry_after_ms``
    derivation and the autoscaler's shed-rate / offered-load signals
   .  Pure stdlib; pass ``now`` explicitly for
    receiver-clocked deterministic tests.
    """

    def __init__(self, window_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque = deque()   # (t, total)

    def observe(self, total: float, now: Optional[float] = None) -> None:
        t = self._clock() if now is None else float(now)
        with self._lock:
            self._samples.append((t, float(total)))
            # keep ONE sample older than the window so rate() always
            # spans at least window_s once enough history exists
            cutoff = t - self.window_s
            while len(self._samples) > 2 and self._samples[1][0] < cutoff:
                self._samples.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        """Counter delta per second over the retained window (0.0 until
        two samples with distinct timestamps exist — callers treat that
        as "no throughput measured yet", the zero-throughput edge the
        retry derivation clamps)."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            (t0, v0), (t1, v1) = self._samples[0], self._samples[-1]
        if t1 <= t0:
            return 0.0
        return max(v1 - v0, 0.0) / (t1 - t0)


class GoodputLedger:
    """Wall-time partition into attribution buckets.

    ``measure(bucket)`` brackets a code region; ``add(bucket, s)`` books
    an already-measured duration (e.g. the updater's phase stamps).  The
    report reconciles attributed seconds against the wall clock since
    construction/reset — ``unattributed_s`` is the ledger's own error
    bar.
    """

    #: ``checkpoint``: final-save overhead on the preemption
    #: path and periodic-save flush time — booked, not vanished, so the
    #: goodput table shows what fault tolerance actually costs.
    #: ``transfer``: KV-slab transfer wall on the
    #: disaggregated serving path (prefill worker → decode worker) —
    #: its own bucket so the P:D tuning loop sees what the transfer
    #: plane costs instead of it hiding inside ``host``.
    #: ``supervise``: the fleet router's health-plane wall —
    #: lease reads, death detection, failover bookkeeping — booked so
    #: the supervision tax on the dispatch loop is visible, not hidden
    #: in ``host``.
    BUCKETS = ("compute", "comm", "host", "compile", "queue_wait", "stall",
               "checkpoint", "transfer", "supervise")

    def __init__(self, wall_clock: Callable[[], float] = time.monotonic):
        self._clock = wall_clock
        self._buckets: Dict[str, float] = {b: 0.0 for b in self.BUCKETS}
        self._wire_s = 0.0
        self._hidden_s = 0.0
        self._t0 = self._clock()

    def reset(self) -> None:
        self._buckets = {b: 0.0 for b in self.BUCKETS}
        self._wire_s = 0.0
        self._hidden_s = 0.0
        self._t0 = self._clock()

    def add(self, bucket: str, seconds: float) -> None:
        if bucket not in self._buckets:
            raise ValueError(
                f"unknown goodput bucket {bucket!r} (have {self.BUCKETS})")
        self._buckets[bucket] += max(float(seconds), 0.0)

    @contextmanager
    def measure(self, bucket: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(bucket, self._clock() - t0)

    def add_overlap(self, wire_s: float, hidden_s: float) -> None:
        """Book comm-overlap attribution: ``wire_s`` seconds
        of measured wire time, of which ``hidden_s`` were hidden behind
        other work (off the critical path — the schedule profiler's
        ``wire_hidden_us``).  Deliberately NOT a bucket: hidden wire
        time overlaps compute that is already booked, so adding it to
        the partition would double-count the wall.  It is a first-class
        attribution axis ON TOP of the partition."""
        wire_s = max(float(wire_s), 0.0)
        self._wire_s += wire_s
        self._hidden_s += min(max(float(hidden_s), 0.0), wire_s)

    def buckets(self) -> Dict[str, float]:
        return dict(self._buckets)

    def report(self) -> Dict[str, Any]:
        wall = max(self._clock() - self._t0, 1e-12)
        attributed = sum(self._buckets.values())
        rep: Dict[str, Any] = {
            "wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "unattributed_s": round(wall - attributed, 6),
            "coverage_frac": round(min(attributed / wall, 1.0), 4),
            "goodput_frac": round(self._buckets["compute"] / wall, 4),
            "buckets_s": {k: round(v, 6)
                          for k, v in self._buckets.items()},
            "buckets_frac": {k: round(v / wall, 4)
                             for k, v in self._buckets.items()},
            "comm_wire_s": round(self._wire_s, 6),
            "comm_hidden_s": round(self._hidden_s, 6),
            "comm_exposed_s": round(self._wire_s - self._hidden_s, 6),
            "overlap_frac": round(self._hidden_s / self._wire_s, 4)
            if self._wire_s > 0 else 0.0,
        }
        return rep

    def gauges(self, prefix: str = "goodput") -> Dict[str, float]:
        """Prometheus-ready flat gauges (``extra_gauges`` shape)."""
        rep = self.report()
        out = {f"{prefix}/goodput_frac": rep["goodput_frac"],
               f"{prefix}/coverage_frac": rep["coverage_frac"],
               f"{prefix}/overlap_frac": rep["overlap_frac"]}
        for k, v in rep["buckets_s"].items():
            out[f"{prefix}/{k}_s"] = v
        return out


class SLOTracker:
    """Multi-window burn-rate tracking for TTFT and throughput targets.

    Each TTFT observation is good (≤ ``ttft_target_ms``) or a violation;
    each throughput observation is good (≥ ``tokens_per_sec_target``) or
    a violation.  With an SLO objective of ``objective`` (default 0.99 —
    1% violation budget), the burn rate over a window is::

        violations/window_total  /  (1 - objective)

    A page fires when the burn rate exceeds ``burn_threshold`` in BOTH
    the short and the long window (the multi-window rule: the short
    window proves it is happening *now*, the long one that it is not a
    blip).  Findings carry ``kind="slo_burn"`` in the HealthMonitor
    shape and fan out identically: tracer instant + structured stderr
    JSON + ``escalate`` callback + a flight-recorder event.
    """

    def __init__(self, ttft_target_ms: Optional[float] = None,
                 tokens_per_sec_target: Optional[float] = None,
                 objective: float = 0.99,
                 windows_s: Tuple[float, float] = (60.0, 600.0),
                 burn_threshold: float = 2.0,
                 min_observations: int = 10,
                 escalate: Optional[Callable[[Dict[str, Any]], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 log_stream=None):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.ttft_target_ms = ttft_target_ms
        self.tokens_per_sec_target = tokens_per_sec_target
        self.objective = float(objective)
        self.windows_s = (float(windows_s[0]), float(windows_s[1]))
        if self.windows_s[0] >= self.windows_s[1]:
            raise ValueError("windows_s must be (short, long) with "
                             f"short < long, got {windows_s}")
        self.burn_threshold = float(burn_threshold)
        self.min_observations = int(min_observations)
        self.escalate = escalate
        self._clock = clock
        self._log = log_stream
        # (t, ok) per observation, bounded by the long window at read
        # time; hard cap so a pathological rate cannot eat the host
        self._obs: Dict[str, deque] = {
            "ttft": deque(maxlen=100_000),
            "throughput": deque(maxlen=100_000)}
        self._obs_lock = threading.Lock()   # engine thread vs /statusz
        self.findings: List[Dict[str, Any]] = []
        self._fired_at: Dict[str, float] = {}

    # ---- observation ----
    def _append(self, metric: str, ok: bool) -> None:
        """Record one observation and prune everything older than the
        long window — the scan in ``_window_stats`` (and its snapshot
        copy) stays bounded by the window, not by run length."""
        now = self._clock()
        obs_q = self._obs[metric]
        with self._obs_lock:
            obs_q.append((now, ok))
            cutoff = now - self.windows_s[1]
            while obs_q and obs_q[0][0] < cutoff:
                obs_q.popleft()

    def observe_ttft(self, ttft_ms: float) -> None:
        if self.ttft_target_ms is None:
            return
        self._append("ttft", float(ttft_ms) <= self.ttft_target_ms)
        self._check("ttft", float(ttft_ms), self.ttft_target_ms)

    def observe_throughput(self, tokens_per_sec: float) -> None:
        if self.tokens_per_sec_target is None:
            return
        self._append("throughput",
                     float(tokens_per_sec) >= self.tokens_per_sec_target)
        self._check("throughput", float(tokens_per_sec),
                    self.tokens_per_sec_target)

    # ---- burn-rate math ----
    def _window_stats(self, metric: str, window_s: float
                      ) -> Tuple[int, int]:
        cutoff = self._clock() - window_s
        total = bad = 0
        # locked snapshot: the serving thread appends/prunes while a
        # /statusz scrape reads burn rates, and iterating (or copying)
        # a mutating deque raises RuntimeError
        with self._obs_lock:
            snapshot = list(self._obs[metric])
        for t, ok in reversed(snapshot):
            if t < cutoff:
                break
            total += 1
            if not ok:
                bad += 1
        return total, bad

    def burn_rate(self, metric: str, window_s: float) -> Optional[float]:
        total, bad = self._window_stats(metric, window_s)
        if total < self.min_observations:
            return None
        budget = 1.0 - self.objective
        return (bad / total) / budget

    def short_window_burn(self, metrics: Tuple[str, ...] = ("ttft",
                                                            "throughput")
                          ) -> Optional[float]:
        """Worst short-window burn across ``metrics`` (None when no
        metric has enough observations) — THE overload scalar the shed
        gate, the degradation ladder, and the autoscaler all read; one
        definition so they can never disagree on what "burning" means
       ."""
        burns = [self.burn_rate(m, self.windows_s[0]) for m in metrics]
        burns = [b for b in burns if b is not None]
        return max(burns) if burns else None

    def _check(self, metric: str, value: float, target: float) -> None:
        short, long_ = self.windows_s
        b_short = self.burn_rate(metric, short)
        b_long = self.burn_rate(metric, long_)
        if b_short is None or b_long is None:
            return
        if b_short <= self.burn_threshold or b_long <= self.burn_threshold:
            return
        # debounce: at most one page per metric per short window
        now = self._clock()
        if now - self._fired_at.get(metric, -1e18) < short:
            return
        self._fired_at[metric] = now
        finding = {
            "kind": "slo_burn", "metric": metric,
            "iteration": len(self._obs[metric]),
            "value": round(value, 4), "expected": target,
            "detail": (f"{metric} SLO burning {b_short:.1f}x budget over "
                       f"{short:.0f}s and {b_long:.1f}x over {long_:.0f}s "
                       f"(objective {self.objective}, threshold "
                       f"{self.burn_threshold}x)"),
            "burn_rate_short": round(b_short, 2),
            "burn_rate_long": round(b_long, 2),
        }
        self.findings.append(finding)
        _flight.note("slo_burn", **{k: v for k, v in finding.items()
                                    if k != "kind"})
        tr = trace.get_tracer()
        tr.instant("anomaly/slo_burn", cat="anomaly",
                   **{k: v for k, v in finding.items() if k != "kind"})
        line = dict(finding, ts=round(time.time(), 3))
        print(f"[chainermn_tpu slo] {json.dumps(line, sort_keys=True)}",
              file=self._log or sys.stderr, flush=True)
        if self.escalate is not None:
            try:
                self.escalate(finding)
            except Exception as e:
                print(f"[chainermn_tpu slo] escalation callback failed: "
                      f"{e!r}", file=self._log or sys.stderr, flush=True)

    # ---- read-out ----
    def status(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "objective": self.objective,
            "windows_s": list(self.windows_s),
            "burn_threshold": self.burn_threshold,
            "targets": {"ttft_ms": self.ttft_target_ms,
                        "tokens_per_sec": self.tokens_per_sec_target},
            "pages": len(self.findings),
            "last_finding": self.findings[-1] if self.findings else None,
        }
        for metric in ("ttft", "throughput"):
            short, long_ = self.windows_s
            out[metric] = {
                "observations": len(self._obs[metric]),
                "burn_rate_short": self.burn_rate(metric, short),
                "burn_rate_long": self.burn_rate(metric, long_),
            }
        return out

    def health(self) -> Dict[str, Any]:
        """HealthMonitor-compatible contribution to health_snapshot."""
        return {"counts": {"slo_burn": len(self.findings)},
                "findings": list(self.findings[-50:]),
                "findings_dropped": 0}
