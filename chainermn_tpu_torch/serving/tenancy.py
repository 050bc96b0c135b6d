"""Multi-tenant QoS: admission budgets, priority classes, degradation.

A copy of ``chainermn_tpu/serving/tenancy.py`` (pure host Python,
fuzzable standalone): a fleet
serving millions of users carries tenants with very different SLO
value, and "keep the paid tenant's SLO intact under a burst" means the
router must know WHO each request bills to and degrade the cheap
traffic FIRST — by explicit, machine-readable, counted steps, never by
queue collapse.  Three pieces:

* **Priority classes** — every tenant is ``paid`` or ``best_effort``
  (:data:`PRIORITIES`, ordered most- to least-protected).  The
  routers' shared SLO-burn shed gate
  (:meth:`~chainermn_tpu_torch.serving.router.RouterBase._maybe_shed_slo`)
  sheds best-effort tenants at the configured ``shed_burn_threshold``
  but gives paid tenants ``paid_burn_headroom``× more room — so under
  overload a best-effort tenant sheds while the paid tenant's burn
  rate is still approaching the pager, not after it fired.

* **Admission budgets** (:class:`Tenant`) — a per-tenant token bucket
  on request admissions (``rate_per_s`` refill, ``burst`` capacity)
  plus a ``max_inflight`` concurrency cap.  Exhausting either refuses
  the submit with reason ``shed_tenant_budget`` carrying the tenant
  and the current degradation rung (``AdmissionError.to_dict()`` wire
  shape) — one noisy tenant cannot starve the rest even inside its
  own priority class.

* **Degradation ladder** (:class:`DegradationLadder`) — before the
  router sheds a PRIORITY tenant it walks best-effort service down
  four rungs, each a counted observable state transition (``degrade``
  flight events):

  ====  ==============  ====================================================
  rung  name            effect on best-effort tenants
  ====  ==============  ====================================================
  0     ``normal``      full service
  1     ``tight``       ``max_new_tokens`` clamped to ``tight_frac`` of the
                        request's ask (floor 1)
  2     ``throttle``    rejection ``retry_after_ms`` hints multiplied by
                        ``throttle_retry_mult`` on top of the drain-rate
                        derivation (clients back off harder than congestion
                        alone implies)
  3     ``pause``       admission refused outright (``shed_tenant_budget``)
  ====  ==============  ====================================================

  The ladder climbs on a scalar overload *pressure* (the router feeds
  ``max(burn_rate/shed_threshold, queue_depth/queue_capacity)``) with
  per-rung enter thresholds, exits a hysteresis gap LOWER, and holds
  each rung for a minimum dwell — the same no-flap discipline as the
  autoscaler.

:class:`TenantTable` composes all three and owns the per-tenant
attribution it reports in ``/statusz`` and ``/metricsz``:
admitted/shed counters per reason, tokens emitted, TTFT reservoirs,
degraded-request counts, and live budget consumption.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability.slo import ReservoirSample, percentile_of

#: Priority classes, most- to least-protected.  ``paid`` traffic sheds
#: only with ``paid_burn_headroom``× headroom past the best-effort shed
#: threshold; ``best_effort`` absorbs every degradation rung first.
PRIORITIES = ("paid", "best_effort")


class DegradationLadder:
    """Stepwise best-effort degradation with hysteresis (rungs 0..3).

    ``update(pressure, now)`` is a pure function of its inputs and the
    retained state — no sleeps, receiver-clocked (pass ``now``
    explicitly in tests).  Climbing requires ``pressure`` ≥ the next
    rung's enter threshold; descending requires pressure < (enter −
    ``hysteresis``) AND ``dwell_s`` elapsed since the last transition,
    so a pressure signal oscillating around one threshold cannot make
    the ladder flap.  Every transition is counted and noted
    (``degrade`` flight events carry from/to rung and the pressure that
    drove it).
    """

    RUNGS = ("normal", "tight", "throttle", "pause")

    def __init__(self, *, enter=(0.85, 1.0, 1.25), hysteresis: float = 0.2,
                 dwell_s: float = 0.5, tight_frac: float = 0.5,
                 throttle_retry_mult: float = 4.0):
        if len(enter) != len(self.RUNGS) - 1:
            raise ValueError(f"enter wants {len(self.RUNGS) - 1} "
                             f"thresholds (one per rung above normal), "
                             f"got {enter}")
        if list(enter) != sorted(enter):
            raise ValueError(f"enter thresholds must ascend, got {enter}")
        if hysteresis <= 0:
            raise ValueError("hysteresis must be > 0 (equal enter/exit "
                             "thresholds flap on a noisy signal)")
        self.enter = tuple(float(e) for e in enter)
        self.hysteresis = float(hysteresis)
        self.dwell_s = float(dwell_s)
        self.tight_frac = float(tight_frac)
        self.throttle_retry_mult = float(throttle_retry_mult)
        self.rung = 0
        self.last_pressure = 0.0
        self.transitions = 0
        self.transitions_up = 0
        self.rung_entries = {name: 0 for name in self.RUNGS}
        self._t_last_transition: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.RUNGS[self.rung]

    @property
    def paused(self) -> bool:
        return self.rung >= 3

    def cap_max_tokens(self, requested: int) -> int:
        """Best-effort ``max_new_tokens`` under the current rung."""
        if self.rung >= 1:
            return max(int(int(requested) * self.tight_frac), 1)
        return int(requested)

    def retry_multiplier(self) -> float:
        """Multiplier on best-effort ``retry_after_ms`` hints."""
        return self.throttle_retry_mult if self.rung >= 2 else 1.0

    def update(self, pressure: float, now: Optional[float] = None) -> int:
        """Advance/retreat at most one rung per call; returns the rung."""
        from ..observability import flight as _flight

        now = time.monotonic() if now is None else float(now)
        pressure = float(pressure)
        with self._lock:
            self.last_pressure = pressure
            old = self.rung
            dwelt = (self._t_last_transition is None
                     or now - self._t_last_transition >= self.dwell_s)
            if (self.rung < len(self.RUNGS) - 1
                    and pressure >= self.enter[self.rung]):
                self.rung += 1
            elif (self.rung > 0 and dwelt
                    and pressure < self.enter[self.rung - 1]
                    - self.hysteresis):
                self.rung -= 1
            if self.rung != old:
                self.transitions += 1
                if self.rung > old:
                    self.transitions_up += 1
                self.rung_entries[self.RUNGS[self.rung]] += 1
                self._t_last_transition = now
                new_rung, new_name = self.rung, self.name
            else:
                return self.rung
        _flight.note("degrade", event="rung_change",
                     rung=new_rung, name=new_name,
                     from_rung=old, pressure=round(pressure, 4))
        return new_rung

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rung": self.rung,
                "name": self.name,
                "pressure": round(self.last_pressure, 4),
                "enter": list(self.enter),
                "hysteresis": self.hysteresis,
                "transitions": self.transitions,
                "rung_entries": dict(self.rung_entries),
            }


class Tenant:
    """One tenant's class, budgets, bucket state, and attribution."""

    def __init__(self, name: str, priority: str = "paid", *,
                 rate_per_s: Optional[float] = None,
                 burst: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 stats_capacity: int = 512):
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        self.name = str(name)
        self.priority = priority
        self.rate_per_s = None if rate_per_s is None else float(rate_per_s)
        self.burst = (None if rate_per_s is None
                      else max(int(burst if burst is not None
                                   else max(rate_per_s, 1.0)), 1))
        self.max_inflight = (None if max_inflight is None
                             else int(max_inflight))
        # token bucket (admissions): starts full
        self._bucket = float(self.burst or 0)
        self._t_refill: Optional[float] = None
        # attribution
        self.submitted = 0
        self.admitted = 0
        self.degraded = 0                  # max_new_tokens clamped
        self.shed: Dict[str, int] = {}     # reason -> count
        self.tokens_emitted = 0
        self.ttft_ms = ReservoirSample(int(stats_capacity))
        self._tracked: List[Any] = []      # live Requests (lazy-pruned)

    # ---- budget ----
    def _refill(self, now: float) -> None:
        if self.rate_per_s is None:
            return
        if self._t_refill is None:
            self._t_refill = now
            return
        self._bucket = min(self._bucket
                           + (now - self._t_refill) * self.rate_per_s,
                           float(self.burst))
        self._t_refill = now

    def budget_check(self, now: float) -> Optional[str]:
        """Why admission must be refused NOW (a detail string), or None
        to admit (consuming one bucket token)."""
        self._prune()
        if self.max_inflight is not None \
                and len(self._tracked) >= self.max_inflight:
            return (f"tenant {self.name!r} at max_inflight "
                    f"{self.max_inflight}")
        if self.rate_per_s is not None:
            self._refill(now)
            if self._bucket < 1.0:
                return (f"tenant {self.name!r} admission budget "
                        f"exhausted ({self.rate_per_s}/s, burst "
                        f"{self.burst})")
            self._bucket -= 1.0
        return None

    # ---- attribution ----
    def _prune(self) -> None:
        self._tracked = [r for r in self._tracked
                        if r.status not in ("done", "evicted")]

    def track(self, req) -> None:
        self._tracked.append(req)

    @property
    def inflight(self) -> int:
        self._prune()
        return len(self._tracked)

    def budget_state(self, now: float) -> Dict[str, Any]:
        self._refill(now)
        return {
            "priority": self.priority,
            "rate_per_s": self.rate_per_s,
            "burst": self.burst,
            "bucket_tokens": (None if self.rate_per_s is None
                              else round(self._bucket, 3)),
            "max_inflight": self.max_inflight,
            "inflight": self.inflight,
        }


class TenantTable:
    """The router-side tenant plane: registry + ladder + attribution.

    One table is shared by a router (or a whole fleet); every method is
    thread-safe (submit threads vs the supervisor/driver thread).
    Unknown tenants auto-register at ``default_priority`` with no
    budgets — tagging traffic is enough to get attribution; budgets
    are opt-in via :meth:`register`.
    """

    def __init__(self, *, default_priority: str = "paid",
                 ladder: Optional[DegradationLadder] = None,
                 clock: Callable[[], float] = time.monotonic):
        if default_priority not in PRIORITIES:
            raise ValueError(f"default_priority must be one of "
                             f"{PRIORITIES}, got {default_priority!r}")
        self.default_priority = default_priority
        self.ladder = ladder or DegradationLadder()
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}

    # ---- registry ----
    def register(self, name: str, priority: Optional[str] = None,
                 **budgets) -> Tenant:
        with self._lock:
            t = self._tenants.get(str(name))
            if t is None:
                t = Tenant(name, priority or self.default_priority,
                           **budgets)
                self._tenants[t.name] = t
            return t

    def resolve(self, name: str,
                priority: Optional[str] = None) -> Tenant:
        """The submit-path lookup: auto-registers unknown tenants (no
        budgets) so tagging alone yields attribution."""
        return self.register(name, priority)

    def get(self, name: str) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.get(str(name))

    def tenants(self) -> List[Tenant]:
        with self._lock:
            return list(self._tenants.values())

    # ---- admission plane ----
    def admission_check(self, tenant: Tenant,
                        now: Optional[float] = None
                        ) -> Optional[Tuple[str, str]]:
        """Returns ``(reason, detail)`` to refuse, or None to admit.
        Best-effort tenants additionally honor the ladder's ``pause``
        rung.  Counts the submit either way."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            tenant.submitted += 1
            if tenant.priority == "best_effort" and self.ladder.paused:
                return ("shed_tenant_budget",
                        f"best-effort admission paused at degradation "
                        f"rung {self.ladder.rung} ({self.ladder.name})")
            detail = tenant.budget_check(now)
            if detail is not None:
                return ("shed_tenant_budget", detail)
            return None

    def on_admit(self, tenant: Tenant, req,
                 capped: bool = False) -> None:
        with self._lock:
            tenant.admitted += 1
            if capped:
                tenant.degraded += 1
            tenant.track(req)

    def count_shed(self, tenant_name: Optional[str],
                   reason: str) -> None:
        if tenant_name is None:
            return
        t = self.resolve(tenant_name)
        with self._lock:
            t.shed[reason] = t.shed.get(reason, 0) + 1

    # ---- goodput/TTFT attribution ----
    def on_tokens(self, tenant_name: Optional[str], n: int) -> None:
        if tenant_name is None:
            return
        t = self.resolve(tenant_name)
        with self._lock:
            t.tokens_emitted += int(n)

    def on_ttft(self, tenant_name: Optional[str], ttft_ms: float) -> None:
        if tenant_name is None:
            return
        t = self.resolve(tenant_name)
        with self._lock:
            t.ttft_ms.add(float(ttft_ms))

    def wrap_on_token(self, tenant_name: str, t_submit: float,
                      on_token: Optional[Callable] = None) -> Callable:
        """Per-tenant attribution wrapper for routers whose engines own
        the token stream (ServingRouter/DisaggRouter): first token
        stamps the tenant's TTFT (measured from the ROUTER's submit
        stamp), every token bills the tenant, and the caller's callback
        still runs."""
        seen_first = [False]

        def cb(tok: int, rid: int) -> None:
            if not seen_first[0]:
                seen_first[0] = True
                self.on_ttft(tenant_name,
                             (time.monotonic() - t_submit) * 1e3)
            self.on_tokens(tenant_name, 1)
            if on_token is not None:
                on_token(tok, rid)

        return cb

    # ---- read-out ----
    def metrics(self) -> Dict[str, float]:
        """Flat per-tenant gauges (``tenant/<name>/*`` — the
        ``/metricsz`` and bench-section payload).  ``shed``/``degraded``
        keys gate lower-is-better."""
        out: Dict[str, float] = {}
        lad = self.ladder.state()
        out["tenant/degradation_rung"] = float(lad["rung"])
        out["tenant/degradation_transitions"] = float(lad["transitions"])
        for t in self.tenants():
            with self._lock:
                p = f"tenant/{t.name}"
                out[f"{p}/submitted_total"] = float(t.submitted)
                out[f"{p}/admitted_total"] = float(t.admitted)
                out[f"{p}/degraded_total"] = float(t.degraded)
                out[f"{p}/shed_total"] = float(sum(t.shed.values()))
                for reason, n in sorted(t.shed.items()):
                    out[f"{p}/shed/{reason}"] = float(n)
                out[f"{p}/tokens_total"] = float(t.tokens_emitted)
                out[f"{p}/inflight"] = float(t.inflight)
                vals = t.ttft_ms.values()
            if vals:
                out[f"{p}/ttft_p50_ms"] = percentile_of(vals, 50)
                out[f"{p}/ttft_p99_ms"] = percentile_of(vals, 99)
        return out

    def state(self) -> Dict[str, Any]:
        """The ``/statusz``/bundle view: ladder + per-tenant budget
        consumption and attribution."""
        now = self._clock()
        tenants = {}
        for t in self.tenants():
            with self._lock:
                tenants[t.name] = dict(
                    t.budget_state(now),
                    submitted=t.submitted, admitted=t.admitted,
                    degraded=t.degraded, shed=dict(t.shed),
                    tokens=t.tokens_emitted)
        return {"ladder": self.ladder.state(), "tenants": tenants}
