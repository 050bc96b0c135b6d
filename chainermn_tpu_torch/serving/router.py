"""Serving fleet router: dispatch, prefix affinity, SLO admission.

A port of ``chainermn_tpu/serving/router.py`` (:class:`RouterBase`,
:class:`ServingRouter`, :func:`build_fleet`): N engines as the fast lane,
this host-side router as the slow lane composing them into one service.

**Dispatch** (least-loaded, deadline-aware, prefix-affine).  Every
candidate replica is scored in TOKEN units::

    score = prefix_match_len − backlog_tokens

``prefix_match_len`` (the replica's radix-trie peek) is compute the
replica does NOT have to do; ``backlog_tokens`` (queued prompt+decode
work plus running remainders) is compute it must do first.  Ties break
to the emptier queue, then round-robin.  A request carrying a deadline
skips replicas whose estimated start delay (``backlog_tokens`` × the
measured token latency) already overruns it.

**Admission control** (shed before the pager fires).  With a fleet
:class:`~chainermn_tpu_torch.observability.slo.SLOTracker` (every
replica feeds it), new work is refused with
``AdmissionError(reason="shed_slo")`` once the short-window burn rate
crosses ``shed_burn_threshold`` while the fleet has backlog.
Deadline-infeasible requests shed the same way, and full queues
everywhere reject ``queue_full``; each rejection carries
``retry_after_ms`` (the queued tokens priced at the fleet's recent
tokens/s) and the fleet queue depth.

**Observability.**  The router mints each request's ``trace_id`` before
dispatch and passes it through the replica hop, counts rejections per
reason in :meth:`ServingRouter.metrics`, streams them as
``router_rejection`` JSONL records and registers the ``router`` flight
provider over every replica's ``introspect_state()``.

On one card the replicas share the device: each owns its pool and
launches its own kernels.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import observability as obs
from ..observability import flight as _flight
from ..observability.slo import RateMeter, SLOTracker
from .autoscale import derive_retry_after_ms
from .frontend import RequestHandle
from .replica import Replica
from .scheduler import AdmissionError
from .tenancy import TenantTable

#: Rejection reasons a router can emit: ``queue_full``, ``too_long``,
#: ``shed_slo``, ``worker_lost`` (a fleet's worker died with the request
#: in flight) and ``shed_tenant_budget`` (a tenant's admission budget is
#: spent, or best-effort admission is paused at the top degradation
#: rung: the payload names the tenant and the rung).
REJECT_REASONS = ("queue_full", "too_long", "shed_slo", "worker_lost",
                  "shed_tenant_budget")


class RouterBase:
    """Shared router machinery:
    trace-id minting, uniformly-shaped machine-readable rejections, the
    SLO-burn shed gate, the drain-aware ``retry_after_ms`` derivation,
    and the tenant plane — one implementation behind the replica fleet
    (:class:`ServingRouter`), the disaggregated fleet
    (``disagg.py::DisaggRouter``) and the cross-process fleet
    (``fleet.py::FleetRouter``), so every rejection anywhere in the serving
    stack carries the same ``AdmissionError.to_dict()``
    wire shape, per-reason counters, and JSONL/flight/tracer emissions.

    ``tenancy`` (a :class:`~chainermn_tpu_torch.serving.tenancy.TenantTable`)
    turns on multi-tenant QoS: ``submit(tenant=, priority=)`` bills the
    request, per-tenant admission budgets refuse with
    ``shed_tenant_budget``, the degradation ladder walks best-effort
    service down before any paid tenant sheds, and the SLO gate gives
    paid tenants ``paid_burn_headroom``× more burn room than
    best-effort traffic.
    """

    #: flight/metrics namespace ("router" / "disagg") — subclasses set.
    ROLE = "router"

    def __init__(self, metrics_writer=None, *,
                 tenancy: Optional[TenantTable] = None,
                 slo: Optional[SLOTracker] = None,
                 shed_burn_threshold: float = 1.0,
                 paid_burn_headroom: float = 2.0,
                 default_token_latency_ms: float = 20.0):
        self.metrics_writer = metrics_writer
        self.tenancy = tenancy
        self.slo = slo
        self.shed_burn_threshold = float(shed_burn_threshold)
        self.paid_burn_headroom = float(paid_burn_headroom)
        self.default_token_latency_ms = float(default_token_latency_ms)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._rejected: Dict[str, int] = {r: 0 for r in REJECT_REASONS}
        # drain-aware retry hints: recent fleet
        # tokens/s over a sliding window; deterministic jitter source
        self._tps_meter = RateMeter(window_s=5.0)
        self._retry_rng = random.Random(0xC0FFEE)

    def _mint_trace_id(self) -> str:
        return f"req-{os.getpid():x}-rt{next(self._ids):08x}"

    def rejection_counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._rejected)

    def _reject(self, reason: str, trace_id: str, detail: str, *,
                retry_after_ms: float, queue_depth: int,
                tenant: Optional[str] = None):
        rung = None
        if self.tenancy is not None:
            rung = self.tenancy.ladder.rung
            if tenant is not None:
                t = self.tenancy.get(tenant)
                if t is not None and t.priority == "best_effort":
                    # the ladder's throttle rung: best-effort clients
                    # back off harder than congestion alone implies
                    retry_after_ms *= \
                        self.tenancy.ladder.retry_multiplier()
                self.tenancy.count_shed(tenant, reason)
        with self._lock:
            self._rejected[reason] = self._rejected.get(reason, 0) + 1
        err = AdmissionError(reason, detail,
                             retry_after_ms=retry_after_ms,
                             queue_depth=queue_depth,
                             tenant=tenant, rung=rung)
        obs.instant(f"{self.ROLE}/rejected", cat="serving", reason=reason,
                    trace_id=trace_id, queue_depth=queue_depth)
        _flight.note(self.ROLE, event="rejected", reason=reason,
                     trace_id=trace_id, detail=detail,
                     **({"tenant": tenant} if tenant else {}))
        if self.metrics_writer is not None:
            record = dict({f"{self.ROLE}/{k}": v
                           for k, v in err.to_dict().items()
                           if not isinstance(v, str)},
                          reason=reason, trace_id=trace_id)
            if tenant is not None:
                record["tenant"] = tenant
            self.metrics_writer.write(record,
                                      kind=f"{self.ROLE}_rejection")
        raise err

    # ---- drain-aware back-off hints ----
    def _derive_retry_ms(self, backlog_tokens: float,
                         tokens_total: float) -> float:
        """``retry_after_ms`` from the MEASURED backlog drain rate:
        feed the cumulative token counter into the sliding-window
        meter, then price the queued tokens at the recent rate
        (``autoscale.derive_retry_after_ms`` owns the clamped/jittered
        formula and its zero-throughput edges)."""
        self._tps_meter.observe(float(tokens_total))
        return derive_retry_after_ms(
            backlog_tokens, self._tps_meter.rate(),
            default_token_latency_ms=self.default_token_latency_ms,
            rng=self._retry_rng)

    @staticmethod
    def _lazy_ms(retry_after_ms) -> float:
        """Rejection helpers take the back-off hint as a VALUE or a
        zero-arg callable — callable lets the submit hot path defer the
        (per-worker-lock-taking) estimate to the reject branch."""
        return float(retry_after_ms() if callable(retry_after_ms)
                     else retry_after_ms)

    # ---- the shared SLO-burn shed gate ----
    def _maybe_shed_slo(self, trace_id: str, queue_depth: int,
                        retry_after_ms,
                        tenant: Optional[str] = None) -> None:
        """Shed BEFORE the pager fires: when the short-window burn rate
        crosses ``shed_burn_threshold`` with backlog, refuse new work
        machine-readably.  A paid tenant's threshold is multiplied by
        ``paid_burn_headroom`` — best-effort traffic sheds first, and
        the paid tenant only sheds when the burn keeps climbing anyway
        (still below the 2-window pager when headroom < the tracker's
        ``burn_threshold``)."""
        if self.slo is None or queue_depth <= 0:
            return
        threshold = self.shed_burn_threshold
        if tenant is not None and self.tenancy is not None:
            t = self.tenancy.get(tenant)
            if t is not None and t.priority == "paid":
                threshold *= self.paid_burn_headroom
        burn = self.slo.short_window_burn()
        if burn is not None and burn > threshold:
            self._reject(
                "shed_slo", trace_id,
                f"short-window burn rate {burn:.2f}x exceeds "
                f"shed threshold {threshold}x with "
                f"{queue_depth} queued",
                retry_after_ms=self._lazy_ms(retry_after_ms),
                queue_depth=queue_depth, tenant=tenant)

    # ---- the tenant admission plane ----
    def _overload_pressure(self, queue_depth: int,
                           queue_capacity: int) -> float:
        """The scalar the degradation ladder climbs on: how close the
        fleet is to shedding, as max(burn/shed-threshold, fleet queue
        fill fraction).  ``queue_capacity <= 0`` means UNKNOWN (a
        cross-process fleet whose workers have not published a lease
        yet) — unknown is not full: the fill term is skipped rather
        than dividing a raw depth by zero-ish and spuriously pausing
        best-effort admission during boot."""
        pressure = 0.0
        if queue_capacity > 0:
            pressure = float(queue_depth) / float(queue_capacity)
        if self.slo is not None:
            burn = self.slo.short_window_burn()
            if burn is not None:
                pressure = max(pressure,
                               burn / max(self.shed_burn_threshold,
                                          1e-9))
        return pressure

    def _admit_tenant(self, trace_id: str, tenant: Optional[str],
                      priority: Optional[str], max_new_tokens: int, *,
                      queue_depth: int, queue_capacity: int,
                      retry_after_ms):
        """The submit-path tenant gate: resolve/auto-register, advance
        the degradation ladder on the current overload pressure, refuse
        over-budget or paused best-effort work (``shed_tenant_budget``
        with tenant + rung), and clamp best-effort ``max_new_tokens``
        at the ``tight`` rung.  Returns ``(tenant_name, capped
        max_new_tokens, capped?)``; untagged traffic with no table
        passes through untouched."""
        if self.tenancy is None:
            return tenant, int(max_new_tokens), False
        tab = self.tenancy
        tab.ladder.update(
            self._overload_pressure(queue_depth, queue_capacity))
        if tenant is None:
            return None, int(max_new_tokens), False
        t = tab.resolve(tenant, priority)
        refused = tab.admission_check(t)
        if refused is not None:
            reason, detail = refused
            self._reject(reason, trace_id, detail,
                         retry_after_ms=self._lazy_ms(retry_after_ms),
                         queue_depth=queue_depth, tenant=t.name)
        capped = int(max_new_tokens)
        if t.priority == "best_effort":
            capped = tab.ladder.cap_max_tokens(capped)
        return t.name, capped, capped < int(max_new_tokens)

    def _stamp_tenant_meta(self, req, tenant: Optional[str]) -> None:
        """Stamp the admitted request with its resolved priority and
        the degradation rung it was admitted under — the stable
        /requestz tenancy columns (``_request_row`` always emits
        ``tenant``/``priority``/``rung``; None means the request never
        crossed a tenant-aware router)."""
        if self.tenancy is None:
            return
        req.rung = self.tenancy.ladder.rung
        if tenant is not None:
            req.priority = self.tenancy.resolve(tenant).priority


class ServingRouter(RouterBase):
    """Process-level router fronting N :class:`Replica` engines.

    ``slo``: the FLEET tracker (shared by every replica's engine so all
    TTFT/throughput observations land in one burn-rate budget); when
    None, ``shed_slo`` only fires on deadline infeasibility.
    ``shed_burn_threshold``: short-window burn rate above which new
    work is shed while backlog exists — set BELOW the tracker's paging
    ``burn_threshold`` so shedding starts before the page.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 slo: Optional[SLOTracker] = None,
                 shed_burn_threshold: float = 1.0,
                 default_token_latency_ms: float = 20.0,
                 metrics_writer=None,
                 tenancy: Optional[TenantTable] = None,
                 paid_burn_headroom: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if not replicas:
            raise ValueError("need at least one replica")
        super().__init__(
            metrics_writer=metrics_writer, tenancy=tenancy, slo=slo,
            shed_burn_threshold=shed_burn_threshold,
            paid_burn_headroom=paid_burn_headroom,
            default_token_latency_ms=default_token_latency_ms)
        self.replicas: List[Replica] = list(replicas)
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self._clock = clock
        self._rr = 0                      # round-robin tie-breaker
        self._dispatched = 0
        self._dispatched_by: Dict[str, int] = {n: 0 for n in names}
        self._affinity_hits = 0           # dispatches won by prefix len
        _flight.register_provider("router", self.introspect_state)

    # ---- submission ----
    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token=None, temperature: float = 0.0,
               rng=None, tenant: Optional[str] = None,
               priority: Optional[str] = None) -> RequestHandle:
        """Dispatch to the best replica or raise :class:`AdmissionError`
        with a machine-readable reason + ``retry_after_ms`` +
        ``queue_depth`` (the shape ``.to_dict()`` serializes for 429
        bodies and the JSONL stream).  ``temperature``/``rng`` ride the
        hop unchanged (the engine enforces the sampling contract).
        ``tenant``/``priority`` bill the request to a tenant class
       : per-tenant budgets, degradation-ladder clamping of
        best-effort ``max_new_tokens``, and paid-first SLO protection
        all key off them."""
        trace_id = self._mint_trace_id()
        t0_us = obs.now_us()
        t_submit = time.monotonic()
        loads = [r.load() for r in self.replicas]
        fleet_depth = sum(ld["queue_depth"] for ld in loads)
        fleet_cap = sum(ld["queue_capacity"] for ld in loads)

        # tenant plane first (budgets/pause are cheaper than the SLO
        # math and independent of fleet state), then the shared
        # SLO-burn gate — best-effort sheds at the base threshold,
        # paid with paid_burn_headroom× more room
        tenant, max_new_tokens, capped = self._admit_tenant(
            trace_id, tenant, priority, max_new_tokens,
            queue_depth=fleet_depth, queue_capacity=fleet_cap,
            retry_after_ms=lambda: self._retry_after_ms(loads))
        self._maybe_shed_slo(trace_id, fleet_depth,
                             lambda: self._retry_after_ms(loads), tenant)

        candidates = []
        for i, (rep, ld) in enumerate(zip(self.replicas, loads)):
            if ld["queue_depth"] >= ld["queue_capacity"]:
                continue   # full: submitting would be rejected anyway
            wait_ms = ld["backlog_tokens"] * rep.token_latency_ms(
                self.default_token_latency_ms)
            if deadline_s is not None and wait_ms / 1e3 >= deadline_s:
                continue   # cannot start before the deadline
            match_len = rep.peek_prefix_len(prompt)
            score = match_len - ld["backlog_tokens"]
            candidates.append((score, -ld["queue_depth"], i, rep,
                               match_len))
        if not candidates:
            if all(ld["queue_depth"] >= ld["queue_capacity"]
                   for ld in loads):
                self._reject(
                    "queue_full", trace_id,
                    f"all {len(self.replicas)} replica queues at "
                    f"capacity",
                    retry_after_ms=self._retry_after_ms(loads),
                    queue_depth=fleet_depth, tenant=tenant)
            # queues have room but no replica can meet the deadline:
            # starting it anyway would only burn SLO budget
            self._reject(
                "shed_slo", trace_id,
                "no replica can start before the request deadline "
                f"(deadline_s={deadline_s})",
                retry_after_ms=self._retry_after_ms(loads),
                queue_depth=fleet_depth, tenant=tenant)

        # max score, then emptier queue, then round-robin (the i-index
        # rotation keeps a tied fleet evenly loaded)
        rr = self._rr
        best = max(candidates,
                   key=lambda c: (c[0], c[1], -((c[2] - rr)
                                                % len(self.replicas))))
        _, _, idx, rep, match_len = best
        self._rr = (idx + 1) % len(self.replicas)
        if self.tenancy is not None and tenant is not None:
            # per-tenant TTFT/goodput attribution rides the token
            # stream (the engine owns it; the router only sees submit)
            on_token = self.tenancy.wrap_on_token(tenant, t_submit,
                                                  on_token)
        try:
            handle = rep.submit(prompt, max_new_tokens, eos_id=eos_id,
                                deadline_s=deadline_s, on_token=on_token,
                                trace_id=trace_id, temperature=temperature,
                                rng=rng, tenant=tenant)
        except AdmissionError as e:
            # per-request races (another thread filled the queue) and
            # too_long both surface here; re-raise with the router's
            # payload attached so every rejection is uniformly shaped
            self._reject(e.reason, trace_id, str(e),
                         retry_after_ms=self._retry_after_ms(loads),
                         queue_depth=fleet_depth, tenant=tenant)
        self._stamp_tenant_meta(handle._req, tenant)
        if self.tenancy is not None and tenant is not None:
            self.tenancy.on_admit(self.tenancy.resolve(tenant),
                                  handle._req, capped=capped)
        with self._lock:
            self._dispatched += 1
            self._dispatched_by[rep.name] += 1
            if match_len > 0:
                self._affinity_hits += 1
        obs.complete_event(
            "router/dispatch", t0_us, obs.now_us() - t0_us,
            cat="serving_request", trace_id=trace_id, replica=rep.name,
            prefix_match_len=match_len, fleet_queue_depth=fleet_depth)
        _flight.note("router", event="dispatched", trace_id=trace_id,
                     replica=rep.name, prefix_match_len=match_len)
        return handle

    def _retry_after_ms(self, loads) -> float:
        """Back-off hint from the MEASURED drain rate: the
        least-loaded replica's queued tokens priced at the fleet's
        recent tokens-per-second — clamped and jittered by
        ``derive_retry_after_ms`` so retrying clients back off
        proportionally to real congestion and never re-arrive as a
        synchronized herd."""
        backlog = min(ld["backlog_tokens"] for ld in loads)
        tokens_total = sum(rep.engine._tokens_emitted
                           for rep in self.replicas)
        return self._derive_retry_ms(backlog, tokens_total)

    # ---- driving ----
    def step(self) -> int:
        """ONE fleet scheduling round: step every replica that has
        work; returns how many did (0 == drained).  The deterministic
        single-thread driver; production runs
        :meth:`start` instead."""
        stepped = 0
        for rep in self.replicas:
            if not rep.idle:
                rep.step()
                stepped += 1
        return stepped

    def run(self, steps_budget: Optional[int] = None) -> int:
        """Drive :meth:`step` until the fleet drains or the budget
        runs out; returns rounds run."""
        n = 0
        while steps_budget is None or n < steps_budget:
            if self.step() == 0:
                break
            n += 1
        return n

    def start(self) -> None:
        for rep in self.replicas:
            rep.start()

    def stop(self) -> None:
        for rep in self.replicas:
            rep.stop()

    def close(self) -> None:
        for rep in self.replicas:
            rep.close()
        if _flight._PROVIDERS.get("router") == self.introspect_state:
            _flight.unregister_provider("router")

    def reset_stats(self) -> None:
        """Zero router counters AND every replica's rolling stats —
        call after warm-up so steady-state numbers don't absorb the
        one-off kernel builds."""
        with self._lock:
            self._dispatched = 0
            self._dispatched_by = {n: 0 for n in self._dispatched_by}
            self._rejected = {r: 0 for r in REJECT_REASONS}
            self._affinity_hits = 0
        for rep in self.replicas:
            rep.engine.reset_stats()

    # ---- metrics / introspection ----
    def metrics(self) -> Dict[str, float]:
        """Fleet summary + per-reason rejection counters (the
        ``/metricsz`` ``extra_gauges`` payload).  ``shed``/``rejected`` keys are lower-is-better under
        the regression gate's direction inference."""
        with self._lock:
            dispatched = self._dispatched
            rejected = dict(self._rejected)
            affinity = self._affinity_hits
        out: Dict[str, float] = {
            "router/replicas": float(len(self.replicas)),
            "router/dispatched_total": float(dispatched),
            "router/affinity_dispatches_total": float(affinity),
            "router/rejected_total": float(sum(rejected.values())),
        }
        for reason in REJECT_REASONS:
            out[f"router/rejected/{reason}"] = float(
                rejected.get(reason, 0))
        offered = dispatched + sum(rejected.values())
        out["router/shed_rate"] = (
            sum(rejected.values()) / offered if offered else 0.0)
        # fleet roll-ups from the engines' own metrics (one source of
        # truth); TTFT percentiles merge the replica reservoirs
        tps = occ = 0.0
        ttft_vals: List[float] = []
        for rep in self.replicas:
            m = rep.engine.metrics()
            tps += m["serving/tokens_per_sec"]
            occ += m["serving/slot_occupancy_pct"]
            ttft_vals.extend(rep.engine._ttft_ms.values())
            for k, v in m.items():
                out[f"router/{rep.name}/{k.split('/', 1)[1]}"] = v
        out["router/fleet_tokens_per_sec"] = tps
        out["router/fleet_slot_occupancy_pct"] = occ / len(self.replicas)
        if ttft_vals:
            from ..observability.slo import percentile_of
            out["router/fleet_ttft_p50_ms"] = percentile_of(ttft_vals, 50)
            out["router/fleet_ttft_p99_ms"] = percentile_of(ttft_vals, 99)
        if self.tenancy is not None:
            out.update(self.tenancy.metrics())
        return out

    def requests_table(self) -> Dict[str, Any]:
        """Merged /requestz payload: every replica's table, tagged."""
        tables = {rep.name: rep.engine.requests_table()
                  for rep in self.replicas}
        return {"schema": "chainermn_tpu.requestz.v1",
                "fleet": True, "replicas": tables}

    def introspect_state(self) -> Dict[str, Any]:
        """The ``router`` flight/statusz provider: dispatch + rejection
        counters and EVERY replica's ``introspect_state()`` — the
        fleet-wide "what is it doing right now"."""
        with self._lock:
            state: Dict[str, Any] = {
                "replicas": [rep.name for rep in self.replicas],
                "dispatched": self._dispatched,
                "dispatched_by": dict(self._dispatched_by),
                "rejected": dict(self._rejected),
                "affinity_dispatches": self._affinity_hits,
            }
        state["replica_state"] = {
            rep.name: rep.engine.introspect_state()
            for rep in self.replicas}
        if self.slo is not None:
            state["slo"] = self.slo.status()
        if self.tenancy is not None:
            state["tenancy"] = self.tenancy.state()
        return state

    def finalize_metrics(self) -> None:
        """Append the ``router_summary`` JSONL record (per-reason
        rejection counters ride the serving stream)."""
        if self.metrics_writer is not None:
            self.metrics_writer.write(self.metrics(),
                                      kind="router_summary")

    def write_prometheus(self, path: str) -> str:
        from ..observability.export import write_prometheus_textfile
        return write_prometheus_textfile(path, extra_gauges=self.metrics())


def build_fleet(params, n_replicas: int, *,
                slo: Optional[SLOTracker] = None,
                metrics_writer=None,
                shed_burn_threshold: float = 1.0,
                tenancy: Optional[TenantTable] = None,
                **engine_kwargs) -> ServingRouter:
    """Stand up N identically-configured replicas behind one router —
    the ``serve --replicas N`` CLI face.  The fleet SLO tracker is
    shared into every engine so all observations burn one budget;
    ``tenancy`` threads the multi-tenant QoS plane through the shed
    gate."""
    replicas = [
        Replica.build(params, f"replica{i}", slo=slo, **engine_kwargs)
        for i in range(int(n_replicas))]
    return ServingRouter(replicas, slo=slo,
                         shed_burn_threshold=shed_burn_threshold,
                         tenancy=tenancy,
                         metrics_writer=metrics_writer)
