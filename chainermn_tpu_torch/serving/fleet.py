"""Cross-process fleet router: dispatch, supervision, failover.

Counterpart of ``chainermn_tpu/serving/fleet.py``.  N
:class:`~chainermn_tpu_torch.serving.worker.WorkerRuntime` processes (or
in-process runtimes over the loopback store: the same protocol) behind one
router that owns three planes:

* **Dispatch**: ``submit()`` mirrors the request locally (the caller's
  :class:`~chainermn_tpu_torch.serving.frontend.RequestHandle` reads the
  mirror), picks the least-loaded live worker from its lease, and sends
  the request down the worker's control mailbox.  Tokens stream back as
  ``token`` messages; the terminal ``result`` message carries the
  authoritative token list.  Rejections ride the uniform
  :class:`~chainermn_tpu_torch.serving.scheduler.AdmissionError` wire
  shape (reason, ``retry_after_ms``, ``queue_depth``) through
  :class:`~chainermn_tpu_torch.serving.router.RouterBase`.  A local
  prefix-cache miss with a remote hit in the fleet cache index may become
  a priced pull of the slab from its owner (the KV economy,
  :meth:`FleetRouter._plan_pull`).
* **Supervision**: :meth:`FleetRouter.supervisor_tick` ages each worker's
  lease by receiver time, epoch-aware: a zombie's stale-epoch lease never
  refreshes liveness, it is refused and counted by the
  :class:`~chainermn_tpu_torch.serving.health.EpochFence`.  A worker whose
  current-epoch lease misses the detection window is marked dead: its
  epoch is fenced, a ``worker_lost`` flight bundle naming the worker and
  its lane is dumped, and its in-flight requests fail over.  Re-admission
  of a flapping worker is the per-worker
  :class:`~chainermn_tpu_torch.serving.health.CircuitBreaker`'s call.
* **Failover**: an in-flight request on a dead worker is re-dispatched to
  a survivor (a re-prefill; generation is deterministic per request key,
  so the result stays token-exact) up to ``max_failover_attempts``, else
  shed machine-readably with reason ``worker_lost``.  ``drain(worker)``
  is the graceful inverse: stop admitting, let the worker finish, collect
  ``drained``, and the process exits 0.

Disaggregated topologies ride the same plane: prompts go to prefill
workers, their ``slab_ready`` announcements route to the decode worker
with free (lease-reported) slots, and the ``install`` forward lands the
slab through the decode worker's own loop.

:func:`build_proc_fleet` spawns the workers as processes (each on the card
unless the caller passes ``device="cpu"``; the kernels are built once in
the parent before any worker starts), :func:`build_local_fleet` runs them
in this process over the loopback store, and :func:`rolling_upgrade`
installs a new weight generation worker by worker.  At ``tp > 1`` each
worker of a process fleet is a group of ``tp`` processes (see
``worker.py``): the spawned process is its leader, which starts the
followers; a :class:`WorkerClient`'s process and exit code are the
leader's, nonzero when any rank's was, and the lease, the mailboxes, the
epoch and its fence are the leader's alone.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import observability as obs
from ..communicators.base import DcnLaneError
from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability.slo import (GoodputLedger, ReservoirSample,
                                 SLOTracker, percentile_of)
from .fleet_cache import FleetCacheIndex
from .frontend import RequestHandle, _request_row
from .health import (CircuitBreaker, EpochFence, LeaseTable,
                     detection_window_s)
from .lanes import MailboxReceiver, MailboxSender
from .router import RouterBase
from .scheduler import AdmissionError, Request
from .transfer import slab_nbytes, transfer_cost
from .worker import SERVING_SOURCES, ctl_mailbox, group_backend, out_mailbox


def submit_with_retry(submit: Callable[..., Any], *args,
                      max_attempts: int = 4,
                      base_backoff_ms: float = 5.0,
                      max_backoff_ms: float = 2000.0,
                      jitter_frac: float = 0.25,
                      jitter_rng: Optional[random.Random] = None,
                      sleep: Callable[[float], None] = time.sleep,
                      **kwargs):
    """Client-side honor of ``retry_after_ms``:
    call ``submit(*args, **kwargs)``; on :class:`AdmissionError` wait
    ``max(retry_after_ms, base_backoff_ms · 2^(attempt-1))`` (capped)
    with ±``jitter_frac`` uniform jitter — jitter prevents a shed burst
    from re-arriving as a synchronized thundering herd — and retry up
    to ``max_attempts`` total submits.  Gives up MACHINE-READABLY by
    re-raising the last :class:`AdmissionError` (its payload still
    carries reason/retry_after_ms/queue_depth).  Returns the handle on
    success.  ``**kwargs`` (incl. a sampling ``rng=``) pass through to
    ``submit`` untouched — the jitter source is ``jitter_rng``."""
    jitter_rng = jitter_rng or random.Random()
    attempt = 0
    while True:
        attempt += 1
        try:
            return submit(*args, **kwargs)
        except AdmissionError as e:
            if attempt >= int(max_attempts):
                raise
            backoff = min(base_backoff_ms * (2 ** (attempt - 1)),
                          max_backoff_ms)
            delay_ms = max(e.retry_after_ms or 0.0, backoff)
            delay_ms = min(delay_ms, max_backoff_ms)
            delay_ms *= 1.0 + jitter_frac * (2.0 * jitter_rng.random()
                                             - 1.0)
            sleep(max(delay_ms, 0.0) / 1e3)


class WorkerClient:
    """Router-side proxy of one worker: its mailboxes, lease view,
    breaker, and in-flight registry.  ``proc`` is the Popen when the
    worker is a real process (None for in-process runtimes)."""

    STATES = ("starting", "live", "draining", "drained", "dead")

    def __init__(self, name: str, role: str, store, *, epoch: int = 1,
                 lane_config=None, proc=None, breaker=None,
                 model_id: str = "default"):
        self.name = str(name)
        self.role = str(role)
        self.epoch = int(epoch)
        # heterogeneous-fleet identity: seeded at admission,
        # then ADOPTED from every admitted lease — the worker's claim
        # on the fenced wire outranks the router's construction-time
        # guess (same discipline as queue depth)
        self.model_id = str(model_id)
        self.weights_generation = 1
        self.sender = MailboxSender(store, ctl_mailbox(name), lane_config)
        self.receiver = MailboxReceiver(store, out_mailbox(name),
                                        lane_config)
        self.proc = proc
        self.breaker = breaker or CircuitBreaker()
        self.state = "starting"
        self.t_admitted = time.monotonic()
        # epoch-aware lease aging: (seq, t_seen) of the last NEW
        # current-epoch lease — a zombie's stale-epoch beats never land
        self.last_lease: Optional[Dict[str, Any]] = None
        self._lease_seq = -1
        self._lease_t = time.monotonic()
        self.sent_since_lease = 0      # dispatch-vs-stale-lease slack
        #: last lease seq the supervisor JUDGED (accepted or refused) —
        #: a persisting stale lease file is processed exactly once
        self.judged_seq = -1

    def observe_lease(self, lease: Dict[str, Any]) -> None:
        if int(lease["seq"]) != self._lease_seq:
            self._lease_seq = int(lease["seq"])
            self._lease_t = time.monotonic()
            self.last_lease = lease
            self.sent_since_lease = 0
            if lease.get("model_id"):
                self.model_id = str(lease["model_id"])
            if lease.get("weights_generation"):
                self.weights_generation = int(
                    lease["weights_generation"])

    def lease_age_s(self) -> float:
        """Seconds since the last NEW current-epoch lease (or since
        admission, before the first one)."""
        return time.monotonic() - self._lease_t

    def reset_lease_clock(self) -> None:
        self._lease_seq = -1
        self._lease_t = time.monotonic()
        self.last_lease = None


class FleetRouter(RouterBase):
    """Supervision + dispatch over cross-process workers.

    ``lease_window_s`` defaults to
    :func:`~chainermn_tpu.serving.health.detection_window_s`
    (``beat_interval_s``, ``miss_beats``) — the worst-case detection
    latency the chaos acceptance holds the router to.
    """

    ROLE = "fleet"

    def __init__(self, workers: Sequence[WorkerClient], store, *,
                 beat_interval_s: float = 0.05, miss_beats: int = 4,
                 lease_window_s: Optional[float] = None,
                 start_grace_s: float = 60.0,
                 max_failover_attempts: int = 2,
                 default_token_latency_ms: float = 20.0,
                 slo: Optional[SLOTracker] = None,
                 shed_burn_threshold: float = 1.0,
                 tenancy=None,
                 paid_burn_headroom: float = 2.0,
                 metrics_writer=None,
                 bundle_dir: Optional[str] = None,
                 lane_config=None,
                 stats_capacity: int = 1024,
                 enable_remote_pulls: bool = True,
                 pull_min_tokens: int = 4,
                 pull_cost_per_token: float = 0.25,
                 pull_timeout_s: float = 30.0,
                 orphan_sweep_interval_s: float = 1.0,
                 orphan_grace_s: float = 5.0):
        if not workers:
            raise ValueError("need at least one worker")
        names = [w.name for w in workers]
        if len(set(names)) != len(names):
            raise ValueError(f"worker names must be unique: {names}")
        super().__init__(
            metrics_writer=metrics_writer, tenancy=tenancy, slo=slo,
            shed_burn_threshold=shed_burn_threshold,
            paid_burn_headroom=paid_burn_headroom,
            default_token_latency_ms=default_token_latency_ms)
        self.workers: Dict[str, WorkerClient] = {w.name: w
                                                for w in workers}
        self.store = store
        self.beat_interval_s = float(beat_interval_s)
        self.lease_window_s = (
            detection_window_s(beat_interval_s, miss_beats)
            if lease_window_s is None else float(lease_window_s))
        self.start_grace_s = float(start_grace_s)
        self.max_failover_attempts = int(max_failover_attempts)
        self.bundle_dir = bundle_dir
        #: attached by serving.autoscale.FleetAutoscaler: step() then
        #: drives its control loop, metrics() carries its counters and the
        #: fleet_health provider its view
        self.autoscaler = None
        #: the workers' model groups: width and process-group backend
        #: (``build_proc_fleet`` sets them; one rank a worker otherwise)
        self.group: Dict[str, Any] = {"tp": 1, "backend": None}
        #: a process fleet's spawn settings (``build_proc_fleet``), which
        #: :func:`rolling_upgrade` spawns its replacements with
        self.spawn: Optional[Dict[str, Any]] = None
        self.lane_config = lane_config
        self.fence = EpochFence()
        # the health.py read face: schema-checks every lease payload
        self._leases = LeaseTable(store, lane_config)
        self._last_supervise = 0.0
        # fleet-global KV economy: the soft-state prefix
        # index workers announce into, and the remote-pull pricing
        # knobs — a pull is chosen only when the prefill tokens it
        # saves beat its transfer price in the SAME token currency as
        # the affinity score (pull_cost_per_token = moving one token's
        # KV over the lane, priced relative to re-prefilling it)
        self.cache_index = FleetCacheIndex()
        self.enable_remote_pulls = bool(enable_remote_pulls)
        self.pull_min_tokens = int(pull_min_tokens)
        self.pull_cost_per_token = float(pull_cost_per_token)
        self.pull_timeout_s = float(pull_timeout_s)
        self._remote_pulls = 0
        self.last_pull_fault: Optional[Dict[str, Any]] = None
        # orphaned-slab sweep: a worker that died
        # between pack-publish and install-ack leaks its lane tag
        # forever without this — tags unowned by any in-flight request
        # for a full grace window are GC'd
        self.orphan_sweep_interval_s = float(orphan_sweep_interval_s)
        self.orphan_grace_s = float(orphan_grace_s)
        self._orphan_seen: Dict[str, float] = {}
        self._last_orphan_sweep = 0.0
        self._orphans_swept = 0
        for w in workers:
            # adopt the worker's pre-agreed first epoch (argv-passed)
            while (self.fence.current(w.name) or 0) < w.epoch:
                self.fence.new_epoch(w.name)
        # in-flight registry: trace_id -> {"req", "worker", "attempts"}
        self._inflight: Dict[str, Dict[str, Any]] = {}
        self._pending_slabs: deque = deque()   # disagg installs awaiting
        self._rr = 0
        self._dispatched = 0
        self._redispatched = 0
        self._shed_inflight = 0
        self._readmitted = 0
        self._tokens = 0
        self._results = 0
        self._t0 = time.monotonic()
        self._ttft_ms = ReservoirSample(int(stats_capacity))
        self._failover_ttft_ms = ReservoirSample(int(stats_capacity))
        self.last_detection: Optional[Dict[str, Any]] = None
        # supervision-plane wall partition
        self.goodput = GoodputLedger()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: set to the error string when the started router thread died
        #: — submit() then rejects machine-readably instead of
        #: accepting requests nobody will ever pump
        self._router_dead: Optional[str] = None
        _flight.register_provider("fleet_health", self.introspect_state)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _submit_role(self) -> str:
        roles = {w.role for w in self.workers.values()}
        return "prefill" if "engine" not in roles else "engine"

    def _live(self, role: Optional[str] = None) -> List[WorkerClient]:
        # snapshot: the autoscaler's add_worker mutates the dict on the
        # router thread while submit threads iterate here
        return [w for w in list(self.workers.values())
                if w.state in ("starting", "live")
                and (role is None or w.role == role)]

    def _retry_after_ms(self) -> float:
        """Drain-aware back-off hint: the least-loaded live
        worker's queued tokens priced at the fleet's MEASURED recent
        tokens/s (clamped + jittered in ``derive_retry_after_ms``)."""
        live = self._live()
        if not live:
            return 1.0
        backlog = min(
            int((w.last_lease or {}).get("backlog_tokens", 0))
            for w in live)
        with self._lock:
            tokens = self._tokens
        return self._derive_retry_ms(backlog, tokens)

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token=None, temperature: float = 0.0,
               rng=None, tenant: Optional[str] = None,
               priority: Optional[str] = None,
               model_id: Optional[str] = None) -> RequestHandle:
        """Dispatch to the least-loaded live worker over its lane, or
        raise :class:`AdmissionError` with the uniform machine-readable
        payload.  ``tenant``/``priority`` bill the request to a tenant
        class: budgets, ladder clamping, and paid-first SLO
        protection key off them.  ``model_id`` pins the variant in a
        heterogeneous fleet: only workers serving it are
        candidates (and failover targets); None routes across ALL
        variants (the single-model fleet's behavior, unchanged)."""
        import numpy as np

        trace_id = self._mint_trace_id()
        temperature = float(temperature)
        if temperature > 0.0 and rng is None:
            raise ValueError(
                "temperature > 0 samples tokens and needs an explicit "
                "rng: pass prng.PRNGKey(...) (the lm_generate "
                "contract)")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if self._router_dead is not None:
            self._reject(
                "worker_lost", trace_id,
                f"fleet router thread died: {self._router_dead}",
                retry_after_ms=1.0, queue_depth=0)
        role = self._submit_role()
        live = self._live(role)
        if model_id is not None:
            live = [w for w in live if w.model_id == model_id]
        if not live:
            self._reject(
                "worker_lost" if model_id is None else "no_model_worker",
                trace_id,
                f"no live {role} worker in the fleet "
                + (f"serving model {model_id!r} "
                   if model_id is not None else "")
                + f"({len(self.workers)} registered)",
                retry_after_ms=1.0, queue_depth=0)
        depth_of = {}
        backlog_of = {}
        fleet_cap = 0
        for w in live:
            lease = w.last_lease or {}
            depth_of[w.name] = (int(lease.get("queue_depth", 0))
                                + w.sent_since_lease)
            backlog_of[w.name] = int(lease.get("backlog_tokens", 0))
            fleet_cap += int(lease.get("queue_capacity", 0))
        candidates = [
            w for w in live
            if depth_of[w.name] < int((w.last_lease or {}).get(
                "queue_capacity", 1 << 30))]
        fleet_depth = sum(depth_of.values())
        # tenant plane + the shared SLO-burn gate: budgets
        # and the pause rung refuse best-effort work with tenant+rung
        # attribution; the burn gate sheds best-effort at the base
        # threshold and paid only with paid_burn_headroom× more room
        tenant, max_new_tokens, capped = self._admit_tenant(
            trace_id, tenant, priority, max_new_tokens,
            queue_depth=fleet_depth, queue_capacity=fleet_cap,
            retry_after_ms=self._retry_after_ms)
        self._maybe_shed_slo(trace_id, fleet_depth,
                             self._retry_after_ms, tenant)
        if not candidates:
            self._reject(
                "queue_full", trace_id,
                f"all {len(live)} live {role}-worker queues at capacity",
                retry_after_ms=self._retry_after_ms(),
                queue_depth=fleet_depth, tenant=tenant)
        # least-loaded in TOKEN units: queue depth first
        # (requests are the admission currency), then the lease's
        # backlog_tokens (variants differ in per-request work — a small
        # model's worker drains its depth faster), then round-robin
        order = sorted(
            range(len(candidates)),
            key=lambda i: (depth_of[candidates[i].name],
                           backlog_of[candidates[i].name],
                           (i - self._rr) % len(candidates)))
        wc = candidates[order[0]]
        self._rr = (self._rr + 1) % max(len(candidates), 1)

        now = time.monotonic()
        key = (None if rng is None
               else np.asarray(rng, np.uint32).reshape(2))
        req = Request(prompt, max_new_tokens, eos_id=eos_id,
                      deadline_t=(now + deadline_s
                                  if deadline_s is not None else None),
                      on_token=on_token, trace_id=trace_id,
                      temperature=temperature, rng=key, tenant=tenant)
        req.status = "running"   # mirror: the worker owns queueing
        req.timestamps["submitted"] = now
        self._stamp_tenant_meta(req, tenant)
        entry = {"req": req, "worker": wc.name, "attempts": 1,
                 "model_id": wc.model_id}
        # fleet KV economy: a local miss with a remote hit
        # may be worth PULLING the prefix slab instead of re-prefilling
        # — decided here, in token units, before anything is sent
        pull = self._plan_pull(wc, prompt, trace_id)
        if pull is not None:
            entry["pull"] = dict(pull, attempts=1, state="requested",
                                 t0=now)
        with self._lock:
            # registration and the death handler's strand snapshot
            # share this lock, so every accepted request is either in
            # that snapshot (and shed) or refused here — none slips
            # through to hang
            dead = self._router_dead
            if dead is None:
                self._inflight[trace_id] = entry
                self._dispatched += 1
                # locked with its peers: submit threads, the supervisor
                # (failover, lease reset) all read-modify-write this
                wc.sent_since_lease += 1
        if dead is not None:
            self._reject(
                "worker_lost", trace_id,
                f"fleet router thread died: {dead}",
                retry_after_ms=1.0, queue_depth=0, tenant=tenant)
        # the registration event anchors the request's causal story
        #: every accepted entry journals exactly one
        # "submitted" before any dispatch/pull/failover touches it
        _flight.note("fleet", event="submitted", trace_id=trace_id,
                     worker=wc.name, tenant=tenant)
        if pull is not None:
            # the pull path holds the submit back until the prefix
            # lands (or the pull degrades): the owner packs the slab,
            # the destination installs it into its own prefix cache,
            # and only then does the request dispatch — so its
            # admission is a plain local hit, never a re-prefill race
            owner_wc = self.workers.get(pull["owner"])
            try:
                self._send_cache_pull(owner_wc, req, pull)
            except Exception as e:  # noqa: BLE001 — a broken OWNER
                # lane must not reject the caller: degrade to plain
                # dispatch on the chosen worker, counted.  Pop-or-bail:
                # a supervisor running _cancel_pulls_on between the
                # registration and this send may have ALREADY resolved
                # the pull and dispatched the request — re-sending here
                # would run the same trace twice on the worker
                with self._lock:
                    owned_pull = entry.pop("pull", None)
                if owned_pull is None:
                    _flight.note("fleet",
                                 event="pull_send_superseded",
                                 trace_id=trace_id, error=str(e))
                    if self.tenancy is not None and tenant is not None:
                        self.tenancy.on_admit(
                            self.tenancy.resolve(tenant), req,
                            capped=capped)
                    obs.async_event("b", "request", trace_id,
                                    cat="serving_request",
                                    request=req.id,
                                    prompt_len=req.prompt_len)
                    return RequestHandle(req)
                self.cache_index.count_stale("owner_lane")
                _flight.note("fleet", event="remote_pull_fallback",
                             trace_id=trace_id, reason="owner_lane",
                             owner=pull["owner"], error=str(e))
                pull = None
            else:
                _flight.note("fleet", event="remote_pull_requested",
                             trace_id=trace_id, owner=pull["owner"],
                             dst=wc.name, prefix_len=pull["length"],
                             gain_tokens=pull["gain"],
                             price_tokens=round(pull["price_tokens"], 2),
                             ledger_bytes=pull["ledger_bytes"])
                if self.tenancy is not None and tenant is not None:
                    self.tenancy.on_admit(self.tenancy.resolve(tenant),
                                          req, capped=capped)
                obs.async_event("b", "request", trace_id,
                                cat="serving_request", request=req.id,
                                prompt_len=req.prompt_len)
                return RequestHandle(req)
        try:
            self._send_submit(wc, req)
        except Exception as e:  # noqa: BLE001 — no half-registered state
            with self._lock:
                # roll back ONLY while we still own the entry: a long
                # retrying send can lose the race to the supervisor's
                # orphan sweep, which may have already failed the entry
                # over to a survivor (or shed it) — popping it then
                # would orphan the redispatched request's result
                cur = self._inflight.get(trace_id)
                owned = (cur is entry and entry["attempts"] == 1
                         and entry["worker"] == wc.name)
                if owned:
                    self._inflight.pop(trace_id, None)
                    # never dispatched: rolling both back keeps the
                    # offered count (dispatched + rejected) at one per
                    # request and the worker's estimated depth honest
                    self._dispatched -= 1
                    wc.sent_since_lease = max(
                        wc.sent_since_lease - 1, 0)
            if not owned:
                _flight.note("fleet", event="submit_send_superseded",
                             trace_id=trace_id, error=str(e))
                if self.tenancy is not None and tenant is not None:
                    self.tenancy.on_admit(self.tenancy.resolve(tenant),
                                          req, capped=capped)
                return RequestHandle(req)
            if isinstance(e, DcnLaneError):
                # the uniform machine-readable rejection instead of a
                # raw lane fault: the caller can submit_with_retry it
                # (tenant attribution rides like every other reject)
                self._reject(
                    "worker_lost", trace_id,
                    f"control-lane send to worker {wc.name} failed "
                    f"permanently: {e}",
                    retry_after_ms=self._retry_after_ms(),
                    queue_depth=fleet_depth, tenant=tenant)
            raise
        # tracked only once the send stuck (a rejected submit must not
        # occupy the tenant's inflight budget with a phantom forever)
        if self.tenancy is not None and tenant is not None:
            self.tenancy.on_admit(self.tenancy.resolve(tenant), req,
                                  capped=capped)
        obs.async_event("b", "request", trace_id, cat="serving_request",
                        request=req.id, prompt_len=req.prompt_len)
        _flight.note("fleet", event="dispatched", trace_id=trace_id,
                     worker=wc.name)
        return RequestHandle(req)

    def _wire(self, req: Request) -> Dict[str, Any]:
        import numpy as np

        now = time.monotonic()
        return {
            "trace_id": req.trace_id,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": req.eos_id,
            "deadline_rel_s": (None if req.deadline_t is None
                               else max(req.deadline_t - now, 0.0)),
            "temperature": float(req.temperature),
            "rng": (None if req.rng is None
                    else [int(x) for x in np.asarray(req.rng)
                          .reshape(2)]),
            "tenant": req.tenant,
        }

    def _send_submit(self, wc: WorkerClient, req: Request) -> None:
        wc.sender.send({"kind": "submit", "epoch": wc.epoch,
                        "req": self._wire(req)})

    # ------------------------------------------------------------------
    # fleet KV economy: remote prefix pulls
    # ------------------------------------------------------------------
    def _plan_pull(self, wc: WorkerClient, prompt,
                   trace_id: str) -> Optional[Dict[str, Any]]:
        """Transfer-vs-re-prefill decision, in token units.  The gain
        is the prefill tokens a pull saves (remote match beyond the
        local match); the price is the transfer's wire cost converted
        through ``pull_cost_per_token`` (what moving one token's KV
        over the lane costs relative to recomputing it) via the SAME
        ``transfer_cost`` statics the ledger reconciles against.
        Returns the pull plan, or None for plain dispatch."""
        if not self.enable_remote_pulls or wc.role != "engine":
            return None
        # model-keyed claims: only same-variant slabs are
        # candidates — the index counts the cross-model near-miss
        # under stale_fallbacks/model_mismatch
        live = {w.name for w in self._live("engine")
                if w.model_id == wc.model_id}
        rec, best_len = self.cache_index.match(prompt, workers=live,
                                               model_id=wc.model_id)
        if rec is None:
            return None
        local_len = self.cache_index.match_for(wc.name, prompt)
        if rec.worker == wc.name or best_len <= local_len:
            return None     # the local cache is already as good
        gain = best_len - local_len
        geom = rec.geom or {}
        # slab-geometry key, belt to the model_id braces: a claim whose
        # layer/kv/dtype shape disagrees with the DESTINATION's lease
        # geometry would install garbage — counted, refused, re-prefill
        dst_geom = (wc.last_lease or {}).get("geom")
        if geom and dst_geom and any(
                geom.get(k) != dst_geom.get(k)
                for k in ("n_layers", "kv_dim", "dtype")):
            self.cache_index.count_stale("geometry_mismatch")
            return None
        ledger_bytes = None
        if geom:
            cost = transfer_cost(geom["n_layers"], best_len,
                                 geom["kv_dim"], geom["dtype"],
                                 mode="lanes")
            ledger_bytes = cost["ledger_bytes"]
            per_token = max(slab_nbytes(geom["n_layers"], 1,
                                        geom["kv_dim"], geom["dtype"]),
                            1)
            price_tokens = (self.pull_cost_per_token
                            * ledger_bytes / per_token)
        else:
            # geometry never announced (old worker): price by rows
            price_tokens = self.pull_cost_per_token * best_len
        if gain < self.pull_min_tokens or gain <= price_tokens:
            return None
        return {"owner": rec.worker,
                "seq": [int(t) for t in prompt[:best_len]],
                # the index record's own key: a stale nack must drop
                # the CLAIM that matched, not the (shorter) pull prefix
                "rec_seq": list(rec.seq),
                "length": int(best_len), "local_len": int(local_len),
                "gain": int(gain), "price_tokens": float(price_tokens),
                "ledger_bytes": ledger_bytes,
                "tag": f"pfx/{trace_id}"}

    def _send_cache_pull(self, owner_wc: WorkerClient, req: Request,
                         pull: Dict[str, Any]) -> None:
        if owner_wc is None or owner_wc.state not in ("starting", "live"):
            raise RuntimeError(
                f"slab owner {pull['owner']} is not live")
        owner_wc.sender.send({"kind": "cache_pull",
                              "epoch": owner_wc.epoch,
                              "trace_id": req.trace_id,
                              "prefix": pull["seq"],
                              "length": pull["length"],
                              "tag": pull["tag"]})

    def _pull_fallback(self, entry: Dict[str, Any], reason: str,
                       detail: str, *, lane=None, worker=None,
                       fault: bool = False) -> None:
        """The counted degrade-to-re-prefill path — every way a pull
        can fail funnels here: pop the pull, count per reason, dump a
        ``remote_pull_fault`` bundle naming worker+lane on the fault
        reasons, GC the slab tag, and dispatch the request normally to
        its already-chosen worker (failover owns it from there if even
        that fails).  Done-XOR-shed holds throughout: the entry never
        leaves ``_inflight`` here."""
        req = entry["req"]
        with self._lock:
            pull = entry.pop("pull", None)
        if pull is None:
            return    # already resolved (installed, or raced a failover)
        self.cache_index.count_stale(reason)
        _flight.note("fleet", event="remote_pull_fallback",
                     trace_id=req.trace_id, reason=reason,
                     detail=detail,
                     **({"worker": worker} if worker else {}),
                     **({"lane": lane} if lane else {}))
        if fault:
            detection = {"trace_id": req.trace_id, "reason": reason,
                         "detail": detail, "worker": worker,
                         "lane": lane, "owner": pull["owner"],
                         "dst": entry["worker"],
                         "prefix_len": pull["length"]}
            self.last_pull_fault = detection
            _flight.note("fleet", event="remote_pull_fault", **detection)
            if self.bundle_dir:
                _flight.dump_bundle(
                    self.bundle_dir, "remote_pull_fault",
                    extra={"remote_pull_fault": detection})
        self._gc_slab(pull["tag"])
        wc = self.workers.get(entry["worker"])
        if wc is not None and wc.state in ("starting", "live"):
            try:
                self._send_submit(wc, req)
                _flight.note("fleet", event="dispatched",
                             trace_id=req.trace_id, worker=wc.name,
                             after_pull_fallback=reason)
                return
            except Exception as e:  # noqa: BLE001
                detail = (f"{detail}; fallback submit to {wc.name} "
                          f"failed: {e}")
        self._failover(entry, f"remote pull fell back ({reason}): "
                              f"{detail}")

    def _cancel_pulls_on(self, worker: str, why: str,
                         fault: bool = True) -> None:
        """A dead/drained worker can never serve its pending pulls:
        resolve every in-flight pull it owns to the counted fallback
        (the mid-pull owner-death failure domain — chaos-proven by
        SIGKILLing the slab owner)."""
        with self._lock:
            affected = [e for e in self._inflight.values()
                        if e.get("pull") is not None
                        and e["pull"]["owner"] == worker]
        for entry in affected:
            self._pull_fallback(
                entry, "owner_lost", f"slab owner {worker} {why}",
                worker=worker,
                lane=f"worker_lane/{out_mailbox(worker)}/recv",
                fault=fault)

    def _check_pull_deadlines(self, now: float) -> None:
        """Backstop: a pull neither completed nor failed within
        ``pull_timeout_s`` (e.g. a silently wedged owner the lease
        window has not caught yet) degrades instead of wedging the
        request forever."""
        with self._lock:
            stuck = [e for e in self._inflight.values()
                     if e.get("pull") is not None
                     and now - e["pull"]["t0"] > self.pull_timeout_s]
        for entry in stuck:
            self._pull_fallback(
                entry, "timeout",
                f"pull did not complete within {self.pull_timeout_s}s")

    def _on_cache_announce(self, wc: WorkerClient,
                           msg: Dict[str, Any]) -> None:
        op = str(msg.get("op"))
        if op == "insert":
            self.cache_index.insert(wc.name, wc.epoch, msg["prefix"],
                                    msg["length"],
                                    geom=msg.get("geom"))
        elif op == "evict":
            if msg.get("spilled"):
                # device slot scavenged but the slab spilled to host
                # RAM: still pullable, just from the colder tier
                self.cache_index.demote(wc.name, msg["prefix"])
            else:
                # tier-scoped when the announce says so (a spill-store
                # eviction must not drop a re-donated HOT claim)
                self.cache_index.evict(wc.name, msg["prefix"],
                                       tier=msg.get("tier"))
        elif op == "snapshot":
            self.cache_index.snapshot(wc.name, wc.epoch,
                                      msg.get("entries") or [],
                                      geom=msg.get("geom"))
        else:
            _flight.note("fleet", event="unknown_cache_announce",
                         worker=wc.name, op=op)

    def _live_pull(self, entry, wc_name: Optional[str] = None,
                   owner: Optional[str] = None):
        """The entry's pull iff it is still the CURRENT attempt's (a
        failover since the request left supersedes every pull message
        still in flight)."""
        if entry is None:
            return None
        pull = entry.get("pull")
        if pull is None or pull["attempts"] != entry["attempts"]:
            return None
        if owner is not None and pull["owner"] != owner:
            return None
        if wc_name is not None and entry["worker"] != wc_name:
            return None
        return pull

    def _on_cache_slab_ready(self, wc: WorkerClient,
                             msg: Dict[str, Any]) -> None:
        entry = self._entry(msg.get("trace_id"))
        pull = self._live_pull(entry, owner=wc.name)
        if pull is None or pull.get("state") != "requested":
            self._gc_slab(msg.get("tag"))
            return
        pull["state"] = "installing"
        dst = self.workers.get(entry["worker"])
        if dst is None or dst.state not in ("starting", "live"):
            # the destination died since; its failover owns the request
            self._gc_slab(msg.get("tag"))
            return
        try:
            dst.sender.send({"kind": "install_prefix",
                             "epoch": dst.epoch,
                             "trace_id": msg["trace_id"],
                             "tag": msg["tag"],
                             "length": msg.get("length")})
        except Exception as e:  # noqa: BLE001
            self._pull_fallback(
                entry, "dst_lane",
                f"install_prefix send to {dst.name} failed: {e}",
                worker=dst.name,
                lane=f"worker_lane/{ctl_mailbox(dst.name)}/send",
                fault=isinstance(e, DcnLaneError))

    def _on_cache_pull_nack(self, wc: WorkerClient,
                            msg: Dict[str, Any]) -> None:
        entry = self._entry(msg.get("trace_id"))
        pull = self._live_pull(entry, owner=wc.name)
        if pull is None:
            self._gc_slab(msg.get("tag"))
            return
        reason = str(msg.get("reason"))
        if reason == "stale":
            # evicted since the announce: drop the claim so the next
            # submit does not re-plan the same dead pull
            self.cache_index.evict(wc.name,
                                   pull.get("rec_seq") or pull["seq"])
        self._pull_fallback(
            entry, reason,
            f"owner {wc.name} nacked the pull: {reason}",
            worker=wc.name, lane=msg.get("lane"),
            fault=(reason == "publish_fault"))

    def _on_prefix_installed(self, wc: WorkerClient,
                             msg: Dict[str, Any]) -> None:
        entry = self._entry(msg.get("trace_id"))
        pull = self._live_pull(entry, wc_name=wc.name)
        if pull is None:
            return
        with self._lock:
            entry.pop("pull", None)
            self._remote_pulls += 1
        req = entry["req"]
        _flight.note("fleet", event="remote_pull_done",
                     trace_id=req.trace_id, owner=pull["owner"],
                     dst=wc.name, prefix_len=pull["length"],
                     pull_ms=round((time.monotonic() - pull["t0"]) * 1e3,
                                   2))
        try:
            self._send_submit(wc, req)
        except Exception as e:  # noqa: BLE001
            self._failover(entry, f"submit after remote pull to "
                                  f"{wc.name} failed: {e}")

    def _on_prefix_nack(self, wc: WorkerClient,
                        msg: Dict[str, Any]) -> None:
        entry = self._entry(msg.get("trace_id"))
        pull = self._live_pull(entry, wc_name=wc.name)
        if pull is None:
            self._gc_slab(msg.get("tag"))
            return
        reason = str(msg.get("reason"))
        self._pull_fallback(
            entry, reason,
            f"destination {wc.name} could not land the prefix slab: "
            f"{reason}",
            worker=wc.name, lane=msg.get("lane"),
            fault=(reason == "lane_fault"))

    # ------------------------------------------------------------------
    # pump: worker -> router messages
    # ------------------------------------------------------------------
    def pump(self) -> int:
        """Drain every worker's outbox; returns messages handled.
        Every message is fence-gated: a stale epoch (zombie, or a
        fenced worker's buffered sends) is refused and counted — the
        zombie-fencing acceptance."""
        handled = 0
        for wc in list(self.workers.values()):
            for msg in wc.receiver.drain():
                handled += 1
                kind = str(msg.get("kind"))
                if kind == "drained":
                    # always honored: the drain handshake ends the
                    # worker's life, fenced or not
                    self._on_drained(wc)
                    continue
                if not self.fence.admit(wc.name, msg.get("epoch", -1),
                                        kind):
                    _flight.note("fleet", event="fenced_refusal",
                                 worker=wc.name, msg_kind=kind,
                                 msg_epoch=msg.get("epoch"))
                    continue
                if kind == "token":
                    self._on_token(msg)
                elif kind == "result":
                    self._on_result(wc, msg)
                elif kind == "shed":
                    self._on_shed(wc, msg)
                elif kind == "slab_ready":
                    entry = self._entry(msg.get("trace_id"))
                    if entry is None:
                        self._gc_slab(msg.get("tag"))
                    else:
                        entry["slab_src"] = wc.name
                        self._pending_slabs.append(
                            {"msg": msg, "src": wc.name,
                             "attempts": entry["attempts"]})
                elif kind == "install_ok":
                    pass   # ownership already moved at forward time
                elif kind == "install_nack":
                    self._on_install_nack(wc, msg)
                elif kind == "cache_announce":
                    self._on_cache_announce(wc, msg)
                elif kind == "cache_slab_ready":
                    self._on_cache_slab_ready(wc, msg)
                elif kind == "cache_pull_nack":
                    self._on_cache_pull_nack(wc, msg)
                elif kind == "prefix_installed":
                    self._on_prefix_installed(wc, msg)
                elif kind == "prefix_nack":
                    self._on_prefix_nack(wc, msg)
                else:
                    _flight.note("fleet", event="unknown_msg",
                                 worker=wc.name, msg_kind=kind)
        self._route_pending_slabs()
        return handled

    def _entry(self, trace_id) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._inflight.get(trace_id)

    def _on_token(self, msg: Dict[str, Any]) -> None:
        entry = self._entry(msg.get("trace_id"))
        if entry is None or entry["worker"] != msg.get("worker"):
            return   # late stream from a superseded dispatch
        req = entry["req"]
        tok = int(msg["token"])
        req.tokens.append(tok)
        now = time.monotonic()
        if "first_token" not in req.timestamps:
            req.timestamps["first_token"] = now
            ttft = (now - req.timestamps.get("submitted", now)) * 1e3
            with self._lock:
                self._ttft_ms.add(ttft)
                if entry["attempts"] > 1:
                    self._failover_ttft_ms.add(ttft)
            if self.slo is not None:
                self.slo.observe_ttft(ttft)
            if self.tenancy is not None:
                self.tenancy.on_ttft(req.tenant, ttft)
        with self._lock:
            self._tokens += 1
        if req.on_token is not None:
            req.on_token(tok, req.id)

    def _on_result(self, wc: WorkerClient, msg: Dict[str, Any]) -> None:
        trace_id = msg.get("trace_id")
        entry = self._entry(trace_id)
        if entry is None or entry["worker"] != wc.name:
            _flight.note("fleet", event="orphan_result", worker=wc.name,
                         trace_id=trace_id)
            return
        req = entry["req"]
        now = time.monotonic()
        # the result's token list is AUTHORITATIVE (streamed tokens are
        # hints that may trail it by a message or two)
        req.tokens = [int(t) for t in msg.get("tokens", [])]
        if req.tokens and "first_token" not in req.timestamps:
            req.timestamps["first_token"] = now
        req.finish(msg.get("finish_reason") or "max_tokens", now)
        if self.tenancy is not None:
            # the authoritative token list bills the tenant (streamed
            # token messages are latency hints that may trail it)
            self.tenancy.on_tokens(req.tenant, len(req.tokens))
        with self._lock:
            self._inflight.pop(trace_id, None)
            self._results += 1
        obs.async_event("e", "request", trace_id, cat="serving_request",
                        reason=req.finish_reason,
                        n_tokens=len(req.tokens))
        _flight.note("fleet", event="finished", trace_id=trace_id,
                     worker=wc.name, reason=req.finish_reason)

    def _on_shed(self, wc: WorkerClient, msg: Dict[str, Any]) -> None:
        """The worker refused an already-dispatched request (admission
        race, drain overlap, prefill error): fail it over like a death
        would, bounded by the same attempt budget."""
        entry = self._entry(msg.get("trace_id"))
        if entry is None or entry["worker"] != wc.name:
            return
        self._failover(entry, f"worker {wc.name} shed: "
                              f"{msg.get('payload', {}).get('reason')}")

    # ---- disagg: slab routing ----
    def _gc_slab(self, tag) -> None:
        """Best-effort GC of an orphaned slab tag (shed / superseded by
        a failover re-prefill) so it never sits in the lane store
        forever; a delete fault must not hurt the router."""
        if not tag:
            return
        try:
            self.store.delete(tag)
        except Exception:  # noqa: BLE001
            pass

    def _route_pending_slabs(self) -> None:
        """Forward announced slabs to decode workers with free
        (lease-reported) slots; slabs with no destination stay pending
        (slots free up — the supervisor tick retries)."""
        still: deque = deque()
        while self._pending_slabs:
            item = self._pending_slabs.popleft()
            msg = item["msg"]
            entry = self._entry(msg.get("trace_id"))
            if entry is None or entry["attempts"] != item["attempts"]:
                # shed, or failed over SINCE the announce: the request
                # was re-dispatched (a fresh re-prefill will produce its
                # own slab) — forwarding this one would install a
                # DUPLICATE generation for the same trace
                self._gc_slab(msg.get("tag"))
                continue
            decodes = [w for w in self._live("decode")
                       if int((w.last_lease or {}).get("free_slots", 0))
                       > 0]
            if not decodes:
                still.append(item)
                continue
            dw = max(decodes,
                     key=lambda w: int(w.last_lease.get("free_slots", 0)))
            dw.last_lease["free_slots"] = (
                int(dw.last_lease.get("free_slots", 1)) - 1)
            entry["worker"] = dw.name   # decode side owns it now
            dw.sender.send({"kind": "install", "epoch": dw.epoch,
                            "trace_id": msg["trace_id"],
                            "tag": msg["tag"],
                            "length": msg.get("length"),
                            "meta": msg.get("meta")})
            _flight.note("fleet", event="slab_routed",
                         trace_id=msg["trace_id"], src=item["src"],
                         dst=dw.name)
        self._pending_slabs = still

    #: install nacks tolerated per request before the slab is given up
    #: on and the request re-prefills (a decode worker whose lease
    #: over-reports free slots could otherwise nack forever).
    MAX_INSTALL_NACKS = 3

    def _on_install_nack(self, wc: WorkerClient,
                         msg: Dict[str, Any]) -> None:
        entry = self._entry(msg.get("trace_id"))
        if entry is None:
            self._gc_slab(msg.get("tag"))
            return
        nacks = entry.get("install_nacks", 0) + 1
        entry["install_nacks"] = nacks
        if msg.get("reason") == "no_free_slot" \
                and nacks <= self.MAX_INSTALL_NACKS:
            # transient: back to the pending queue for another worker /
            # a later round (ownership reverts to routing limbo)
            self._pending_slabs.append(
                {"msg": {"trace_id": msg["trace_id"],
                         "tag": msg.get("tag"),
                         "length": msg.get("length"),
                         "meta": msg.get("meta")},
                 "src": entry.get("slab_src", entry["worker"]),
                 "attempts": entry["attempts"]})
            return
        # lane fault / nack budget spent: the slab is unusable —
        # re-prefill on a survivor (failover bumps attempts, so any
        # copy still pending is dropped and GC'd by the router)
        self._gc_slab(msg.get("tag"))
        self._failover(entry, f"decode worker {wc.name} could not land "
                              f"slab: {msg.get('reason')} "
                              f"({nacks} nack(s))")

    # ------------------------------------------------------------------
    # supervision
    # ------------------------------------------------------------------
    def supervisor_tick(self) -> None:
        """One health sweep: epoch-aware lease aging, death detection
        within the configured window, zombie refusal, breaker-governed
        re-admission."""
        with self.goodput.measure("supervise"):
            self._supervise()

    def _supervise(self) -> None:
        now = time.monotonic()
        # lease files refresh only every beat interval — polling them on
        # the 2ms dispatch loop would be >95% wasted I/O booked straight
        # into the supervise bucket it exists to measure honestly
        if now - self._last_supervise < self.beat_interval_s / 2.0:
            return
        self._last_supervise = now
        for wc in list(self.workers.values()):
            if wc.state in ("drained",):
                continue
            try:
                lease = self._leases.read(wc.name)
            except ValueError as e:      # foreign/corrupt lease payload
                _flight.note("fleet", event="lease_refused",
                             worker=wc.name, error=str(e))
                lease = None
            # process each published seq ONCE: a dead worker's lease
            # file persists (nothing deletes it at SIGKILL), and
            # re-judging the same stale payload every poll would both
            # inflate the fenced_refusals counters with wall-clock time
            # and re-admit the corpse — only a NEW beat (a resumed
            # zombie, a recovered flapper) is evidence of life
            if lease is not None \
                    and int(lease.get("seq", -1)) != wc.judged_seq:
                wc.judged_seq = int(lease.get("seq", -1))
                admitted = self.fence.admit(
                    wc.name, lease.get("epoch", -1), "lease")
                # merge the beat's HLC: the publisher's write
                # happens-before this judgment in the fleet timeline,
                # and the admitted flag is what conformance replays
                # against the lease_fence model
                _journal.recv_emit(
                    lease.get("hlc"), "lease_judged", worker=wc.name,
                    epoch=lease.get("epoch"), lseq=wc.judged_seq,
                    admitted=admitted)
                if admitted:
                    with self._lock:   # resets sent_since_lease, which
                        # submit threads increment under the same lock
                        wc.observe_lease(lease)
                    if wc.state == "starting":
                        wc.state = "live"
                        wc.breaker.record_success()
                elif wc.state == "dead":
                    # a fenced worker is beating AGAIN: re-admission is
                    # the breaker's call
                    if wc.breaker.allow():
                        self._readmit(wc)
            if wc.state in ("live", "draining"):
                window = self.lease_window_s
                if wc.lease_age_s() > window:
                    self._mark_dead(
                        wc, f"missed lease window ({window:.3f}s)")
            elif wc.state == "starting":
                if now - wc.t_admitted > self.start_grace_s:
                    self._mark_dead(
                        wc, f"never published a lease within the "
                            f"start grace ({self.start_grace_s}s)")
        self._sweep_orphaned_inflight()
        self._check_pull_deadlines(now)
        self._sweep_orphan_tags(now)

    def _sweep_orphan_tags(self, now: float) -> None:
        """Periodic lane-dir sweep: a worker that
        died between publishing a slab (``slab/``/``pfx/`` tag) and the
        install-ack leaks the tag forever — only the CAUGHT fault path
        GC'd before this.  A tag owned by no in-flight request for a
        full ``orphan_grace_s`` window is deleted; the grace window
        keeps a tag published a beat before its announce arrives from
        being swept out from under a live transfer."""
        if now - self._last_orphan_sweep < self.orphan_sweep_interval_s:
            return
        self._last_orphan_sweep = now
        tags_fn = getattr(self.store, "tags", None)
        if tags_fn is None:
            return
        try:
            tags = tags_fn()
        except Exception as e:  # noqa: BLE001 — a sweep must never
            # hurt the supervisor
            _flight.note("fleet", event="orphan_sweep_failed",
                         error=str(e))
            return
        with self._lock:
            live = set(self._inflight)
        present = set()
        for tag in tags:
            if not (tag.startswith("slab/") or tag.startswith("pfx/")):
                continue
            present.add(tag)
            trace_id = tag.split("/", 1)[1]
            if trace_id in live:
                self._orphan_seen.pop(tag, None)
                continue
            t0 = self._orphan_seen.setdefault(tag, now)
            if now - t0 >= self.orphan_grace_s:
                self._gc_slab(tag)
                self._orphan_seen.pop(tag, None)
                self._orphans_swept += 1
                _flight.note("fleet", event="orphan_slab_swept",
                             tag=tag)
        for tag in list(self._orphan_seen):
            if tag not in present:
                self._orphan_seen.pop(tag, None)

    def _sweep_orphaned_inflight(self) -> None:
        """Fail over in-flight entries owned by a dead/drained worker.

        Closes the submit/_mark_dead TOCTOU: a client thread can
        snapshot a live worker, lose the race to the supervisor (which
        enumerates ``_inflight`` for failover BEFORE the entry exists),
        and then register+send to the corpse — without this sweep that
        request would hang forever with its worker never re-judged.
        Runs on the supervisor thread only, like every other
        ``_failover`` call site, so an entry cannot be failed over
        twice concurrently."""
        dead_states = ("dead", "drained")
        with self._lock:
            orphans = [
                e for e in self._inflight.values()
                if getattr(self.workers.get(e["worker"]), "state", None)
                in dead_states]
        for entry in orphans:
            wc = self.workers[entry["worker"]]
            self._failover(
                entry, f"dispatch raced worker {wc.name} going "
                       f"{wc.state} (orphan sweep)")

    def _readmit(self, wc: WorkerClient) -> None:
        wc.epoch = self.fence.new_epoch(wc.name)
        wc.state = "live"
        wc.reset_lease_clock()
        with self._lock:
            self._readmitted += 1
        wc.sender.send({"kind": "hello", "epoch": wc.epoch})
        _flight.note("fleet", event="readmitted", worker=wc.name,
                     epoch=wc.epoch,
                     breaker=wc.breaker.state())

    def _mark_dead(self, wc: WorkerClient, why: str) -> None:
        """Death: fence, fail over every in-flight request, evidence."""
        age = wc.lease_age_s()
        wc.state = "dead"
        self.fence.fence(wc.name)
        wc.breaker.record_failure()
        # the fleet cache index is SOFT state of this corpse: drop
        # every entry for the fenced epoch in one sweep, and resolve
        # every pull it owed to the counted re-prefill fallback (the
        # mid-pull owner-death failure domain)
        self.cache_index.drop_worker(wc.name)
        self._cancel_pulls_on(wc.name, f"died ({why})")
        lane = f"worker_lane/{out_mailbox(wc.name)}/recv"
        detection = {
            "worker": wc.name,
            "role": wc.role,
            "lane": lane,
            "why": why,
            "lease_age_s": round(age, 4),
            "detection_window_s": round(self.lease_window_s, 4),
            "epoch_fenced": self.fence.current(wc.name),
        }
        # the detection note goes down BEFORE the failover sweep: the
        # causal journal must show worker_lost happens-before every
        # redispatched/shed it triggers, or the JAX package's conformance
        # replay (observability/conform.py) sees a failover of a worker the
        # router never declared dead
        _flight.note("fleet", event="worker_lost", **detection)
        outcomes = []
        with self._lock:
            owned = [e for e in self._inflight.values()
                     if e["worker"] == wc.name]
        for entry in owned:
            outcomes.append(self._failover(entry, why))
        detection["in_flight"] = outcomes
        self.last_detection = detection
        if self.bundle_dir:
            _flight.dump_bundle(self.bundle_dir, "worker_lost",
                                extra={"worker_lost": detection})

    def _failover(self, entry: Dict[str, Any], why: str) -> Dict[str, Any]:
        """Re-dispatch one in-flight request to a survivor, or shed it
        machine-readably; returns the outcome row the bundle records."""
        req = entry["req"]
        role = self._submit_role()
        mid = entry.get("model_id")
        survivors = [w for w in self._live(role)
                     if w.name != entry["worker"]
                     and (mid is None or w.model_id == mid)]
        with self._lock:
            # ownership test + attempts bump are ATOMIC with the
            # submit-path rollback's (membership, attempts==1) check:
            # either the rollback pops first and we bail here, or we
            # bump first and the rollback sees a disowned entry — a
            # half-raced entry can never be both rejected to its caller
            # AND redispatched to a survivor
            if self._inflight.get(req.trace_id) is not entry:
                return {"trace_id": req.trace_id,
                        "outcome": "already_resolved"}
            redispatch = bool(
                survivors
                and entry["attempts"] < 1 + self.max_failover_attempts)
            if redispatch:
                entry["attempts"] += 1
        if redispatch:
            entry["install_nacks"] = 0     # fresh budget per attempt
            # any slab the dead attempt published is superseded by the
            # re-prefill; drop it from the lane store (no-op for
            # engine-role fleets — they publish no slabs), and any
            # pending prefix pull is superseded too (its messages are
            # refused by the attempts stamp)
            with self._lock:
                entry.pop("pull", None)
            self._gc_slab(f"slab/{req.trace_id}")
            self._gc_slab(f"pfx/{req.trace_id}")
            # deterministic re-generation: reset streamed state, keep
            # the original submit stamp so the failover TTFT penalty is
            # measured end to end
            req.tokens = []
            req.timestamps.pop("first_token", None)
            # least-loaded first, but a failed send must not shed while
            # a healthy survivor remains untried — and an unhandled
            # raise here would kill the supervisor/router thread and
            # silently wedge the WHOLE fleet (no pump, no detection)
            order = sorted(
                survivors,
                key=lambda w: int((w.last_lease or {}).get(
                    "queue_depth", 0)) + w.sent_since_lease)
            for wc in order:
                with self._lock:
                    entry["worker"] = wc.name
                    wc.sent_since_lease += 1
                try:
                    self._send_submit(wc, req)
                except Exception as e:  # noqa: BLE001
                    # un-dispatch: keep this survivor's depth estimate
                    # honest (mirrors the submit-path rollback)
                    with self._lock:
                        wc.sent_since_lease = max(
                            wc.sent_since_lease - 1, 0)
                    _flight.note("fleet", event="failover_send_failed",
                                 trace_id=req.trace_id, to=wc.name,
                                 error=str(e))
                    why = (f"{why}; re-dispatch send to {wc.name} "
                           f"failed: {e}")
                    continue
                with self._lock:
                    self._redispatched += 1
                _flight.note("fleet", event="redispatched",
                             trace_id=req.trace_id, to=wc.name,
                             attempt=entry["attempts"], why=why)
                return {"trace_id": req.trace_id,
                        "outcome": "redispatched", "to": wc.name}
        return self._shed_entry(
            entry,
            f"{why}; not re-dispatched ({entry['attempts']} attempt(s) "
            f"used, {len(survivors)} survivor(s))")

    def _shed_entry(self, entry: Dict[str, Any],
                    why: str) -> Dict[str, Any]:
        """Terminal machine-readable shed of one in-flight entry (the
        no-re-dispatch half of :meth:`_failover`, also called directly
        when re-dispatch is pointless — e.g. the router thread died and
        nobody will ever pump a result again)."""
        req = entry["req"]
        with self._lock:
            # claim-or-bail: a concurrent submit rollback may have
            # already resolved this entry to its caller — shedding it
            # again would finish the request twice and double-count
            if self._inflight.get(req.trace_id) is not entry:
                return {"trace_id": req.trace_id,
                        "outcome": "already_resolved"}
            self._inflight.pop(req.trace_id)
            self._rejected["worker_lost"] = \
                self._rejected.get("worker_lost", 0) + 1
            self._shed_inflight += 1
        if self.tenancy is not None:
            self.tenancy.count_shed(req.tenant, "worker_lost")
        shed = AdmissionError(
            "worker_lost", why,
            retry_after_ms=self._retry_after_ms(),
            queue_depth=sum(
                int((w.last_lease or {}).get("queue_depth", 0))
                for w in self._live()),
            tenant=req.tenant,
            rung=(None if self.tenancy is None
                  else self.tenancy.ladder.rung))
        req.shed_payload = shed.to_dict()
        req.finish("shed", time.monotonic())
        self._gc_slab(f"slab/{req.trace_id}")
        self._gc_slab(f"pfx/{req.trace_id}")
        if self.metrics_writer is not None:
            self.metrics_writer.write(
                dict(reason="worker_lost", trace_id=req.trace_id,
                     **{f"fleet/{k}": v for k, v in shed.to_dict().items()
                        if not isinstance(v, str)}),
                kind="fleet_shed")
        _flight.note("fleet", event="shed", trace_id=req.trace_id,
                     payload=req.shed_payload)
        obs.async_event("e", "request", req.trace_id,
                        cat="serving_request", reason="shed",
                        n_tokens=0)
        return {"trace_id": req.trace_id, "outcome": "shed"}

    # ---- drain: the graceful rolling-restart half ----
    def drain(self, worker: str) -> None:
        """Stop admitting to ``worker`` and ask it to finish in-flight
        work, release its lease, and exit 0.  :meth:`pump` collects the
        ``drained`` handshake; :meth:`wait_drained` blocks on it."""
        wc = self.workers[worker]
        wc.state = "draining"
        wc.sender.send({"kind": "drain"})
        _flight.note("fleet", event="drain_requested", worker=worker)

    def _on_drained(self, wc: WorkerClient) -> None:
        wc.state = "drained"
        self.fence.fence(wc.name)   # nothing further may land
        self.cache_index.drop_worker(wc.name)
        self._cancel_pulls_on(wc.name, "drained", fault=False)
        _flight.note("fleet", event="drained", worker=wc.name)
        if self.bundle_dir:
            _flight.dump_bundle(
                self.bundle_dir, "drain",
                extra={"drain": {
                    "worker": wc.name, "role": wc.role,
                    "lane": f"worker_lane/{out_mailbox(wc.name)}/recv",
                    "lease_age_s": round(wc.lease_age_s(), 4),
                    "in_flight": [],      # drained == nothing shed
                }})

    def wait_drained(self, worker: str, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            self.step()
            if self.workers[worker].state == "drained":
                return True
            time.sleep(0.005)
        return False

    def add_worker(self, wc: WorkerClient) -> None:
        """Admit a replacement worker (the second half of a rolling
        restart)."""
        if wc.name in self.workers:
            raise ValueError(f"worker name {wc.name!r} already "
                             f"registered (restarted workers need fresh "
                             f"names — their mailbox cursors died with "
                             f"the old process)")
        while (self.fence.current(wc.name) or 0) < wc.epoch:
            self.fence.new_epoch(wc.name)
        self.workers[wc.name] = wc

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def step(self) -> int:
        """One router round: pump worker messages, the supervisor
        tick, then the autoscaler's control loop when one is attached
        — the router's driver thread IS the supervisor
        thread the autoscale policy runs on."""
        handled = self.pump()
        self.supervisor_tick()
        if self.autoscaler is not None:
            self.autoscaler.maybe_tick()
        return handled

    def start(self, poll_s: float = 0.002) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            try:
                while not self._stop.is_set():
                    if self.step() == 0:
                        time.sleep(poll_s)
            except BaseException as e:  # noqa: BLE001
                # the driver discipline: a dying router thread is
                # LOUD and BOUNDED — note + bundle + stop flag, every
                # in-flight request shed machine-readably (nobody will
                # ever pump a result again) and further submits
                # rejected, never a silent half-wedged fleet with
                # callers blocking forever
                err = f"{type(e).__name__}: {e}"
                self._stop.set()
                _flight.note("fleet", event="router_thread_death",
                             error=err)
                with self._lock:
                    # same lock as submit's registration: every
                    # accepted entry is in this snapshot, every
                    # later submit sees the flag and rejects
                    self._router_dead = err
                    stranded = list(self._inflight.values())
                for entry in stranded:
                    try:
                        self._shed_entry(
                            entry, f"fleet router thread died: {err}")
                    except Exception:  # noqa: BLE001 — PER-ENTRY
                        pass  # best-effort: one failing shed must not
                        #     strand every remaining caller
                if self.bundle_dir:
                    _flight.dump_bundle(
                        self.bundle_dir, "fleet_router_death",
                        extra={"error": err})
                raise

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-router")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def shutdown(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Stop every live worker (``stop`` message; processes reaped
        with their exit codes) and the driver thread."""
        self.stop()
        for wc in self.workers.values():
            if wc.state not in ("dead", "drained"):
                try:
                    wc.sender.send({"kind": "stop"})
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
        codes = {}
        deadline = time.monotonic() + float(timeout_s)
        for wc in self.workers.values():
            if wc.proc is None:
                continue
            left = max(deadline - time.monotonic(), 0.1)
            try:
                codes[wc.name] = wc.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                wc.proc.kill()
                codes[wc.name] = wc.proc.wait()
        return codes

    def close(self) -> None:
        self.stop()
        if _flight._PROVIDERS.get("fleet_health") == self.introspect_state:
            _flight.unregister_provider("fleet_health")

    @property
    def busy(self) -> bool:
        with self._lock:
            if self._inflight or self._pending_slabs:
                return True
        return any(
            int((w.last_lease or {}).get("queue_depth", 0))
            + int((w.last_lease or {}).get("busy_slots", 0)) > 0
            for w in self._live())

    # ------------------------------------------------------------------
    # metrics / introspection
    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Fleet summary under ``fleet/*``: liveness, dispatch/failover
        counters, fencing refusals, detection latency.  ``*_ms``/``shed``/
        ``rejected``/``refus`` keys are lower-is-better."""
        with self._lock:
            rejected = dict(self._rejected)
            dispatched = self._dispatched
            redispatched = self._redispatched
            shed_inflight = self._shed_inflight
            readmitted = self._readmitted
            tokens = self._tokens
            ttft = self._ttft_ms.values()
            fttft = self._failover_ttft_ms.values()
        states = [w.state for w in self.workers.values()]
        out: Dict[str, float] = {
            "fleet/workers": float(len(states)),
            "fleet/live_workers": float(
                sum(s in ("starting", "live") for s in states)),
            "fleet/dead_workers": float(states.count("dead")),
            "fleet/drained_workers": float(states.count("drained")),
            "fleet/dispatched_total": float(dispatched),
            "fleet/redispatched_total": float(redispatched),
            "fleet/shed_inflight_total": float(shed_inflight),
            "fleet/readmitted_total": float(readmitted),
            "fleet/rejected_total": float(sum(rejected.values())),
            "fleet/tokens_total": float(tokens),
            "fleet/tokens_per_sec": tokens / max(
                time.monotonic() - self._t0, 1e-9),
        }
        for reason, n in sorted(rejected.items()):
            out[f"fleet/rejected/{reason}"] = float(n)
        for kind, n in sorted(self.fence.refusal_counts().items()):
            out[f"fleet/fenced_refusals/{kind}"] = float(n)
        # fleet KV economy: index + pull counters, plus the
        # worker-side spill/restore/CRC counters aggregated from the
        # leases (the workers count their own refusals; the router
        # never double-books them)
        idx = self.cache_index
        out["fleet/cache/index_entries"] = float(idx.n_entries)
        out["fleet/cache/hits"] = float(idx.hits)
        out["fleet/cache/misses"] = float(idx.misses)
        with self._lock:
            out["fleet/cache/remote_pulls"] = float(self._remote_pulls)
        stale = dict(idx.stale_fallbacks)
        out["fleet/cache/stale_fallbacks"] = float(sum(stale.values()))
        for reason, n in sorted(stale.items()):
            out[f"fleet/cache/stale_fallbacks/{reason}"] = float(n)
        out["fleet/cache/orphan_tags_swept"] = float(self._orphans_swept)
        agg = {"spills": 0, "restores": 0, "crc_refusals": 0,
               "prefill_calls": 0, "pull_serves": 0, "pull_installs": 0}
        for w in self.workers.values():
            c = (w.last_lease or {}).get("cache") or {}
            for k in agg:
                agg[k] += int(c.get(k, 0))
        for k, v in agg.items():
            out[f"fleet/cache/{k}"] = float(v)
        offered = dispatched + sum(rejected.values()) - shed_inflight
        out["fleet/shed_rate"] = (
            sum(rejected.values()) / offered if offered else 0.0)
        if ttft:
            out["fleet/ttft_p50_ms"] = percentile_of(ttft, 50)
            out["fleet/ttft_p99_ms"] = percentile_of(ttft, 99)
        if fttft:
            out["fleet/failover_ttft_p99_ms"] = percentile_of(fttft, 99)
        if self.last_detection is not None:
            out["fleet/detection_ms"] = round(
                self.last_detection["lease_age_s"] * 1e3, 3)
        out.update(self.goodput.gauges("fleet/goodput"))
        if self.tenancy is not None:
            out.update(self.tenancy.metrics())
        if self.autoscaler is not None:
            out.update(self.autoscaler.metrics())
        return out

    def reset_stats(self) -> None:
        with self._lock:
            self._dispatched = 0
            self._redispatched = 0
            self._shed_inflight = 0
            self._readmitted = 0
            self._tokens = 0
            self._results = 0
            self._t0 = time.monotonic()
            self._rejected = {r: 0 for r in self._rejected}
            self._remote_pulls = 0
            self._orphans_swept = 0
            self._ttft_ms = ReservoirSample(self._ttft_ms.capacity)
            self._failover_ttft_ms = ReservoirSample(
                self._failover_ttft_ms.capacity)
        # one epoch for every cache-economy rate counter: warm-up
        # hits/misses/stale fallbacks must not leak into the measured
        # window
        self.cache_index.reset_counters()
        self.goodput.reset()

    def requests_table(self) -> Dict[str, Any]:
        with self._lock:
            rows = [_request_row(e["req"])
                    for e in self._inflight.values()]
        return {"schema": "chainermn_tpu.requestz.v1",
                "fleet": True, "in_flight": rows}

    def introspect_state(self) -> Dict[str, Any]:
        """The ``fleet_health`` flight/statusz provider: per-worker
        liveness, lease age, epoch, breaker state, and the supervision
        counters — the first thing a fleet postmortem reads."""
        with self._lock:
            inflight_by: Dict[str, int] = {}
            for e in self._inflight.values():
                inflight_by[e["worker"]] = \
                    inflight_by.get(e["worker"], 0) + 1
            state: Dict[str, Any] = {
                "dispatched": self._dispatched,
                "redispatched": self._redispatched,
                "shed_inflight": self._shed_inflight,
                "readmitted": self._readmitted,
                "rejected": dict(self._rejected),
                "in_flight": len(self._inflight),
                "pending_slabs": len(self._pending_slabs),
            }
        state["lease_window_s"] = self.lease_window_s
        state["fenced_refusals"] = self.fence.refusal_counts()
        state["last_detection"] = self.last_detection
        # the fleet cache-index block: who claims which
        # prefixes at which tier, pull counters, and the last pull
        # fault — what a KV-economy postmortem reads first
        with self._lock:
            remote_pulls = self._remote_pulls
            pending_pulls = sum(
                1 for e in self._inflight.values() if "pull" in e)
        state["cache_index"] = dict(
            self.cache_index.state(),
            remote_pulls=remote_pulls,
            pending_pulls=pending_pulls,
            orphan_tags_swept=self._orphans_swept,
            last_pull_fault=self.last_pull_fault)
        # the autoscaler's view: live /statusz and
        # the flight bundle agree on WHY the fleet is its current size
        # — target per role, last decision + reason, and every tenant's
        # budget consumption
        if self.autoscaler is not None:
            state["autoscale"] = self.autoscaler.state()
        if self.tenancy is not None:
            state["tenancy"] = self.tenancy.state()
        state["workers"] = {
            w.name: {
                "role": w.role,
                "state": w.state,
                "epoch": w.epoch,
                "lease_age_s": round(w.lease_age_s(), 4),
                "breaker": w.breaker.state(),
                "in_flight": inflight_by.get(w.name, 0),
                "lease": w.last_lease,
            }
            for w in self.workers.values()}
        return state

    def finalize_metrics(self) -> None:
        if self.metrics_writer is not None:
            self.metrics_writer.write(self.metrics(),
                                      kind="fleet_summary")

    def write_prometheus(self, path: str) -> str:
        from ..observability.export import write_prometheus_textfile
        return write_prometheus_textfile(path, extra_gauges=self.metrics())


# ---------------------------------------------------------------------------
# fleet construction
# ---------------------------------------------------------------------------

def write_params_file(path: str, params, *, head_dim: int,
                      **worker_kwargs) -> str:
    """Pickle the worker-build spec (the params as CPU tensors, in their
    dtype, plus the engine kwargs) for the process entry (``python -m
    chainermn_tpu_torch.serving.worker``); each worker moves the params to
    its device."""
    import torch

    from ..convert import tree_map

    spec = dict(worker_kwargs, head_dim=int(head_dim),
                params=tree_map(params, lambda t: torch.as_tensor(t)
                                .detach().to("cpu")))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(spec, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def spawn_worker(lane_dir: str, params_file: str, name: str, role: str,
                 *, epoch: int = 1, beat_interval_s: float = 0.05,
                 bundle_dir: Optional[str] = None,
                 journal_dir: Optional[str] = None,
                 device: str = "cuda",
                 env: Optional[Dict[str, str]] = None,
                 stdout=None,
                 worker_cmd: Optional[Sequence[str]] = None,
                 tp: int = 1) -> subprocess.Popen:
    """Exec one worker process (a detached role loop over the file lanes)
    on ``device``.  ``worker_cmd`` is the argv prefix that runs the
    worker's entry (default ``python -m chainermn_tpu_torch.serving
    .worker``); a wrapper must pass the remaining arguments to
    :func:`~chainermn_tpu_torch.serving.worker.main`.  At ``tp > 1`` the
    process leads a group of ``tp`` ranks (over
    :func:`~chainermn_tpu_torch.serving.worker.group_backend`'s backend)
    and starts its followers through the same ``worker_cmd``; the
    returned ``Popen`` is the leader's."""
    prefix = list(worker_cmd or [sys.executable, "-m",
                                 "chainermn_tpu_torch.serving.worker"])
    cmd = prefix + [
        "--name", name, "--role", role, "--lane-dir", lane_dir,
        "--params", params_file, "--epoch", str(epoch),
        "--beat-interval-s", str(beat_interval_s), "--device", str(device)]
    if int(tp) > 1:
        cmd += ["--tp", str(int(tp)), "--rank-cmd", json.dumps(prefix)]
    if bundle_dir:
        cmd += ["--bundle-dir", bundle_dir]
    if journal_dir:
        cmd += ["--journal-dir", journal_dir]
    penv = dict(os.environ)
    if env:
        penv.update(env)
    if stdout is None:
        # keep the PARENT's stdout clean (the serve CLI's summary JSON
        # lives there); worker stderr inherits so crashes stay visible
        return subprocess.Popen(cmd, env=penv,
                                stdout=subprocess.DEVNULL)
    return subprocess.Popen(cmd, env=penv, stdout=stdout,
                            stderr=subprocess.STDOUT)


def _resolve_topology(topology, registry):
    """Normalize ``{role: count-or-[model_id, ...]}`` to per-worker
    ``(role, index, model_id-or-None)`` rows.  A model_id list needs a
    :class:`~chainermn_tpu_torch.serving.models.ModelRegistry` (the
    heterogeneous fleet); a plain int keeps the homogeneous behavior."""
    rows = []
    for role, count in topology.items():
        if isinstance(count, int):
            rows += [(role, i, None) for i in range(count)]
            continue
        if registry is None:
            raise ValueError(
                f"topology role {role!r} lists model_ids {count!r} "
                f"but no registry= was given")
        for i, mid in enumerate(count):
            registry.get(mid)      # refuse unknown ids up front
            rows.append((role, i, str(mid)))
    return rows


def build_proc_fleet(params, topology: Dict[str, Any], lane_dir: str, *,
                     head_dim: Optional[int] = None,
                     beat_interval_s: float = 0.05,
                     miss_beats: int = 4,
                     bundle_dir: Optional[str] = None,
                     journal_dir: Optional[str] = None,
                     worker_kwargs: Optional[Dict[str, Any]] = None,
                     registry=None,
                     env: Optional[Dict[str, str]] = None,
                     device: str = "cuda",
                     worker_cmd: Optional[Sequence[str]] = None,
                     tp: int = 1,
                     **router_kwargs) -> FleetRouter:
    """Spawn and wire a cross-process gang: ``topology`` maps role →
    count (``{"engine": N}`` for ``serve --fleet-procs N``,
    ``{"prefill": P, "decode": D}`` for ``--disagg P:D --procs``) or
    role → list of model_ids resolved through ``registry`` (a
    heterogeneous fleet: each worker loads its variant's params from a
    per-variant pickle, and ``params`` / ``head_dim`` may be None).  Every
    worker runs on ``device`` (the card by default: it raises without
    one, never falls back); on a card the serving kernels are built here,
    once, before any worker starts, and the workers only load them.  The
    caller drives :meth:`FleetRouter.step` (or ``start()``) and finishes
    with :meth:`FleetRouter.shutdown`.  ``journal_dir`` turns on the
    causal HLC journal in this process and every spawned worker (merge
    with :func:`~chainermn_tpu_torch.observability.journal
    .merge_journals`).  ``worker_cmd``: see :func:`spawn_worker`.
    ``tp > 1``: every worker is a group of ``tp`` processes over
    :func:`~chainermn_tpu_torch.serving.worker.group_backend`'s backend
    (the router's ``group`` names it), the params sharded by each rank at
    load; the workers' leaders hold the leases."""
    from .._device import resolve_device
    from .lanes import FileLaneStore

    if resolve_device(device).type == "cuda":
        from ..ops import _build
        _build.build(SERVING_SOURCES)
    backend = group_backend(device, tp) if int(tp) > 1 else None
    os.makedirs(lane_dir, exist_ok=True)
    if journal_dir:
        _journal.configure(journal_dir, "router")
    rows = _resolve_topology(topology, registry)
    params_files: Dict[Optional[str], str] = {}
    for _, _, mid in rows:
        if mid in params_files:
            continue
        if mid is None:
            if params is None or head_dim is None:
                raise ValueError("int topology counts need params= "
                                 "and head_dim=")
            params_files[None] = write_params_file(
                os.path.join(lane_dir, "fleet_params.pkl"), params,
                head_dim=head_dim, **(worker_kwargs or {}))
        else:
            var = registry.get(mid)
            params_files[mid] = write_params_file(
                os.path.join(lane_dir, f"fleet_params.{mid}.pkl"),
                var.params, head_dim=var.head_dim,
                model_id=var.model_id,
                weights_generation=var.generation,
                **dict(worker_kwargs or {}, **var.worker_kwargs))
    store = FileLaneStore(lane_dir)
    clients = []
    try:
        for role, i, mid in rows:
            name = f"{role}{i}" if mid is None else f"{role}.{mid}.{i}"
            proc = spawn_worker(lane_dir, params_files[mid], name, role,
                                epoch=1, beat_interval_s=beat_interval_s,
                                bundle_dir=bundle_dir,
                                journal_dir=journal_dir, device=device,
                                env=env, worker_cmd=worker_cmd, tp=tp)
            clients.append(WorkerClient(name, role, store, epoch=1,
                                        proc=proc,
                                        model_id=mid or "default"))
        router = FleetRouter(clients, store,
                             beat_interval_s=beat_interval_s,
                             miss_beats=miss_beats, bundle_dir=bundle_dir,
                             **router_kwargs)
        router.group = {"tp": int(tp), "backend": backend}
        router.spawn = dict(lane_dir=lane_dir, device=device, env=env,
                            worker_cmd=worker_cmd, bundle_dir=bundle_dir,
                            journal_dir=journal_dir, tp=int(tp),
                            worker_kwargs=dict(worker_kwargs or {}))
        return router
    except BaseException:
        for wc in clients:       # no orphaned worker on a failed build
            wc.proc.kill()
            wc.proc.wait()
        raise


def build_local_fleet(params, topology: Dict[str, Any], *,
                      head_dim: Optional[int] = None, store=None,
                      beat_interval_s: float = 0.02, miss_beats: int = 4,
                      bundle_dir: Optional[str] = None,
                      worker_kwargs: Optional[Dict[str, Any]] = None,
                      registry=None,
                      **router_kwargs):
    """In-process twin of :func:`build_proc_fleet` over the loopback
    store: returns ``(router, runtimes)`` with every worker a
    :class:`~chainermn_tpu_torch.serving.worker.WorkerRuntime` the caller
    steps (or drives on threads).  Same protocol, same fault discipline.
    ``worker_kwargs`` reach every runtime (``device=`` among them; the
    card by default).  ``topology`` role values may be model_id lists
    resolved through ``registry`` (the heterogeneous fleet)."""
    from .transfer import InProcessLaneStore
    from .worker import WorkerRuntime

    store = store or InProcessLaneStore()
    runtimes, clients = [], []
    for role, i, mid in _resolve_topology(topology, registry):
        if mid is None:
            if params is None or head_dim is None:
                raise ValueError("int topology counts need params= "
                                 "and head_dim=")
            name = f"{role}{i}"
            rt = WorkerRuntime(
                name, role, params, store, head_dim=head_dim, epoch=1,
                beat_interval_s=beat_interval_s,
                **(worker_kwargs or {}))
        else:
            var = registry.get(mid)
            name = f"{role}.{mid}.{i}"
            rt = WorkerRuntime(
                name, role, var.params, store,
                head_dim=var.head_dim, epoch=1,
                beat_interval_s=beat_interval_s,
                model_id=var.model_id,
                weights_generation=var.generation,
                **dict(worker_kwargs or {}, **var.worker_kwargs))
        # leases flow even when the caller steps the loop manually (a
        # long step would otherwise read as a missed window); kill()
        # still silences the thread, preserving the chaos semantics
        rt.start_heartbeat()
        runtimes.append(rt)
        clients.append(WorkerClient(name, role, store, epoch=1,
                                    model_id=mid or "default"))
    router = FleetRouter(clients, store,
                         beat_interval_s=beat_interval_s,
                         miss_beats=miss_beats, bundle_dir=bundle_dir,
                         **router_kwargs)
    return router, runtimes


def rolling_upgrade(router: FleetRouter, runtimes: Optional[List[Any]],
                    checkpoint_shards, src_layout, *,
                    generation: int, head_dim: int,
                    model_id: Optional[str] = None,
                    worker_kwargs: Optional[Dict[str, Any]] = None,
                    beat_interval_s: Optional[float] = None,
                    timeout_s: float = 60.0) -> Dict[str, Any]:
    """Install a new checkpoint generation across a LIVE fleet with
    zero restart and zero shed.

    The checkpoint arrives as its saved host shards; ``reshard_host``
    (the portable-redistribution primitive) re-partitions them to each
    worker's layout with the documented exactness contract — so the installed weights are bit-identical to
    the checkpoint however it was sharded, and a pinned greedy request
    decodes token-exactly across the upgrade when the values match.

    Per target engine worker (oldest generation first, one at a time):

    1. spawn the replacement with the NEW params and
       ``weights_generation=generation`` under a FRESH name (mailbox
       cursors die with the old incarnation — the rolling-restart
       rule) and admit it via :meth:`FleetRouter.add_worker`;
    2. wait until its lease makes it ``live`` — capacity never dips,
       which is what makes the shed-free guarantee structural rather
       than lucky;
    3. ``drain`` the old worker and wait for the drained handshake
       (in-flight work finishes on the old weights; nothing is shed —
       the drain discipline).

    In-process fleets (``runtimes`` of
    :class:`~chainermn_tpu_torch.serving.worker.WorkerRuntime`;
    ``worker_kwargs`` carry their ``device=``): each
    replacement runs on a daemon thread and is appended to
    ``runtimes``.  At TP > 1 (a runtime, or ``worker_kwargs``' ``mesh``,
    over a model axis of more than one rank) this raises
    ``NotImplementedError`` before it touches the fleet: the replacement
    would be built on the calling rank only, and no plan op builds it on
    the followers, which would go on running the old worker's calls
    (ROADMAP.md, queue A, A11 step 3d).  A process fleet (``runtimes=None``, the router of
    :func:`build_proc_fleet`): each replacement is spawned as the
    originals were (its device, its command and, at TP > 1, a whole
    group of processes) from a params file of the new generation in the
    lane directory, and the old group drains and exits.  Safe with a
    started router thread (the same concurrent-``step`` contract as
    :meth:`FleetRouter.wait_drained`).  Returns ``{generation, upgraded:
    [{old, new}...], drain_shed, rejected_delta}`` — the acceptance gates
    ``drain_shed == 0``.
    """
    import threading as _threading

    from ..parallel.reshard import reshard_host
    from .worker import WorkerRuntime

    if runtimes is not None:
        kw = worker_kwargs or {}
        mesh = kw.get("mesh")
        wide = [rt.name for rt in runtimes if getattr(rt, "tp", 1) > 1]
        if mesh is not None and int(mesh.shape[kw.get("axis_name",
                                                       "model")]) > 1:
            wide.append("worker_kwargs['mesh']")
        if wide:
            raise NotImplementedError(
                "rolling_upgrade over in-process runtimes at TP > 1 is not "
                f"ported ({', '.join(wide)}): the replacement would be "
                "built on this rank only and no plan op builds it on the "
                "followers (ROADMAP.md, queue A, A11 step 3d); upgrade a "
                "process fleet (runtimes=None, build_proc_fleet) instead")
    new_params = reshard_host(list(checkpoint_shards), src_layout,
                              None, 1)[0]
    targets = [w for w in router.workers.values()
               if w.role == "engine" and w.state in ("starting", "live")
               and (model_id is None or w.model_id == model_id)
               and w.weights_generation < int(generation)]
    if not targets:
        raise ValueError(
            f"rolling_upgrade: no live engine worker below generation "
            f"{generation}"
            + (f" for model {model_id!r}" if model_id else ""))
    targets.sort(key=lambda w: (w.weights_generation, w.name))
    beat = (router.beat_interval_s if beat_interval_s is None
            else float(beat_interval_s))
    sp = router.spawn
    if runtimes is None and sp is None:
        raise ValueError("rolling_upgrade without runtimes upgrades a "
                         "process fleet (build_proc_fleet's router)")
    files: Dict[str, str] = {}
    m0 = router.metrics()
    upgraded = []
    for old in targets:
        new_name = f"{old.name}.g{int(generation)}"
        if runtimes is None:
            if old.model_id not in files:
                files[old.model_id] = write_params_file(
                    os.path.join(sp["lane_dir"], f"fleet_params."
                                 f"{old.model_id}.g{int(generation)}.pkl"),
                    new_params, head_dim=int(head_dim),
                    model_id=old.model_id,
                    weights_generation=int(generation),
                    **dict(sp["worker_kwargs"], **(worker_kwargs or {})))
            proc = spawn_worker(
                sp["lane_dir"], files[old.model_id], new_name, old.role,
                epoch=1, beat_interval_s=beat, bundle_dir=sp["bundle_dir"],
                journal_dir=sp["journal_dir"], device=sp["device"],
                env=sp["env"], worker_cmd=sp["worker_cmd"], tp=sp["tp"])
        else:
            proc = None
            rt = WorkerRuntime(
                new_name, old.role, new_params, router.store,
                head_dim=int(head_dim), epoch=1, beat_interval_s=beat,
                model_id=old.model_id,
                weights_generation=int(generation),
                **(worker_kwargs or {}))
            _threading.Thread(target=rt.run, daemon=True,
                              name=f"upgrade-{new_name}").start()
            runtimes.append(rt)
        router.add_worker(WorkerClient(new_name, old.role, router.store,
                                       epoch=1, lane_config=router.lane_config,
                                       proc=proc, model_id=old.model_id))
        deadline = time.monotonic() + float(timeout_s)
        while router.workers[new_name].state != "live":
            router.step()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rolling_upgrade: replacement {new_name} not live "
                    f"within {timeout_s}s")
            time.sleep(0.005)
        router.drain(old.name)
        if not router.wait_drained(old.name, timeout_s=timeout_s):
            raise TimeoutError(
                f"rolling_upgrade: {old.name} not drained within "
                f"{timeout_s}s")
        upgraded.append({"old": old.name, "new": new_name})
        _flight.note("fleet", event="weights_upgraded", old=old.name,
                     new=new_name, generation=int(generation))
    m1 = router.metrics()
    return {
        "generation": int(generation),
        "upgraded": upgraded,
        "drain_shed": int(m1.get("fleet/shed_inflight_total", 0)
                          - m0.get("fleet/shed_inflight_total", 0)),
        "rejected_delta": int(m1.get("fleet/rejected_total", 0)
                              - m0.get("fleet/rejected_total", 0)),
    }
