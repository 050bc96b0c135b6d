"""Disaggregated prefill / decode serving: role-split workers.

Counterpart of ``chainermn_tpu/serving/disagg.py``.  Prefill is
compute-bound (one whole-prompt forward through the flash kernels), decode
is memory-bound (one cache-streaming tick through the decode or beam
kernel); the fused engine runs both in one loop, so a burst of arrivals
sits between decode ticks and stretches every running request's
inter-token gap.  This module splits the roles:

* :class:`PrefillWorker` owns a small STAGING pool and only prefills.  A
  finished prefill's KV slab and request metadata leave at once over the
  transfer plane, and the staging slot is recycled.
* :class:`DecodeWorker` is a :class:`~chainermn_tpu_torch.serving.frontend
  .ServingEngine` that never prefills: requests arrive only as transferred
  slabs landed in reserved slots (``ServingEngine.install_request``), so
  its tick runs back to back.
* :class:`DisaggRouter` composes them: prompts go to the least-loaded live
  prefill worker, finished slabs to the decode worker with the most free
  (reservation-aware) slots that can still meet the request's deadline.
  Transfers ride :class:`~chainermn_tpu_torch.serving.transfer
  .KvTransferPlane`: the same-process row copy (``"local"``) or pack, an
  object lane and unpack (``"lanes"``), the publish wall booked in the
  prefill worker's goodput ledger under its own ``transfer`` bucket.

A transfer is split at the role boundary.  The prefill side chooses the
destination, RESERVES its slot and (lanes) publishes the packed slab; the
landing (lane get and unpack, or the local copy), the reservation's commit
and ``install_request`` happen on the decode worker's own step, through a
per-worker inbox.  So only a decode worker's loop touches its pool, and
:meth:`DisaggRouter.start` can run one driver thread per role;
:meth:`DisaggRouter.step` / :meth:`DisaggRouter.run` keep the
deterministic single-thread interleave (the prefill round, then the decode
round) for tests.

On one card both role threads launch on the one current CUDA stream, as
the fused engine does, and take turns at the GIL: a prefill's launches and
a tick's interleave on the host and on the stream.

Failure domain (the one place a :class:`~chainermn_tpu_torch.communicators
.base.DcnLaneError` is caught in this package): a lane fault during a
transfer takes ONE worker out, not the fleet.  The destination reservation
is cancelled (a decode worker is never wedged), the victim is marked dead,
a flight bundle whose ring names the lane is written, and the request is
requeued on a surviving prefill worker (a re-prefill: the slab died with
the lane) or, with no survivor or no retry budget left, shed in the
``AdmissionError.to_dict()`` shape with reason ``worker_lost``.

Transfer destinations are first-class reservations of the slot allocator:
a reserved slot is invisible to ``free_count``, so a decode worker's
admission arithmetic never hands an in-flight transfer's slot to anyone
else.

Tensor parallelism (``mesh=`` with a model axis > 1; ``params`` this
rank's shards): JAX runs the fleet on one mesh in one process.  Here every
model rank is a process, and the fleet has ONE leader: model rank 0 hosts
the router and every worker, and all the workers' engines share one
:class:`~chainermn_tpu_torch.serving.engine.ModelPlan`, so each prefill,
tick, position reset and transfer is announced naming its engine and then
run, as one step under the plan's lock (the role threads of
:meth:`DisaggRouter.start` never interleave their collectives).  The other
ranks build the same fleet and call :meth:`DisaggRouter.follow`.  The
``local`` transport is a row copy on every rank, each its own columns; the
``lanes`` transport gathers the ranks' columns into one global slab before
the pack (its bytes and CRC are those of JAX's global pool, the ledger row
is booked once, on the leader) and, after the leader checked it, lands
each rank's columns.  A cancelled reservation resets the slot's position
on every rank; requeues, sheds and a lost worker change only the leader's
host state.  :meth:`DisaggRouter.close` releases the followers once, also
when a worker's close raises.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import observability as obs
from .._device import resolve_device
from ..communicators.base import DcnLaneError
from ..convert import tree_map
from ..observability import flight as _flight
from ..observability.slo import (GoodputLedger, ReservoirSample,
                                 SLOTracker, percentile_of)
from ..parallel.decode import _kv_heads
from .cache_pool import CachePool
from .engine import DecodeEngine
from .frontend import RequestHandle, ServingEngine, _request_row
from .router import RouterBase
from .scheduler import AdmissionError, Request, Scheduler
from .transfer import KvTransferPlane


def request_wire(req: Request, first_tokens) -> Dict[str, Any]:
    """The request metadata that rides the transfer plane with a slab:
    everything a decode worker needs to continue the generation exactly
    (the deadline RELATIVE: monotonic clocks do not cross processes)."""
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
                else [int(x) for x in np.asarray(req.rng).reshape(2)]),
        "tokens": [int(t) for t in first_tokens],
    }


class PrefillWorker:
    """Role-split worker that only prefills.

    Owns a bounded admission queue (the fused engine's FIFO and
    backpressure policy) and a small staging pool whose slots live only
    from prefill to transfer.  ``step(fleet)`` is one iteration: expire
    overdue queued work, admit up to ``min(free staging slots, decode
    capacity, max_prefills_per_tick)``, prefill each admission, hand the
    slab to ``fleet.transfer_out`` and recycle the staging slot.
    ``params`` are the model's tensors on ``device`` (not copied)."""

    role = "prefill"

    def __init__(self, name: str, params, *, head_dim: int,
                 n_slots: int = 2, max_total: int = 128, mesh=None,
                 axis_name: str = "model", queue_capacity: int = 16,
                 max_prefills_per_tick: int = 1,
                 prefill_bucket: int = 1, device="cuda", plan=None):
        dev = resolve_device(device)
        self.name = str(name)
        params = tree_map(params, lambda t: t.to(dev))
        n_kv = _kv_heads(params, head_dim)
        self.pool = CachePool(n_slots, max_total, len(params["blocks"]),
                              n_kv * head_dim, params["embed"].dtype, dev)
        self.engine = DecodeEngine(params, self.pool, mesh, axis_name,
                                   head_dim=head_dim,
                                   prefill_bucket=prefill_bucket, plan=plan)
        self.scheduler = Scheduler(
            queue_capacity, max_total,
            max_prefills_per_tick=max_prefills_per_tick,
            max_positions=self.engine.max_positions)
        self.goodput = GoodputLedger()
        self.dead = False
        self.prefills = 0
        self.transfer_failures = 0
        self._t0 = time.monotonic()
        self._last_step_end: Optional[float] = None

    # ---- dispatch inputs ----
    def load(self) -> Dict[str, Any]:
        queued = self.scheduler.queued_requests()
        return {
            "name": self.name,
            "dead": self.dead,
            "queue_depth": len(queued),
            "queue_capacity": self.scheduler.queue_capacity,
            "free_slots": self.pool.free_count,
            # prefill cost only: the decode remainder is the decode
            # worker's backlog, not this one's
            "backlog_tokens": sum(r.prompt_len for r in queued),
        }

    def submit_request(self, req: Request, now: float) -> None:
        """Scheduler admission behind the engine's padded-length check
        (the fused frontend's bucket-aware bound)."""
        self.engine.check_padded_fit(req.prompt_len, "staging")
        self.scheduler.submit(req, now)

    # ---- the worker iteration ----
    def step(self, fleet: "DisaggRouter") -> int:
        """One prefill-worker iteration; returns the prefills completed."""
        if self.dead:
            return 0
        t0 = time.monotonic()
        last = (self._last_step_end if self._last_step_end is not None
                else self._t0)
        gap = t0 - last
        if gap > 0:
            self.goodput.add("queue_wait" if self.scheduler.queue_depth
                             else "stall", gap)
        t_host = t0
        now = time.monotonic()
        for req in self.scheduler.expire_queued(now):
            obs.instant("serving/request/expired", cat="serving",
                        request=req.id, trace_id=req.trace_id)
            fleet._finish_tracing(req, "deadline")
        # admit no more prefills than the decode side can take this
        # round: a slab with no destination is a wasted whole-prompt
        # forward (the requeue fallback still catches races)
        budget = min(self.pool.free_count, fleet.decode_free_slots())
        worked = 0
        for req in self.scheduler.admissions(budget, now):
            slot = self.pool.acquire()
            t_admit = time.monotonic()
            req.timestamps["prefill_start"] = t_admit
            t_us = getattr(req, "trace_us", None)
            if t_us is not None:
                now_us = obs.now_us()
                obs.complete_event(
                    "request/queue_wait", t_us["submitted"],
                    now_us - t_us["submitted"], cat="serving_request",
                    trace_id=req.trace_id, request=req.id)
            self.goodput.add("host", t_admit - t_host)
            compiles_before = self.engine.prefill_compiles
            t_pf = time.monotonic()
            try:
                with obs.span("serving/prefill", cat="serving_request",
                              request=req.id, trace_id=req.trace_id,
                              slot=slot, worker=self.name):
                    # ends in a device-to-host read of the first token:
                    # the slab's rows are written when it returns
                    first = self.engine.prefill_into_slot(
                        req.prompt, slot, rng=req.rng,
                        temperature=req.temperature)
            except Exception as e:  # noqa: BLE001 — the request errors,
                # the worker keeps serving the rest
                t_host = time.monotonic()
                self.goodput.add("compute", t_host - t_pf)
                self.pool.release(slot)
                req.finish("error", time.monotonic())
                _flight.note("disagg", event="prefill_error",
                             worker=self.name, request=req.id,
                             trace_id=req.trace_id, error=repr(e))
                fleet._finish_tracing(req, "error")
                continue
            t_host = time.monotonic()
            self.goodput.add(
                "compile" if self.engine.prefill_compiles
                > compiles_before else "compute", t_host - t_pf)
            self.prefills += 1
            # the slab leaves over the plane, which takes ownership of the
            # staging slot: lanes mode packs and releases it here, local
            # mode holds it busy until the decode side's landing copies the
            # rows out.  The publish wall (choose / reserve / pack / put) is
            # this thread's transfer cost; the landing is the decode
            # worker's, booked by its own ledger (each ledger partitions
            # only its own thread's wall)
            t_xfer = time.monotonic()
            fleet.transfer_out(self, req, slot, first)
            t_host = time.monotonic()
            self.goodput.add("transfer", t_host - t_xfer)
            worked += 1
        t_end = time.monotonic()
        self.goodput.add("host", t_end - t_host)
        self._last_step_end = t_end
        if worked:
            _flight.note("phase", name="disagg/prefill_step",
                         worker=self.name, prefills=worked)
        return worked

    def kill(self) -> None:
        """Chaos face: the worker stops working (the router's health
        sweep re-dispatches its queue)."""
        self.dead = True

    @property
    def idle(self) -> bool:
        # a busy staging slot is a prefill or transfer in flight on the
        # driver thread even when the queue just drained: without it a
        # drain poll between the queue pop and the inbox handoff could
        # declare the fleet done under an in-flight request
        return self.dead or (self.scheduler.queue_depth == 0
                             and self.pool.busy_count == 0)

    def introspect_state(self) -> Dict[str, Any]:
        return {
            "role": self.role,
            "dead": self.dead,
            "queue_depth": self.scheduler.queue_depth,
            "free_slots": self.pool.free_count,
            "prefills": self.prefills,
            "prefill_compiles": self.engine.prefill_compiles,
            "transfer_failures": self.transfer_failures,
            "goodput": self.goodput.report(),
            "queued": [_request_row(r)
                       for r in self.scheduler.queued_requests()],
        }


class DecodeWorker:
    """Role-split worker that only ticks.

    A thin wrapper over :class:`ServingEngine` whose admission path is
    never used: requests arrive as transferred slabs through
    ``engine.install_request`` into slots the router reserved.  Its
    prefix cache is off (a decode worker never sees a prompt before its
    K/V exists) and so is its spill tier, as in JAX's decode worker.

    ``inbox`` holds in-flight transfers addressed to this worker (appended
    by the router on the prefill side, drained at the start of this
    worker's round): the one-way handoff that keeps every touch of this
    worker's pool on its own driver thread."""

    role = "decode"

    def __init__(self, name: str, params, *, head_dim: int,
                 n_slots: int = 4, max_total: int = 128, mesh=None,
                 axis_name: str = "model",
                 slo: Optional[SLOTracker] = None,
                 stats_capacity: int = 1024, device="cuda", plan=None):
        self.name = str(name)
        self.inbox: deque = deque()   # append / popleft are GIL-atomic
        # no spill tier: JAX's decode worker has none (and it would need
        # the prefix cache, which is off)
        self.engine = ServingEngine(
            params, head_dim=head_dim, n_slots=n_slots,
            max_total=max_total, mesh=mesh, axis_name=axis_name,
            queue_capacity=1, max_prefills_per_tick=1,
            prefix_cache=False, spill_bytes=0, slo=slo,
            stats_capacity=stats_capacity, device=device, plan=plan)

    def load(self) -> Dict[str, Any]:
        eng = self.engine
        with eng._lock:
            running = list(eng._running.values())
        backlog = sum(max(r.max_new_tokens - len(r.tokens), 0)
                      for r in running)
        return {
            "name": self.name,
            "free_slots": eng.pool.free_count,       # excludes reserved
            "reserved_slots": eng.pool.reserved_count,
            "busy_slots": eng.pool.busy_count,
            "backlog_tokens": int(backlog),
        }

    def token_latency_ms(self, default: float = 20.0) -> float:
        p50 = self.engine._tok_lat_ms.percentile(50)
        return float(p50) if p50 else float(default)

    def step(self):
        return self.engine.step()

    @property
    def idle(self) -> bool:
        # reserved slots are transfers addressed here whose inbox entry
        # may not have landed yet: they count as work
        return (self.engine.pool.busy_count == 0
                and self.engine.pool.reserved_count == 0
                and not self.inbox)

    def introspect_state(self) -> Dict[str, Any]:
        state = self.engine.introspect_state()
        state["role"] = self.role
        return state


class DisaggRouter(RouterBase):
    """Role-aware dispatch over prefill and decode workers.

    * **Prompts** go to the least-loaded live prefill worker (fewest
      backlog prompt tokens, ties to the emptier queue, then round-robin),
      behind the replica router's SLO-burn and tenant gates.
    * **Slabs** (called back from a prefill worker's step) go to the
      decode worker with the most FREE (reservation-aware) slots whose
      backlog at its measured token latency still fits the request's
      deadline; its slot is reserved before the transfer starts and
      committed when the slab lands.
    * **Transport**: ``transport_mode="local"`` copies the rows between
      the pools on the card; ``"lanes"`` packs, ships over the object lane
      and unpacks, booking the slab bytes in the comm ledger (the
      cross-process wire, exercised in one process so the chaos and
      exactness tests cover the lane discipline).
    """

    ROLE = "disagg"

    def __init__(self, prefill_workers: Sequence[PrefillWorker],
                 decode_workers: Sequence[DecodeWorker], *,
                 plane: Optional[KvTransferPlane] = None,
                 transport_mode: str = "local",
                 slo: Optional[SLOTracker] = None,
                 shed_burn_threshold: float = 1.0,
                 tenancy=None,
                 paid_burn_headroom: float = 2.0,
                 default_token_latency_ms: float = 20.0,
                 metrics_writer=None,
                 max_transfer_attempts: int = 2,
                 bundle_dir: Optional[str] = None,
                 lane_timeout_s: float = 10.0):
        if not prefill_workers or not decode_workers:
            raise ValueError("need at least one worker per role")
        if transport_mode not in ("local", "lanes"):
            raise ValueError(f"transport_mode must be local|lanes, "
                             f"got {transport_mode!r}")
        super().__init__(
            metrics_writer=metrics_writer, tenancy=tenancy, slo=slo,
            shed_burn_threshold=shed_burn_threshold,
            paid_burn_headroom=paid_burn_headroom,
            default_token_latency_ms=default_token_latency_ms)
        self.prefill_workers: List[PrefillWorker] = list(prefill_workers)
        self.decode_workers: List[DecodeWorker] = list(decode_workers)
        names = [w.name for w in self.prefill_workers] \
            + [w.name for w in self.decode_workers]
        if len(set(names)) != len(names):
            raise ValueError(f"worker names must be unique: {names}")
        self.plane = plane or KvTransferPlane()
        self.transport_mode = transport_mode
        self.max_transfer_attempts = int(max_transfer_attempts)
        self.bundle_dir = bundle_dir
        self.lane_timeout_s = float(lane_timeout_s)
        self._rr = 0
        self._dispatched = 0
        self._dispatched_by: Dict[str, int] = {
            w.name: 0 for w in self.prefill_workers}
        self._transfers = 0
        self._requeues = 0
        self._shed_inflight = 0   # sheds of already-dispatched requests
        self._transfer_ms = ReservoirSample(1024)
        self._threads: List[Any] = []
        self._stop_flag = False
        _flight.register_provider("disagg_router", self.introspect_state)
        _flight.register_provider("disagg_prefill", self._prefill_state)
        _flight.register_provider("disagg_decode", self._decode_state)

    # ---- submission (prompts -> prefill workers) ----
    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token=None, temperature: float = 0.0,
               rng=None, tenant: Optional[str] = None,
               priority: Optional[str] = None) -> RequestHandle:
        """Dispatch to the least-loaded live prefill worker, or raise
        :class:`AdmissionError` with the machine-readable payload (reason,
        ``retry_after_ms``, ``queue_depth``).  ``tenant`` / ``priority``
        bill the request to a tenant class."""
        trace_id = self._mint_trace_id()
        now = time.monotonic()
        t0_us = obs.now_us()
        t_submit = time.monotonic()
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        temperature = float(temperature)
        if temperature > 0.0 and rng is None:
            raise ValueError(
                "temperature > 0 samples tokens and needs an explicit rng "
                "key (prng.PRNGKey(...)): a silent default key would make "
                "every sampled request draw identical token sequences")
        key = (None if rng is None
               else np.asarray(rng).astype(np.uint32).reshape(2))

        live = [w for w in self.prefill_workers if not w.dead]
        loads = [w.load() for w in live]
        fleet_depth = sum(ld["queue_depth"] for ld in loads)
        fleet_cap = sum(ld["queue_capacity"] for ld in loads)
        if not live:
            self._reject(
                "worker_lost", trace_id,
                f"all {len(self.prefill_workers)} prefill workers are "
                f"dead", retry_after_ms=1.0, queue_depth=0,
                tenant=tenant)
        # the tenant plane, then the shared SLO-burn gate (best-effort at
        # the base threshold, paid with paid_burn_headroom x more room)
        tenant, max_new_tokens, capped = self._admit_tenant(
            trace_id, tenant, priority, max_new_tokens,
            queue_depth=fleet_depth, queue_capacity=fleet_cap,
            retry_after_ms=self._retry_after_ms)
        self._maybe_shed_slo(trace_id, fleet_depth,
                             self._retry_after_ms, tenant)
        if deadline_s is not None:
            # feasibility against the DECODE side: the generation must fit
            # behind the least-loaded decode worker's backlog
            waits = [self._est_wait_ms(dw) for dw in self.decode_workers]
            if min(waits) / 1e3 >= deadline_s:
                self._reject(
                    "shed_slo", trace_id,
                    "no decode worker can start before the request "
                    f"deadline (deadline_s={deadline_s})",
                    retry_after_ms=self._retry_after_ms(),
                    queue_depth=fleet_depth, tenant=tenant)

        candidates = [
            (ld["backlog_tokens"], ld["queue_depth"],
             (i - self._rr) % len(live), w)
            for i, (w, ld) in enumerate(zip(live, loads))
            if ld["queue_depth"] < ld["queue_capacity"]]
        if not candidates:
            self._reject(
                "queue_full", trace_id,
                f"all {len(live)} live prefill-worker queues at capacity",
                retry_after_ms=self._retry_after_ms(),
                queue_depth=fleet_depth, tenant=tenant)
        _, _, _, pw = min(candidates)
        self._rr = (self._rr + 1) % max(len(live), 1)

        if self.tenancy is not None and tenant is not None:
            # per-tenant TTFT and goodput ride the stream (the decode
            # worker's engine owns it after the transfer hop)
            on_token = self.tenancy.wrap_on_token(tenant, t_submit,
                                                  on_token)
        req = Request(prompt, max_new_tokens, eos_id=eos_id,
                      deadline_t=(now + deadline_s
                                  if deadline_s is not None else None),
                      on_token=on_token, trace_id=trace_id,
                      temperature=temperature, rng=key, tenant=tenant)
        self._stamp_tenant_meta(req, tenant)
        req.trace_us = {"submitted": obs.now_us()}
        obs.async_event("b", "request", trace_id, cat="serving_request",
                        request=req.id, prompt_len=req.prompt_len)
        try:
            pw.submit_request(req, now)
        except AdmissionError as e:
            obs.async_event("e", "request", trace_id,
                            cat="serving_request", reason="rejected",
                            admission_reason=e.reason)
            self._reject(e.reason, trace_id, str(e),
                         retry_after_ms=self._retry_after_ms(),
                         queue_depth=fleet_depth, tenant=tenant)
        if self.tenancy is not None and tenant is not None:
            self.tenancy.on_admit(self.tenancy.resolve(tenant), req,
                                  capped=capped)
        with self._lock:
            self._dispatched += 1
            self._dispatched_by[pw.name] += 1
        obs.complete_event(
            "disagg/dispatch", t0_us, obs.now_us() - t0_us,
            cat="serving_request", trace_id=trace_id, worker=pw.name,
            fleet_queue_depth=fleet_depth)
        _flight.note("disagg", event="dispatched", trace_id=trace_id,
                     worker=pw.name)
        return RequestHandle(req)

    def _est_wait_ms(self, dw: DecodeWorker, load=None) -> float:
        """Estimated ms before ``dw`` can start new work: its decode
        backlog priced at its measured token latency (the one feasibility
        estimate admission, dispatch and back-off hints share)."""
        ld = load if load is not None else dw.load()
        return float(ld["backlog_tokens"] * dw.token_latency_ms(
            self.default_token_latency_ms))

    def _retry_after_ms(self) -> float:
        """Drain-aware back-off hint: the least-loaded decode worker's
        queued tokens priced at the fleet's measured recent tokens/s."""
        backlog = min(dw.load()["backlog_tokens"]
                      for dw in self.decode_workers)
        tokens_total = sum(dw.engine._tokens_emitted
                           for dw in self.decode_workers)
        return self._derive_retry_ms(backlog, tokens_total)

    # ---- the transfer hop (slabs -> decode workers) ----
    def decode_free_slots(self) -> int:
        """Fleet-wide transferable capacity: free slots after in-flight
        reservations (the allocator keeps them disjoint)."""
        return sum(dw.engine.pool.free_count for dw in self.decode_workers)

    def _choose_decode(self, req: Request) -> Optional[DecodeWorker]:
        """The most-free decode worker that can still meet the request's
        deadline; None when no worker has a free slot (the caller
        requeues) or none is feasible."""
        best, best_key = None, None
        for dw in self.decode_workers:
            ld = dw.load()
            if ld["free_slots"] < 1:
                continue
            if req.deadline_t is not None:
                wait_s = self._est_wait_ms(dw, ld) / 1e3
                if time.monotonic() + wait_s >= req.deadline_t:
                    continue
            key = (-ld["free_slots"], ld["backlog_tokens"])
            if best_key is None or key < best_key:
                best, best_key = dw, key
        return best

    def _deadline_feasible(self, req: Request) -> bool:
        """Whether ANY decode worker could still meet ``req``'s deadline,
        slots aside (slots free up; a blown deadline never does)."""
        now = time.monotonic()
        return any(
            now + self._est_wait_ms(dw) / 1e3 < req.deadline_t
            for dw in self.decode_workers)

    def transfer_out(self, pw: PrefillWorker, req: Request,
                     src_slot: int, first_tok: int) -> bool:
        """The PREFILL side of a transfer: pick a destination, reserve its
        slot, publish the slab and hand the landing to the decode worker's
        inbox.  Takes ownership of the staging slot: lanes mode packs and
        releases it here, local mode keeps it busy until
        :meth:`_land_transfer` copies the rows out.  On a lane fault the
        reservation is cancelled, the victim marked dead with a bundle, and
        the request requeued on a survivor or shed.  Returns True when the
        slab is in flight."""
        length = int(pw.pool.pos[src_slot])
        dw = self._choose_decode(req)
        if dw is None:
            pw.pool.release(src_slot)
            if req.deadline_t is not None \
                    and not self._deadline_feasible(req):
                # no decode worker can meet the deadline even with a free
                # slot: requeueing would re-prefill the doomed request
                # every round until it expires; expire it now
                req.finish("deadline", time.monotonic())
                obs.instant("serving/request/expired", cat="serving",
                            request=req.id, trace_id=req.trace_id)
                self._finish_tracing(req, "deadline")
                return False
            # no destination now (every slot busy or reserved): retry once
            # decode drains, at the cost of a re-prefill, which the staging
            # budget gate keeps rare
            pw.scheduler.requeue_front(req)
            with self._lock:
                self._requeues += 1
            _flight.note("disagg", event="transfer_backpressure",
                         worker=pw.name, trace_id=req.trace_id)
            return False
        dst = dw.engine.pool.reserve()
        assert dst is not None  # _choose_decode saw a free slot
        t0 = time.monotonic()
        entry = {"req": req, "src_worker": pw, "dst_slot": dst,
                 "length": length, "first_tok": int(first_tok),
                 "t0": t0, "t0_us": obs.now_us(),
                 "mode": self.transport_mode}
        if self.transport_mode == "lanes":
            tag = f"{req.trace_id}.slab"
            try:
                payload = pw.engine.pack_slab(
                    self.plane, src_slot, length,
                    meta=request_wire(req, [first_tok]))
                self.plane.lane_put(tag, payload)
            except DcnLaneError as e:
                # the wall is booked by the caller (PrefillWorker.step
                # brackets this whole method as "transfer")
                pw.pool.release(src_slot)
                self._cancel_reservation(dw, dst)
                self._on_transfer_fault(pw, req, e)
                return False
            # the slab is host bytes on the lane now: the staging slot
            # recycles before the landing
            pw.pool.release(src_slot)
            entry["tag"] = tag
        else:
            # local mode: the copy reads the staging rows on the DECODE
            # side, so the slot stays busy until it lands
            entry["src_slot"] = src_slot
        dw.inbox.append(entry)
        return True

    def _land_transfer(self, dw: DecodeWorker, entry: Dict[str, Any]
                       ) -> bool:
        """The DECODE side: land one inbox entry in its reserved slot (lane
        get and unpack, or the local copy), commit the reservation and
        install the request on the engine.  Runs on the decode worker's
        driver, the only thread that touches its pool.  A lane fault here
        cancels the reservation and takes the publish side's fault path."""
        req, pw = entry["req"], entry["src_worker"]
        dst, length = entry["dst_slot"], entry["length"]
        try:
            if entry["mode"] == "lanes":
                got = self.plane.lane_get(entry["tag"],
                                          self.lane_timeout_s)
                stats = dw.engine.engine.land_slab(self.plane, got, dst)
                # GC after a successful landing is best effort: a delete
                # fault must not kill the publisher (the slab arrived) nor
                # cancel a reservation whose slab is in the caches
                try:
                    self.plane.lane_delete(entry["tag"])
                except DcnLaneError as e:
                    _flight.note("disagg", event="gc_failed",
                                 tag=entry["tag"], lane=e.lane)
            else:
                # the copy is enqueued on the one current CUDA stream,
                # behind the prefill that wrote the staging rows: the
                # prefill thread read that prefill's first token back
                # before it published this entry
                stats = dw.engine.engine.copy_slab_from(
                    pw.engine, entry["src_slot"], dst, length, self.plane)
                pw.pool.release(entry["src_slot"])
        except DcnLaneError as e:
            if entry["mode"] == "lanes":
                # best-effort GC: a slab whose request is about to be
                # requeued or shed must not sit in the store forever
                try:
                    self.plane.lane_delete(entry["tag"])
                except DcnLaneError:
                    pass
            self._cancel_reservation(dw, dst)
            self._on_transfer_fault(pw, req, e)
            return False
        # end-to-end latency for the p50 / p99 metric only: the wall was
        # partitioned already (publish on the prefill thread's ledger,
        # landing in this worker's engine-gap attribution)
        ms = (time.monotonic() - entry["t0"]) * 1e3
        dw.engine.pool.commit_reservation(dst)
        dw.engine.install_request(req, dst, [entry["first_tok"]])
        with self._lock:
            self._transfers += 1
            self._transfer_ms.add(ms)
        obs.complete_event(
            "serving/kv_transfer", entry["t0_us"],
            obs.now_us() - entry["t0_us"], cat="serving_request",
            request=req.id, trace_id=req.trace_id, src=pw.name,
            dst=dw.name, length=length, mode=stats["mode"])
        _flight.note("disagg", event="transfer", src=pw.name,
                     dst=dw.name, trace_id=req.trace_id, slot=dst,
                     length=length, mode=stats["mode"],
                     ledger_bytes=stats["ledger_bytes"],
                     ms=round(ms, 3))
        return True

    @staticmethod
    def _cancel_reservation(dw: DecodeWorker, slot: int) -> None:
        """Give a reserved slot back, its position reset on every model
        rank (a follower's mirror keeps no allocator, only positions)."""
        dw.engine.engine.reset_slot(slot)
        dw.engine.pool.cancel_reservation(slot)

    def _on_transfer_fault(self, pw: PrefillWorker, req: Request,
                           err: DcnLaneError) -> None:
        """A transfer lane died: the victim leaves the fleet, the evidence
        is on disk, and the request retries on a survivor (a re-prefill)
        or is shed in the wire shape."""
        pw.dead = True
        pw.transfer_failures += 1
        _flight.note("disagg", event="worker_lost", worker=pw.name,
                     lane=err.lane, attempts=err.attempts,
                     trace_id=req.trace_id)
        if self.bundle_dir:
            _flight.dump_bundle(self.bundle_dir, "kv_transfer_fault",
                                extra={"worker": pw.name,
                                       "lane": err.lane,
                                       "trace_id": req.trace_id})
        attempts = getattr(req, "transfer_attempts", 0) + 1
        req.transfer_attempts = attempts
        survivors = [w for w in self.prefill_workers if not w.dead]
        if survivors and attempts < self.max_transfer_attempts:
            # re-prefill on a survivor: the slab died with the lane
            survivors[0].scheduler.requeue_front(req)
            with self._lock:
                self._requeues += 1
            _flight.note("disagg", event="requeued", worker=pw.name,
                         to=survivors[0].name, trace_id=req.trace_id,
                         attempt=attempts)
            return
        self._shed_request(
            req,
            f"prefill worker {pw.name} lost mid-transfer on lane "
            f"'{err.lane}' with no retry budget "
            f"({attempts}/{self.max_transfer_attempts} attempts, "
            f"{len(survivors)} survivor(s))")

    def _shed_request(self, req: Request, detail: str) -> None:
        """Shed an already-accepted request machine-readably: the
        ``AdmissionError.to_dict()`` shape of a submit-time rejection,
        attached to the handle (``shed_payload``), streamed as a
        ``disagg_shed`` JSONL record and counted under ``worker_lost``."""
        if self.tenancy is not None:
            self.tenancy.count_shed(req.tenant, "worker_lost")
        shed = AdmissionError(
            "worker_lost", detail,
            retry_after_ms=self._retry_after_ms(),
            queue_depth=sum(w.scheduler.queue_depth
                            for w in self.prefill_workers),
            tenant=req.tenant,
            rung=(None if self.tenancy is None
                  else self.tenancy.ladder.rung))
        with self._lock:
            self._rejected["worker_lost"] = \
                self._rejected.get("worker_lost", 0) + 1
            self._shed_inflight += 1
        req.shed_payload = shed.to_dict()
        req.finish("shed", time.monotonic())
        if self.metrics_writer is not None:
            self.metrics_writer.write(
                dict(reason="worker_lost", trace_id=req.trace_id,
                     **{f"disagg/{k}": v for k, v in shed.to_dict().items()
                        if not isinstance(v, str)}),
                kind="disagg_shed")
        _flight.note("disagg", event="shed", reason="worker_lost",
                     trace_id=req.trace_id, payload=req.shed_payload)
        self._finish_tracing(req, "shed")

    def _finish_tracing(self, req: Request, reason: str) -> None:
        obs.async_event("e", "request", req.trace_id,
                        cat="serving_request", reason=reason,
                        n_tokens=len(req.tokens))
        _flight.note("disagg", event="finished", request=req.id,
                     trace_id=req.trace_id, reason=reason)

    # ---- driving ----
    def step_prefill(self) -> int:
        """One PREFILL-role round: re-dispatch dead workers' queues, then
        every live prefill worker with queued work prefills and publishes
        its slabs.  Returns how many workers still carry work."""
        return self._prefill_round()[1]

    def _prefill_round(self):
        """:meth:`step_prefill`'s round; returns ``(prefills completed,
        workers still carrying work)``."""
        # health sweep: a dead worker's queue goes to a survivor (or is
        # shed machine-readably), never stranded
        for pw in self.prefill_workers:
            if pw.dead and pw.scheduler.queue_depth:
                survivors = [w for w in self.prefill_workers
                             if not w.dead]
                waiting = pw.scheduler.drain()
                if survivors:
                    for req in reversed(waiting):
                        survivors[0].scheduler.requeue_front(req)
                    with self._lock:
                        self._requeues += len(waiting)
                    _flight.note("disagg", event="queue_redispatched",
                                 worker=pw.name, to=survivors[0].name,
                                 n=len(waiting))
                else:
                    for req in waiting:
                        self._shed_request(
                            req, f"prefill worker {pw.name} dead with "
                                 f"no survivors")
        prefills = worked = 0
        for pw in self.prefill_workers:
            if not pw.idle:
                done = pw.step(self)
                prefills += done
                worked += 1 if done else 0
                # a worker with queued work that could not place a slab
                # still counts as busy: the fleet is not drained
                if pw.scheduler.queue_depth > 0:
                    worked += 1
        return prefills, worked

    def step_decode(self) -> int:
        """One DECODE-role round: every decode worker lands its inbox
        (commit and install) and ticks its active slots.  The only code
        path that touches a decode worker's pool: under :meth:`start` it
        is the decode thread's loop body."""
        worked = 0
        for dw in self.decode_workers:
            while dw.inbox:
                self._land_transfer(dw, dw.inbox.popleft())
                worked += 1
            if dw.engine.pool.busy_count > 0:
                dw.step()
                worked += 1
            else:
                # an idle round breaks the tick cadence: the next gap
                # would measure slab-arrival wait, not inter-token latency
                dw.engine._last_tick_start = None
        return worked

    def step(self) -> int:
        """One deterministic fleet round (tests and :meth:`run`): the
        prefill role's round, then the decode role's.  Returns how many
        workers worked (0: drained)."""
        return self.step_prefill() + self.step_decode()

    def run(self, steps_budget: Optional[int] = None) -> int:
        n = 0
        while steps_budget is None or n < steps_budget:
            if self.step() == 0:
                break
            n += 1
        return n

    def start(self) -> None:
        """Role-parallel drive: one driver thread per role.  The inbox
        handoff keeps each pool on one thread (prefill thread: admit,
        prefill, publish and reserve destinations; decode thread: land,
        commit, tick), so a prefill never sits between two decode ticks on
        the host."""
        import threading
        if self._threads:
            return
        self._stop_flag = False

        def loop(role_step, role):
            try:
                while not self._stop_flag:
                    if role_step() == 0:
                        time.sleep(0.001)
            except BaseException as e:
                # only DcnLaneError is handled (inside the transfer path);
                # anything else escaping a role driver dies loudly: a
                # silently dead thread would wedge the fleet
                _flight.note("disagg", event="driver_died", role=role,
                             error=repr(e))
                if self.bundle_dir:
                    _flight.dump_bundle(
                        self.bundle_dir, "disagg_driver_death",
                        extra={"role": role, "error": repr(e)})
                self._stop_flag = True
                raise

        # the prefill thread sleeps after a round that completed no
        # prefill (an empty queue, or one blocked on decode capacity)
        # instead of spinning: the tick is many Python-level launches, and
        # a thread spinning on the GIL beside them stretched an ~8 ms tick
        # of the decode-bench LM to ~0.4 s on an H100
        self._threads = [
            threading.Thread(target=loop,
                             args=(lambda: self._prefill_round()[0],
                                   "prefill"),
                             daemon=True, name="disagg-prefill"),
            threading.Thread(target=loop,
                             args=(self.step_decode, "decode"),
                             daemon=True, name="disagg-decode"),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop_flag = True
        alive = []
        for t in self._threads:
            t.join(timeout=10)
            if t.is_alive():
                alive.append(t)
        # wedged drivers stay on the list: start() refuses to double-drive
        # and close() refuses to tear the engines down under them
        self._threads = alive
        if alive:
            # landing a wedged driver's inbox from this thread would put
            # two threads into one pool: leave it and say so
            _flight.note("disagg", event="stop_timeout",
                         threads=[t.name for t in alive])
            return
        # land what the decode thread did not reach before the stop flag:
        # a reservation never outlives the drive
        for dw in self.decode_workers:
            while dw.inbox:
                self._land_transfer(dw, dw.inbox.popleft())

    def close(self) -> None:
        try:
            self.stop()
            if self._threads:
                # a wedged driver still owns its engine
                return
            for dw in self.decode_workers:
                dw.engine.close()
            self._unregister()
        finally:
            # the followers are released once, also on an error path
            self._release_followers()

    def _unregister(self) -> None:
        # identity-guarded: a newer fleet's registrations survive
        for name, fn in (("disagg_router", self.introspect_state),
                         ("disagg_prefill", self._prefill_state),
                         ("disagg_decode", self._decode_state)):
            if _flight._PROVIDERS.get(name) == fn:
                _flight.unregister_provider(name)

    def _decode_engines(self) -> list:
        return ([pw.engine for pw in self.prefill_workers]
                + [dw.engine.engine for dw in self.decode_workers])

    def _retire(self) -> None:
        for pw in self.prefill_workers:
            pw.pool.caches = []
        for dw in self.decode_workers:
            dw.engine.retire()
        self._unregister()

    def reset_stats(self) -> None:
        with self._lock:
            self._dispatched = 0
            self._dispatched_by = {w.name: 0
                                   for w in self.prefill_workers}
            self._rejected = {r: 0 for r in self._rejected}
            self._transfers = 0
            self._requeues = 0
            self._shed_inflight = 0
            self._transfer_ms = ReservoirSample(1024)
        for pw in self.prefill_workers:
            pw.goodput.reset()
            pw.prefills = 0
        for dw in self.decode_workers:
            dw.engine.reset_stats()

    # ---- metrics / introspection ----
    def metrics(self) -> Dict[str, float]:
        """Fleet summary under ``disagg/*`` (the Prometheus extra gauges
        and the ``disagg_summary`` record)."""
        with self._lock:
            dispatched = self._dispatched
            rejected = dict(self._rejected)
            transfers = self._transfers
            requeues = self._requeues
            shed_inflight = self._shed_inflight
            xfer_vals = self._transfer_ms.values()
        out: Dict[str, float] = {
            "disagg/prefill_workers": float(len(self.prefill_workers)),
            "disagg/decode_workers": float(len(self.decode_workers)),
            "disagg/dispatched_total": float(dispatched),
            "disagg/rejected_total": float(sum(rejected.values())),
            "disagg/transfers_total": float(transfers),
            "disagg/requeued_total": float(requeues),
            "disagg/dead_prefill_workers": float(
                sum(w.dead for w in self.prefill_workers)),
        }
        for reason, n in sorted(rejected.items()):
            out[f"disagg/rejected/{reason}"] = float(n)
        # a worker_lost shed of an already-dispatched request sits in both
        # counters: subtract it once so offered counts each request once
        offered = dispatched + sum(rejected.values()) - shed_inflight
        out["disagg/shed_rate"] = (
            sum(rejected.values()) / offered if offered else 0.0)
        if xfer_vals:
            out["disagg/transfer_p50_ms"] = percentile_of(xfer_vals, 50)
            out["disagg/transfer_p99_ms"] = percentile_of(xfer_vals, 99)
        for k, v in self.plane.stats().items():
            out[f"disagg/plane/{k}"] = v
        # decode-side roll-ups (the tick gap is disaggregation's payoff)
        tps = 0.0
        ttft_vals: List[float] = []
        gap_vals: List[float] = []
        for dw in self.decode_workers:
            m = dw.engine.metrics()
            tps += m["serving/tokens_per_sec"]
            ttft_vals.extend(dw.engine._ttft_ms.values())
            gap_vals.extend(dw.engine._tick_gap_ms.values())
            for k, v in m.items():
                out[f"disagg/{dw.name}/{k.split('/', 1)[1]}"] = v
        out["disagg/fleet_tokens_per_sec"] = tps
        if ttft_vals:
            out["disagg/fleet_ttft_p50_ms"] = percentile_of(ttft_vals, 50)
            out["disagg/fleet_ttft_p99_ms"] = percentile_of(ttft_vals, 99)
        if gap_vals:
            out["disagg/decode_tick_gap_p50_ms"] = percentile_of(
                gap_vals, 50)
            out["disagg/decode_tick_gap_p99_ms"] = percentile_of(
                gap_vals, 99)
            mean = sum(gap_vals) / len(gap_vals)
            out["disagg/decode_tick_gap_variance_ms2"] = (
                sum((g - mean) ** 2 for g in gap_vals) / len(gap_vals))
        for pw in self.prefill_workers:
            out[f"disagg/{pw.name}/prefills"] = float(pw.prefills)
            out[f"disagg/{pw.name}/queue_depth"] = float(
                pw.scheduler.queue_depth)
            out.update(pw.goodput.gauges(f"disagg/{pw.name}/goodput"))
        if self.tenancy is not None:
            out.update(self.tenancy.metrics())
        return out

    def requests_table(self) -> Dict[str, Any]:
        tables = {dw.name: dw.engine.requests_table()
                  for dw in self.decode_workers}
        for pw in self.prefill_workers:
            tables[pw.name] = {
                "schema": "chainermn_tpu.requestz.v1",
                "queued": [_request_row(r)
                           for r in pw.scheduler.queued_requests()],
                "running": [], "recent": [],
            }
        return {"schema": "chainermn_tpu.requestz.v1",
                "disagg": True, "workers": tables}

    def _prefill_state(self) -> Dict[str, Any]:
        return {w.name: w.introspect_state()
                for w in self.prefill_workers}

    def _decode_state(self) -> Dict[str, Any]:
        return {w.name: w.introspect_state()
                for w in self.decode_workers}

    def introspect_state(self) -> Dict[str, Any]:
        with self._lock:
            state: Dict[str, Any] = {
                "prefill_workers": [w.name for w in self.prefill_workers],
                "decode_workers": [w.name for w in self.decode_workers],
                "transport_mode": self.transport_mode,
                "dispatched": self._dispatched,
                "dispatched_by": dict(self._dispatched_by),
                "rejected": dict(self._rejected),
                "transfers": self._transfers,
                "requeues": self._requeues,
            }
        state["plane"] = self.plane.stats()
        if self.slo is not None:
            state["slo"] = self.slo.status()
        if self.tenancy is not None:
            state["tenancy"] = self.tenancy.state()
        return state

    def finalize_metrics(self) -> None:
        if self.metrics_writer is not None:
            self.metrics_writer.write(self.metrics(),
                                      kind="disagg_summary")

    def write_prometheus(self, path: str) -> str:
        from ..observability.export import write_prometheus_textfile
        return write_prometheus_textfile(path, extra_gauges=self.metrics())


def build_disagg_fleet(params, n_prefill: int, n_decode: int, *,
                       head_dim: int, max_total: int = 128,
                       n_slots: int = 4, staging_slots: int = 2,
                       mesh=None, axis_name: str = "model",
                       queue_capacity: int = 16,
                       max_prefills_per_tick: int = 1,
                       prefill_bucket: int = 1,
                       transport_mode: str = "local",
                       comm=None,
                       slo: Optional[SLOTracker] = None,
                       metrics_writer=None, device="cuda",
                       **router_kwargs) -> DisaggRouter:
    """Stand up a P:D disaggregated fleet on one card, the ``serve
    --disagg P:D`` face.  ``n_slots`` sizes each decode worker's pool,
    ``staging_slots`` each prefill worker's staging pool.  The params move
    to ``device`` once and every worker shares those tensors.  With
    ``mesh=`` (``params`` this rank's shards), every rank of the model
    axis calls this alike; the workers share one plan, and the ranks other
    than 0 then call ``follow()`` on the fleet.

    ``comm``: a :class:`~chainermn_tpu_torch.communicators.base
    .CommunicatorBase` whose ``kv_lane_transport()`` backs the lanes
    transport (its process group's store); without it the lanes run over
    a private in-process store."""
    dev = resolve_device(device)
    params = tree_map(params, lambda t: t.to(dev))
    plan = None
    if mesh is not None:
        from .engine import ModelPlan
        plan = ModelPlan(mesh.axis(axis_name))
    if comm is not None and transport_mode == "lanes" \
            and "plane" not in router_kwargs:
        router_kwargs["plane"] = KvTransferPlane(
            transport=comm.kv_lane_transport())
    prefills = [
        PrefillWorker(f"prefill{i}", params, head_dim=head_dim,
                      n_slots=staging_slots, max_total=max_total,
                      mesh=mesh, axis_name=axis_name,
                      queue_capacity=queue_capacity,
                      max_prefills_per_tick=max_prefills_per_tick,
                      prefill_bucket=prefill_bucket, device=dev, plan=plan)
        for i in range(int(n_prefill))]
    decodes = [
        DecodeWorker(f"decode{i}", params, head_dim=head_dim,
                     n_slots=n_slots, max_total=max_total, mesh=mesh,
                     axis_name=axis_name, slo=slo, device=dev, plan=plan)
        for i in range(int(n_decode))]
    return DisaggRouter(prefills, decodes, transport_mode=transport_mode,
                        slo=slo, metrics_writer=metrics_writer,
                        **router_kwargs)
