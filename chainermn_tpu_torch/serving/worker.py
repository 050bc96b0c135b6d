"""Worker-process role loops for the cross-process serving fleet.

Counterpart of ``chainermn_tpu/serving/worker.py``.  Each fleet member
runs a role loop in its own process on its own card, speaking to the
router only over the object lanes: request submits, streamed tokens,
results and KV slabs all ride the same wire (``lanes.py`` mailboxes and
``transfer.py`` slab tags), so a worker's death severs lanes, never shared
memory.  Three roles:

* ``engine``: a full :class:`~chainermn_tpu_torch.serving.frontend
  .ServingEngine` (prefix cache and spill tier on, a ``serve --fleet-procs
  N`` member): ``submit`` messages admit into its scheduler and pool,
  every emitted token streams back as a ``token`` message, and the
  terminal ``result`` message carries the authoritative token list
  (streamed tokens are hints; the router reconciles the result).  Every
  prefix-cache insert, eviction and spill is announced, so the router's
  fleet cache index mirrors it.
* ``prefill`` / ``decode``: the role split across processes (``serve
  --disagg P:D --procs``).  A prefill worker only prefills into a staging
  pool, publishes each finished slab on the lane (``slab/<trace_id>``)
  and announces it with ``slab_ready``; a decode worker receives
  router-forwarded ``install`` messages, reserves a slot, lands the slab
  through :meth:`~chainermn_tpu_torch.serving.transfer.KvTransferPlane
  .unpack_into` and ticks; it never prefills.

Every loop iteration drains the control inbox, does one round of role
work and reports finished requests; a side thread publishes the heartbeat
lease (``health.py``).  Every outbound message and lease carries the
worker's epoch; the router's ``EpochFence`` refuses stale stamps, so a
paused-then-resumed zombie lands no slab, token or lease.  ``drain`` stops
admission, finishes in-flight work, reports ``drained``, releases the
lease and exits 0.  The sampling key of a request rides the wire as two
uint32 words, the threefry key itself.

``python -m chainermn_tpu_torch.serving.worker --role engine --name w0
--lane-dir D --params P.pkl`` is the process entry the fleet spawner
execs; it initialises the card and loads the serving kernels before its
first lease.  :class:`WorkerRuntime` is transport-agnostic, so tests drive
the same loop in one process over the loopback store.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from ..observability import flight as _flight
from ..observability import journal as _journal
from .disagg import _refuse_tp
from .health import HeartbeatPublisher
from .lanes import MailboxReceiver, MailboxSender
from .scheduler import AdmissionError, Request, Scheduler
from .transfer import KvTransferPlane, _dtype_name

#: The kernel sources the serving roles launch (flash forward and the KV
#: append on a prefill, the decode kernel on an MHA tick, the beam kernel
#: on a GQA tick): a worker loads them before its first lease.
SERVING_SOURCES = ("flash_fwd", "kv_cache", "decode_attention",
                   "beam_attention")

ROLES = ("engine", "prefill", "decode")


def ctl_mailbox(worker: str) -> str:
    """Router → worker control mailbox name (single writer: router)."""
    return f"ctl.{worker}"


def out_mailbox(worker: str) -> str:
    """Worker → router outbox name (single writer: the worker)."""
    return f"out.{worker}"


def request_from_wire(wire: Dict[str, Any], *, on_token=None) -> Request:
    """Rebuild a host-side :class:`Request` from the submit/install wire
    dict (deadline rides RELATIVE — monotonic clocks do not cross
    processes)."""
    rel = wire.get("deadline_rel_s")
    rng = wire.get("rng")
    req = Request(
        [int(t) for t in wire["prompt"]],
        int(wire["max_new_tokens"]),
        eos_id=wire.get("eos_id"),
        deadline_t=(None if rel is None else time.monotonic() + float(rel)),
        on_token=on_token,
        trace_id=wire["trace_id"],
        temperature=float(wire.get("temperature", 0.0)),
        rng=(None if rng is None
             else np.asarray(rng, np.uint32).reshape(2)),
        tenant=wire.get("tenant"))
    # a decode-installed request never passes Scheduler.submit (the
    # only other place this is stamped) — TTFT/emit paths need it
    req.timestamps["submitted"] = time.monotonic()
    return req


class WorkerRuntime:
    """One fleet member's role loop (transport-agnostic).

    ``store`` is any object lane (``FileLaneStore`` across processes,
    ``InProcessLaneStore`` in one process: the same protocol and fault
    discipline).  ``params`` are the model's tensors, moved to ``device``.
    ``kill()`` is the chaos face: the runtime stops doing any work,
    heartbeats included, so to the supervisor it looks like a SIGKILLed
    process.  A mesh whose model axis spans more than one rank is refused
    (a fleet at TP > 1 is not ported).
    """

    def __init__(self, name: str, role: str, params, store, *,
                 head_dim: int, epoch: int = 1,
                 beat_interval_s: float = 0.05,
                 lane_config=None, lane_timeout_s: float = 10.0,
                 bundle_dir: Optional[str] = None,
                 n_slots: int = 4, max_total: int = 128,
                 queue_capacity: int = 16, staging_slots: int = 2,
                 max_prefills_per_tick: int = 1, prefill_bucket: int = 1,
                 mesh=None, axis_name: str = "model",
                 prefix_cache: bool = True,
                 spill_bytes: int = 32 << 20,
                 model_id: str = "default",
                 weights_generation: int = 1,
                 device="cuda"):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        _refuse_tp(mesh, axis_name)
        self.name = str(name)
        self.role = str(role)
        # heterogeneous-fleet identity: which model variant
        # this worker serves and which weight generation it holds; both
        # ride every lease so the router routes/upgrades per-model
        self.model_id = str(model_id)
        self.weights_generation = int(weights_generation)
        self.store = store
        self.epoch = int(epoch)
        self.lane_config = lane_config
        self.lane_timeout_s = float(lane_timeout_s)
        self.bundle_dir = bundle_dir
        self.inbox = MailboxReceiver(store, ctl_mailbox(name), lane_config)
        self.outbox = MailboxSender(store, out_mailbox(name), lane_config)
        self.heart = HeartbeatPublisher(
            store, name, role, self.epoch,
            beat_interval_s=beat_interval_s, lane_config=lane_config)
        self.plane = KvTransferPlane(transport=store,
                                     lane_config=lane_config)
        self.draining = False
        self.finished = False
        self.killed = False
        self._local: Dict[str, Any] = {}   # trace_id -> RequestHandle
        self._steps = 0
        self._beat_thread = None
        self._t_last_step = time.monotonic()

        # fleet KV-economy counters: they ride every lease so the
        # router's /metricsz can aggregate them fleet-wide
        self.cache_counters: Dict[str, int] = {
            "pull_serves": 0, "pull_stale": 0, "pull_installs": 0,
            "crc_refusals": 0}

        if role in ("engine", "decode"):
            from .frontend import ServingEngine
            self.engine = ServingEngine(
                params, head_dim=head_dim, n_slots=n_slots,
                max_total=max_total, axis_name=axis_name,
                queue_capacity=(queue_capacity if role == "engine" else 1),
                max_prefills_per_tick=max_prefills_per_tick,
                prefill_bucket=prefill_bucket,
                prefix_cache=(prefix_cache and role == "engine"),
                spill_bytes=(spill_bytes if role == "engine" else 0),
                device=device)
            self.pool = self.engine.pool
            self.scheduler = self.engine.scheduler
            if self.engine.prefix_cache is not None:
                # announce every cache lifecycle event over the wire:
                # the router's global index mirrors this worker's trie
                self.engine.on_cache_insert = self._announce_insert
                self.engine.on_cache_evict = self._announce_evict
                self.engine.on_spill_evict = self._announce_spill_evict
        else:  # prefill: a staging pool and the prefill path only
            from .._device import resolve_device
            from ..convert import tree_map
            from ..parallel.decode import _kv_heads
            from .cache_pool import CachePool
            from .engine import DecodeEngine
            dev = resolve_device(device)
            params = tree_map(params, lambda t: t.to(dev))
            n_kv = _kv_heads(params, head_dim)
            self.pool = CachePool(
                staging_slots, max_total, len(params["blocks"]),
                n_kv * head_dim, params["embed"].dtype, dev)
            self.dec_engine = DecodeEngine(
                params, self.pool, None, axis_name, head_dim=head_dim,
                prefill_bucket=prefill_bucket)
            self.scheduler = Scheduler(
                queue_capacity, max_total,
                max_prefills_per_tick=max_prefills_per_tick,
                max_positions=self.dec_engine.max_positions)
            self.engine = None

    # ---- outbound (every message stamped worker + epoch) ----
    def _send(self, kind: str, **fields) -> None:
        self.outbox.send(dict(fields, kind=kind, worker=self.name,
                              epoch=self.epoch))

    def _on_token(self, trace_id: str):
        def cb(tok: int, _rid: int) -> None:
            self._send("token", trace_id=trace_id, token=int(tok))
        return cb

    # ---- fleet KV economy: cache announces and pull serving ----
    def _geom(self) -> Dict[str, Any]:
        """Slab geometry the router needs to price a pull of this
        worker's prefixes in token units (transfer_cost statics)."""
        pool = self.engine.pool
        return {"n_layers": pool.n_layers, "kv_dim": pool.kv_dim,
                "dtype": _dtype_name(pool.caches[0][0].dtype),
                "model_id": self.model_id}

    def _announce_insert(self, entry) -> None:
        try:
            self._send("cache_announce", op="insert",
                       prefix=[int(t) for t in entry.seq],
                       length=int(entry.length), slot=int(entry.slot),
                       geom=self._geom())
        except Exception as e:  # noqa: BLE001 — the index is soft
            # state; a failed announce costs a missed pull opportunity,
            # never correctness
            _flight.note("worker", event="announce_failed",
                         worker=self.name, error=str(e))

    def _announce_evict(self, entry, spilled: bool) -> None:
        try:
            self._send("cache_announce", op="evict",
                       prefix=[int(t) for t in entry.seq],
                       length=int(entry.length), spilled=bool(spilled))
        except Exception as e:  # noqa: BLE001
            _flight.note("worker", event="announce_failed",
                         worker=self.name, error=str(e))

    def _announce_spill_evict(self, seq, length) -> None:
        try:
            # tier-scoped: the device trie may hold this sequence HOT
            # again (re-donated since the spill) — only a spill-tier
            # index record may be dropped by a spill-store eviction
            self._send("cache_announce", op="evict",
                       prefix=[int(t) for t in seq], length=int(length),
                       spilled=False, tier="spill")
        except Exception as e:  # noqa: BLE001
            _flight.note("worker", event="announce_failed",
                         worker=self.name, error=str(e))

    def _announce_snapshot(self) -> None:
        """Full index rebuild, riding the ``hello`` re-admission
        handshake: everything the router believed about this worker's
        cache died with the fenced epoch — replace it with what this
        incarnation actually holds (device trie + spill tier)."""
        eng = self.engine
        if eng is None or eng.prefix_cache is None:
            return
        entries = [
            {"seq": [int(t) for t in e.seq], "length": int(e.length),
             "tier": "hot"}
            for e in eng.prefix_cache.entries()]
        if eng.spill is not None:
            hot = {tuple(e["seq"]) for e in entries}
            entries += [
                {"seq": [int(t) for t in seq], "length": int(length),
                 "tier": "spill"}
                for seq, length in eng.spill.entries()
                if tuple(seq) not in hot]
        try:
            self._send("cache_announce", op="snapshot",
                       entries=entries, geom=self._geom())
        except Exception as e:  # noqa: BLE001
            _flight.note("worker", event="announce_failed",
                         worker=self.name, error=str(e))

    # ---- inbound control ----
    def _handle(self, msg: Dict[str, Any]) -> None:
        kind = msg.get("kind")
        if kind == "hello":
            # (re-)admission: adopt the router's freshly minted epoch —
            # everything this worker publishes from here on carries it,
            # so the fence re-opens for exactly this incarnation
            self.epoch = int(msg["epoch"])
            self.heart.epoch = self.epoch
            # the hello's HLC was already merged at mbx_recv; this event
            # marks the instant the new epoch takes effect worker-side —
            # the JAX conformance monitor's worker.process_hello action
            _journal.emit("hello_processed", worker=self.name,
                          epoch=self.epoch, model_id=self.model_id,
                          weights_generation=self.weights_generation)
            self.heart.beat(**self._lease_state())
            # full cache-index rebuild rides the handshake:
            # the router dropped every fenced-epoch entry at death,
            # and this incarnation re-announces what it holds NOW
            self._announce_snapshot()
            return
        if kind == "stop":
            self.finished = True
            return
        if kind == "drain":
            self.draining = True
            _flight.note("worker", event="draining", worker=self.name)
            return
        # work-bearing messages must match the epoch the router thinks
        # this worker is on (a hello is in flight otherwise)
        if int(msg.get("epoch", -1)) != self.epoch:
            _flight.note("worker", event="stale_ctl_refused",
                         worker=self.name, msg_kind=kind,
                         msg_epoch=msg.get("epoch"), epoch=self.epoch)
            return
        if kind == "submit":
            self._handle_submit(msg["req"])
        elif kind == "install":
            self._handle_install(msg)
        elif kind == "cache_pull":
            self._handle_cache_pull(msg)
        elif kind == "install_prefix":
            self._handle_install_prefix(msg)
        else:
            _flight.note("worker", event="unknown_ctl", worker=self.name,
                         msg_kind=kind)

    def _handle_submit(self, wire: Dict[str, Any]) -> None:
        if self.draining:
            self._send("shed", trace_id=wire["trace_id"],
                       payload=AdmissionError(
                           "worker_lost",
                           f"worker {self.name} is draining").to_dict())
            return
        trace_id = wire["trace_id"]
        if self.role == "engine":
            try:
                h = self.engine.submit(
                    wire["prompt"], wire["max_new_tokens"],
                    eos_id=wire.get("eos_id"),
                    deadline_s=wire.get("deadline_rel_s"),
                    on_token=self._on_token(trace_id),
                    trace_id=trace_id,
                    temperature=float(wire.get("temperature", 0.0)),
                    rng=wire.get("rng"),
                    tenant=wire.get("tenant"))
            except AdmissionError as e:
                self._send("shed", trace_id=trace_id, payload=e.to_dict())
                return
            self._local[trace_id] = h
        else:  # prefill role: queue for the prefill-only loop
            req = request_from_wire(wire)
            try:
                s_pad = self.dec_engine.padded_len(req.prompt_len)
                cap = self.pool.max_total
                if self.dec_engine.max_positions is not None:
                    cap = min(cap, self.dec_engine.max_positions)
                if s_pad > cap:
                    raise AdmissionError(
                        "too_long",
                        f"prompt {req.prompt_len} pads to {s_pad}, "
                        f"exceeding staging capacity {cap}")
                self.scheduler.submit(req, time.monotonic())
            except AdmissionError as e:
                self._send("shed", trace_id=trace_id, payload=e.to_dict())

    def _handle_install(self, msg: Dict[str, Any]) -> None:
        """Decode role: land a router-forwarded slab into a reserved
        slot through the plane's inject path, then tick it like any
        other running request."""
        from ..communicators.base import DcnLaneError

        trace_id, tag = msg["trace_id"], msg["tag"]
        slot = self.engine.pool.reserve()
        if slot is None:
            self._send("install_nack", trace_id=trace_id, tag=tag,
                       reason="no_free_slot")
            return
        try:
            payload = self.plane.lane_get(tag, self.lane_timeout_s)
            stats = self.plane.unpack_into(payload, self.engine.pool, slot)
        except DcnLaneError as e:
            self.engine.pool.cancel_reservation(slot)
            _flight.note("worker", event="install_fault", worker=self.name,
                         trace_id=trace_id, lane=e.lane)
            self._send("install_nack", trace_id=trace_id, tag=tag,
                       reason="lane_fault", lane=e.lane)
            return
        meta = stats["meta"]
        self.engine.pool.commit_reservation(slot)
        req = request_from_wire(meta, on_token=self._on_token(trace_id))
        self._local[trace_id] = _HandleView(req)
        self.engine.install_request(req, slot, meta["tokens"])
        try:
            self.plane.lane_delete(tag)
        except DcnLaneError as e:
            _flight.note("worker", event="gc_failed", tag=tag, lane=e.lane)
        self._send("install_ok", trace_id=trace_id)

    def _handle_cache_pull(self, msg: Dict[str, Any]) -> None:
        """Owner side of a remote prefix pull: pack the
        requested prefix's K/V (pinned across the read — a concurrent
        eviction can never free the slot mid-pack) and publish it on
        the lane; the spill tier serves when the device trie already
        scavenged the slot.  A claim that went fully stale since the
        announce nacks ``stale`` — the router counts it and the request
        degrades to re-prefill (the index is a hint, never truth)."""
        from ..communicators.base import DcnLaneError

        trace_id, tag = msg["trace_id"], msg["tag"]
        seq = [int(t) for t in msg["prefix"]][: int(msg["length"])]
        eng = self.engine
        payload = None
        if eng is not None and eng.prefix_cache is not None:
            entry = eng.prefix_cache.pin_covering(seq)
            if entry is not None:
                try:
                    payload = self.plane.pack(
                        eng.pool, entry.slot, len(seq),
                        meta={"seq": seq, "length": len(seq)})
                finally:
                    eng.prefix_cache.release(entry)
            elif eng.spill is not None:
                # demoted to the host tier: the spilled payload is
                # already packed and CRC-stamped — serve it directly
                payload = eng.spill.covering(seq)
        if payload is None:
            self.cache_counters["pull_stale"] += 1
            _flight.note("worker", event="pull_stale", worker=self.name,
                         trace_id=trace_id, prefix_len=len(seq))
            self._send("cache_pull_nack", trace_id=trace_id, tag=tag,
                       reason="stale")
            return
        try:
            self.plane.lane_put(tag, payload)
        except DcnLaneError as e:
            _flight.note("worker", event="pull_publish_fault",
                         worker=self.name, trace_id=trace_id,
                         lane=e.lane)
            self._send("cache_pull_nack", trace_id=trace_id, tag=tag,
                       reason="publish_fault", lane=e.lane)
            return
        self.cache_counters["pull_serves"] += 1
        self._send("cache_slab_ready", trace_id=trace_id, tag=tag,
                   length=len(seq), pull=True)

    def _handle_install_prefix(self, msg: Dict[str, Any]) -> None:
        """Destination side of a remote prefix pull: land the slab into
        a RESERVED slot through the plane's inject path (CRC verified
        inside ``unpack_into``) and donate it
        straight into the local prefix cache, so the held-back submit
        that follows gets a plain local hit.  The ONE caught
        :class:`DcnLaneError` failure domain: reservation cancelled,
        nack names the lane, the request re-prefills — never a wedge,
        never a leaked slot."""
        from ..communicators.base import DcnLaneError

        trace_id, tag = msg["trace_id"], msg["tag"]
        eng = self.engine
        if eng is None or eng.prefix_cache is None:
            self._send("prefix_nack", trace_id=trace_id, tag=tag,
                       reason="no_cache")
            return
        pool = eng.pool
        slot = pool.reserve()
        if slot is None:
            # scavenge an unpinned prefix slot like admission would —
            # the pull replaces colder cache, it never starves decode
            if eng.prefix_cache.evict_lru() is not None:
                slot = pool.reserve()
        if slot is None:
            self._send("prefix_nack", trace_id=trace_id, tag=tag,
                       reason="no_free_slot")
            return
        try:
            payload = self.plane.lane_get(tag, self.lane_timeout_s)
        except DcnLaneError as e:
            pool.cancel_reservation(slot)
            _flight.note("worker", event="prefix_install_fault",
                         worker=self.name, trace_id=trace_id,
                         lane=e.lane)
            self._send("prefix_nack", trace_id=trace_id, tag=tag,
                       reason="lane_fault", lane=e.lane)
            return
        try:
            stats = self.plane.unpack_into(payload, pool, slot)
        except ValueError as e:
            # corrupt/foreign slab REFUSED (CRC/schema/shape): count,
            # free the reservation, let the router fall back to a
            # clean re-prefill — wrong KV is never served
            pool.cancel_reservation(slot)
            self.cache_counters["crc_refusals"] += 1
            _flight.note("worker", event="prefix_crc_refused",
                         worker=self.name, trace_id=trace_id,
                         error=str(e))
            self._send("prefix_nack", trace_id=trace_id, tag=tag,
                       reason="crc")
            return
        meta = stats["meta"]
        seq = [int(t) for t in meta.get("seq", [])][: stats["length"]]
        pool.commit_reservation(slot)
        entry = eng.prefix_cache.insert(seq, slot, len(seq))
        if entry is not None:
            pool.cache(slot)   # busy -> cached rc=0, announce fired
        else:
            # dedup: something local already covers it — the pull was
            # redundant but the submit that follows still hits
            pool.release(slot)
        try:
            self.plane.lane_delete(tag)
        except DcnLaneError as e:
            _flight.note("worker", event="gc_failed", tag=tag,
                         lane=e.lane)
        self.cache_counters["pull_installs"] += 1
        self._send("prefix_installed", trace_id=trace_id,
                   length=len(seq))

    # ---- role work ----
    def _prefill_round(self) -> int:
        """Prefill-only iteration: admit into staging, run the prefill
        program, publish the slab on the lane, announce it, recycle the
        staging slot.  The router gates downstream capacity (it holds
        ``install`` forwards until a decode worker has a slot), so the
        only local budget is free staging slots."""
        from ..communicators.base import DcnLaneError

        now = time.monotonic()
        for req in self.scheduler.expire_queued(now):
            self._send("result", trace_id=req.trace_id, tokens=[],
                       finish_reason="deadline", ttft_ms=None)
        worked = 0
        for req in self.scheduler.admissions(self.pool.free_count, now):
            slot = self.pool.acquire()
            try:
                first = self.dec_engine.prefill_into_slot(
                    req.prompt, slot, rng=req.rng,
                    temperature=req.temperature)
            except Exception as e:  # noqa: BLE001 — shed THIS request only
                self.pool.release(slot)
                self._send("shed", trace_id=req.trace_id,
                           payload=AdmissionError(
                               "worker_lost",
                               f"prefill failed: {e!r}").to_dict())
                continue
            length = int(self.pool.pos[slot])
            meta = {
                "trace_id": req.trace_id,
                "prompt": [int(t) for t in req.prompt],
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "deadline_rel_s": (None if req.deadline_t is None
                                   else max(req.deadline_t
                                            - time.monotonic(), 0.0)),
                "temperature": req.temperature,
                "rng": (None if req.rng is None
                        else [int(x) for x in np.asarray(req.rng)
                              .reshape(2)]),
                "tokens": [int(first)],
            }
            tag = f"slab/{req.trace_id}"
            try:
                payload = self.plane.pack(self.pool, slot, length,
                                          meta=meta)
                self.plane.lane_put(tag, payload)
            except DcnLaneError as e:
                self.pool.release(slot)
                _flight.note("worker", event="publish_fault",
                             worker=self.name, trace_id=req.trace_id,
                             lane=e.lane)
                self._send("shed", trace_id=req.trace_id,
                           payload=AdmissionError(
                               "worker_lost",
                               f"slab publish failed on lane "
                               f"{e.lane}").to_dict())
                continue
            self.pool.release(slot)
            self._send("slab_ready", trace_id=req.trace_id, tag=tag,
                       length=length, meta=meta)
            worked += 1
        return worked

    def _report_finished(self) -> None:
        """Terminal ``result`` messages for requests that finished this
        step — the AUTHORITATIVE token list (streamed ``token`` messages
        are latency hints; this is what the router reconciles)."""
        done = [tid for tid, h in self._local.items()
                if h.status in ("done", "evicted")]
        for tid in done:
            h = self._local.pop(tid)
            self._send("result", trace_id=tid, tokens=list(h.tokens),
                       finish_reason=h.finish_reason,
                       ttft_ms=h.ttft_ms)

    def _lease_state(self) -> Dict[str, Any]:
        step_age = time.monotonic() - self._t_last_step
        if self.role == "prefill":
            queued = self.scheduler.queued_requests()
            return {
                "queue_depth": len(queued),
                "queue_capacity": self.scheduler.queue_capacity,
                "free_slots": self.pool.free_count,
                "busy_slots": self.pool.busy_count,
                "backlog_tokens": sum(r.prompt_len for r in queued),
                "draining": self.draining,
                "last_step_age_s": round(step_age, 4),
                "model_id": self.model_id,
                "weights_generation": self.weights_generation,
                "cache": {"prefill_calls":
                          int(self.dec_engine.prefill_calls)},
            }
        eng = self.engine
        queued = eng.scheduler.queued_requests()
        backlog = sum(r.prompt_len + r.max_new_tokens for r in queued)
        with eng._lock:
            running = list(eng._running.values())
        backlog += sum(max(r.max_new_tokens - len(r.tokens), 0)
                       for r in running)
        # decode tick-gap p99 rides the lease: the
        # autoscaler's decode-side pressure signal, measured where it
        # exists (the engine) and read where the policy runs
        gap_p99 = eng._tick_gap_ms.percentile(99)
        # KV-economy counters ride the lease: the router's
        # /metricsz aggregates them fleet-wide without extra messages
        cache = dict(self.cache_counters)
        cache["prefill_calls"] = int(eng.engine.prefill_calls)
        if eng.prefix_cache is not None:
            cache["prefix_entries"] = eng.prefix_cache.n_entries
            cache["prefix_hits"] = int(eng.prefix_cache.hits)
        if eng.spill is not None:
            sp = eng.spill
            cache["spills"] = int(sp.spills)
            cache["restores"] = int(sp.restores)
            cache["crc_refusals"] = (cache.get("crc_refusals", 0)
                                     + int(sp.crc_refusals))
        return {
            "queue_depth": len(queued),
            "queue_capacity": eng.scheduler.queue_capacity,
            "free_slots": eng.pool.free_count,
            "busy_slots": eng.pool.busy_count,
            "reserved_slots": eng.pool.reserved_count,
            "backlog_tokens": int(backlog),
            "tokens_emitted": eng._tokens_emitted,
            "in_flight": len(self._local),
            "draining": self.draining,
            "model_id": self.model_id,
            "weights_generation": self.weights_generation,
            # destination-side slab geometry: the router's
            # pull planner refuses geometry-mismatched claims against it
            "geom": self._geom(),
            "last_step_age_s": round(step_age, 4),
            "tick_gap_p99_ms": (None if gap_p99 is None
                                else round(gap_p99, 3)),
            "cache": cache,
        }

    def start_heartbeat(self) -> None:
        """Publish leases from a SIDE thread, so a long device call
        (a first prefill on a cold card can block the loop) is not
        misread as death.  A SIGKILL/SIGSTOP takes the whole process —
        thread included — so real death still silences the lease within
        one beat; the lease's ``last_step_age_s`` field carries loop
        progress separately, so a wedged-but-breathing loop is visible
        to the supervisor as degradation rather than invisible."""
        import threading

        if self._beat_thread is not None:
            return

        def loop():
            while not self.finished:
                if not self.killed:
                    try:
                        self.heart.maybe_beat(**self._lease_state())
                    except Exception:  # noqa: BLE001 — a beat must
                        pass           # never kill the worker
                time.sleep(self.heart.beat_interval_s / 2.0)

        self._beat_thread = threading.Thread(
            target=loop, daemon=True, name=f"heartbeat-{self.name}")
        self._beat_thread.start()

    @property
    def idle(self) -> bool:
        busy = (self.scheduler.queue_depth > 0
                or self.pool.busy_count > 0 or bool(self._local))
        if self.role == "decode":
            busy = busy or self.pool.reserved_count > 0
        return not busy

    def step(self) -> int:
        """One worker iteration: drain the control inbox, one round of
        role work, report finished requests, heartbeat.  Returns how
        much work happened (0 == idle)."""
        if self.killed or self.finished:
            return 0
        worked = 0
        for msg in self.inbox.drain():
            self._handle(msg)
            worked += 1
            if self.finished:
                return worked
        if self.role == "prefill":
            worked += self._prefill_round()
        else:
            if (self.scheduler.queue_depth > 0
                    or self.pool.busy_count > 0):
                self.engine.step()
                worked += 1
            self._report_finished()
        if self.draining and self.idle:
            self._send("drained")
            # finished BEFORE the lease release: the heartbeat thread
            # must never re-publish a lease for a drained worker
            self.finished = True
            self.heart.release()
            _flight.note("worker", event="drained", worker=self.name)
            return worked + 1
        if self._beat_thread is None:
            # with the side thread active it owns the lease cadence —
            # beating from here too would interleave two publishers
            self.heart.maybe_beat(**self._lease_state())
        self._steps += 1
        self._t_last_step = time.monotonic()
        return worked

    def run(self, poll_s: float = 0.002) -> int:
        """Drive :meth:`step` until drained/stopped; returns exit code
        0 (the graceful-drain acceptance: a drained worker EXITS 0)."""
        self.start_heartbeat()
        while not self.finished:
            if self.step() == 0:
                time.sleep(poll_s)
        if self._beat_thread is not None:
            # join before interpreter teardown: a daemon thread dying
            # mid-shutdown inside a lane write can abort the process
            self._beat_thread.join(timeout=2 * self.heart.beat_interval_s
                                   + 1.0)
            self._beat_thread = None
        if self.engine is not None:
            self.engine.close()
        return 0

    def kill(self) -> None:
        """Chaos face: stop ALL activity including heartbeats — what a
        SIGKILL looks like from the supervisor's side."""
        self.killed = True


class _HandleView:
    """Handle-shaped view of a decode-installed request (the decode
    role has no submit(), so no RequestHandle was minted)."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def status(self):
        return self._req.status

    @property
    def tokens(self):
        return list(self._req.tokens)

    @property
    def finish_reason(self):
        return self._req.finish_reason

    @property
    def ttft_ms(self):
        ts = self._req.timestamps
        if "submitted" in ts and "first_token" in ts:
            return (ts["first_token"] - ts["submitted"]) * 1e3
        return None


def warm_device(device, dtype) -> "object":
    """Initialise ``device`` before the first lease: on a card, the CUDA
    context, the serving kernels' libraries (built by the parent, loaded
    here) and the cuBLAS handle, so none of them stalls the loop while
    the lease window runs.  Returns the resolved ``torch.device``."""
    import torch

    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build

        if dev.index is not None:
            torch.cuda.set_device(dev)
        for name in SERVING_SOURCES:
            _build.library(name)
        a = torch.ones(64, 64, dtype=dtype, device=dev)
        (a @ a).sum().item()
        torch.cuda.synchronize(dev)
    return dev


def main(argv=None) -> int:
    """Process entry: build the role loop from a pickled params file and
    run it over a :class:`~chainermn_tpu_torch.serving.lanes.FileLaneStore`
    on ``--device``.  The fleet spawner (``serving/fleet.py ::
    spawn_worker``) execs this; the ready line on stderr names the
    device."""
    import argparse
    import os
    import pickle
    import sys

    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch serving fleet worker process")
    parser.add_argument("--name", required=True)
    parser.add_argument("--role", required=True, choices=ROLES)
    parser.add_argument("--lane-dir", required=True)
    parser.add_argument("--params", required=True,
                        help="pickle file: {'params': tree of CPU tensors, "
                             "'head_dim': int, ...engine kwargs}")
    parser.add_argument("--epoch", type=int, default=1)
    parser.add_argument("--beat-interval-s", type=float, default=0.05)
    parser.add_argument("--bundle-dir", default=None)
    parser.add_argument("--journal-dir", default=None,
                        help="causal HLC journal directory; this worker "
                             "tees its state transitions into "
                             "journal.<name>.jsonl there")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    if args.journal_dir:
        from ..observability import journal
        journal.configure(args.journal_dir, args.name)

    from .lanes import FileLaneStore

    with open(args.params, "rb") as f:
        spec = pickle.load(f)
    params = spec.pop("params")
    dev = warm_device(args.device, params["embed"].dtype)
    if args.bundle_dir:
        from .. import global_except_hook
        from ..observability import flight
        flight.install_signal_handlers(args.bundle_dir)
        global_except_hook.add_hook()
    store = FileLaneStore(args.lane_dir)
    runtime = WorkerRuntime(
        args.name, args.role, params, store, epoch=args.epoch,
        beat_interval_s=args.beat_interval_s,
        bundle_dir=args.bundle_dir, device=dev, **spec)
    print(f"[chainermn_tpu_torch worker] {args.name} role={args.role} "
          f"epoch={args.epoch} device={dev} pid={os.getpid()} ready",
          file=sys.stderr, flush=True)
    return runtime.run()


if __name__ == "__main__":
    raise SystemExit(main())
