"""Serving API: submit → handle, streaming tokens, metrics, a driver thread.

Counterpart of ``chainermn_tpu/serving/frontend.py``.
:class:`ServingEngine` glues the scheduler, the slot pool, the prefix
cache, the host spill tier and the decode engine into the loop a service
runs::

    eng = ServingEngine(params, head_dim=64, n_slots=8, max_total=1024)
    h = eng.submit([3, 1, 4], max_new_tokens=16)
    eng.start()            # background driver thread (or eng.step() / run())
    h.wait(timeout=30)
    print(h.tokens, h.status, h.ttft_ms)

Each ``step()`` expires overdue queued work, admits up to the
interleaving bound, runs ONE decode tick over the pool, streams the new
tokens and evicts finished sequences, so requests join and leave between
ticks (continuous batching).  Requests are greedy, or sampled with their
own key (``temperature`` and ``rng`` at submit); GQA models serve like
any other.

The prefix cache and the spill tier are on by default, as in JAX's
engine.  A finished request DONATES its slot to a radix-trie cache
(busy → cached, keyed by every K/V row it wrote: ``prompt +
tokens[:-1]`` clipped to ``pos``); admission matches and pins the longest
cached prefix BEFORE it takes a slot, copies the cached slot's K/V into
the request's own (``DecodeEngine.copy_prefix``) and feeds the uncached
suffix through the shared tick one token at a time (``Request.forced``):
the tick kernels write and attend rows no prefill wrote.  When admission
needs a slot and none is free, the LRU unpinned cached slot is
scavenged; with the spill tier on, its slab is first packed
(CRC-stamped) into a bounded host store, and a later prompt that shares
it restores it into its own slot instead of prefilling.  A payload that
fails its CRC is refused, counted, and its request prefills.

Observability: per-request phase timestamps on the handle, the tracer's
``serving/*`` spans, instants and gauges under JAX's names (a trace id
per request, an async flow from submit to finish), a
:class:`~chainermn_tpu_torch.observability.slo.GoodputLedger` over the
engine's wall clock, an optional
:class:`~chainermn_tpu_torch.observability.slo.SLOTracker`, the flight
recorder's ``serving`` provider (:meth:`ServingEngine.introspect_state`),
``/requestz`` rows (:meth:`ServingEngine.requests_table`), the JSONL
stream (``metrics_writer``) and a Prometheus textfile
(:meth:`ServingEngine.write_prometheus`).

Tensor parallelism (``mesh=``): every rank of the model axis builds the
engine over its shards; model rank 0 submits, schedules and steps it, and
every device call it makes (prefill, tick, prefix copy, a position reset,
a spill's pack / drop / restore) is broadcast as a plan to the other
ranks, which call :meth:`ServingEngine.follow` and run those calls until
the leader's :meth:`close` (in a ``finally``).

``prefill_bucket`` pads prompts to bucket multiples (the padded length is
what admission holds against the slot and the learned positions), and
:meth:`ServingEngine.install_request` is the disaggregated fleet's inject
face: a request whose K/V another pool's prefill wrote and the transfer
plane landed in a reserved slot joins the tick here.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .._device import resolve_device
from ..convert import tree_map
from ..observability import flight as _flight
from ..observability import trace as obs
from ..observability.slo import GoodputLedger, ReservoirSample, SLOTracker
from ..parallel.decode import _kv_heads
from .cache_pool import CachePool
from .engine import DecodeEngine
from .prefix_cache import PrefixCache
from .scheduler import AdmissionError, Request, Scheduler


class RequestHandle:
    """Caller's view of one submitted request (thread-safe reads)."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def id(self) -> int:
        return self._req.id

    @property
    def trace_id(self) -> str:
        return self._req.trace_id

    @property
    def status(self) -> str:
        return self._req.status

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def tokens(self) -> List[int]:
        return list(self._req.tokens)

    @property
    def timestamps(self) -> Dict[str, float]:
        return dict(self._req.timestamps)

    @property
    def ttft_ms(self) -> Optional[float]:
        ts = self._req.timestamps
        if "submitted" in ts and "first_token" in ts:
            return (ts["first_token"] - ts["submitted"]) * 1e3
        return None

    @property
    def shed_payload(self) -> Optional[Dict[str, Any]]:
        """The ``AdmissionError.to_dict()`` payload when a fleet shed this
        already-accepted request, else None."""
        return getattr(self._req, "shed_payload", None)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes; True iff it did."""
        return self._req.done_event.wait(timeout)


def _request_row(req: Request) -> Dict[str, Any]:
    """One JSON-able /requestz row (also the bundle's serving view)."""
    ts = dict(req.timestamps)
    row = {
        "id": req.id,
        "trace_id": req.trace_id,
        "status": req.status,
        "finish_reason": req.finish_reason,
        "slot": req.slot,
        "prompt_len": req.prompt_len,
        "max_new_tokens": req.max_new_tokens,
        "n_tokens": len(req.tokens),
        "timestamps": {k: round(v, 6) for k, v in ts.items()},
        "tenant": req.tenant,
        "priority": getattr(req, "priority", None),
        "rung": getattr(req, "rung", None),
    }
    if "submitted" in ts and "first_token" in ts:
        row["ttft_ms"] = round(
            (ts["first_token"] - ts["submitted"]) * 1e3, 3)
    return row


class ServingEngine:
    """Continuous-batching inference over a slot-managed KV pool.

    ``params``: ``init_tp_transformer_lm`` tensors (moved to ``device``);
    with ``mesh``, this rank's shards over ``axis_name``
    (``transformer_lm_specs``), and the pool holds this rank's KV heads.
    ``max_total`` bounds each slot's sequence (prompt + generated); a
    request that cannot fit is rejected at submit (``AdmissionError``,
    reason ``too_long``), as is any submit while the bounded queue is full
    (``queue_full``).  ``prefill_bucket``, ``prefix_cache``,
    ``min_prefix_len`` and ``spill_bytes`` (0 turns the spill tier off)
    are JAX's, with JAX's defaults.
    """

    def __init__(self, params, *, head_dim: int, n_slots: int = 4,
                 max_total: int = 128, mesh=None, axis_name: str = "model",
                 queue_capacity: int = 16, max_prefills_per_tick: int = 1,
                 prefill_bucket: int = 1,
                 metrics_writer=None, stats_capacity: int = 1024,
                 slo: Optional[SLOTracker] = None,
                 recent_capacity: int = 64, prefix_cache: bool = True,
                 min_prefix_len: int = 2, spill_bytes: int = 32 << 20,
                 device="cuda"):
        dev = resolve_device(device)
        n_kv = _kv_heads(params, head_dim)
        params = tree_map(params, lambda t: t.to(dev))
        self.pool = CachePool(n_slots, max_total, len(params["blocks"]),
                              n_kv * head_dim, params["embed"].dtype, dev)
        self.engine = DecodeEngine(params, self.pool, mesh, axis_name,
                                   head_dim=head_dim,
                                   prefill_bucket=prefill_bucket)
        self.scheduler = Scheduler(
            queue_capacity, max_total,
            max_prefills_per_tick=max_prefills_per_tick,
            max_positions=self.engine.max_positions)
        # the radix-trie prefix cache: finished requests donate their
        # slot (busy -> cached, read-only, refcounted); admission
        # scavenges rc==0 entries LRU-first when the free list is empty
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                retain_slot=self.pool.retain,
                release_slot=self.pool.unretain,
                evict_slot=self._uncache_slot,
                min_prefix_len=min_prefix_len,
                on_insert=self._on_prefix_insert,
                on_evict=self._on_prefix_evict)
        # the host-RAM spill tier: a scavenged rc==0 prefix slot spills
        # its CRC-stamped slab into a bounded LRU host store; a later
        # matching prompt restores it instead of prefilling
        self.spill = None
        self._spill_plane = None
        if prefix_cache and int(spill_bytes) > 0:
            from .spill import HostSpillStore
            self.spill = HostSpillStore(capacity_bytes=int(spill_bytes),
                                        on_evict=self._on_spill_evict)
            self._spill_plane = self.engine.kv_plane
        # the fleet worker's hooks: it announces this engine's cache
        # lifecycle over the mailbox wire so the router's fleet index can
        # route remote pulls here.  ``on_cache_insert(entry)``,
        # ``on_cache_evict(entry, spilled)``, ``on_spill_evict(seq,
        # length)``
        self.on_cache_insert = None
        self.on_cache_evict = None
        self.on_spill_evict = None
        self.metrics_writer = metrics_writer
        self._running: Dict[int, Request] = {}   # slot -> request
        self._lock = threading.Lock()            # guards _running + stats
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        self.stats_capacity = int(stats_capacity)
        self._ttft_ms = ReservoirSample(self.stats_capacity)
        self._tok_lat_ms = ReservoirSample(self.stats_capacity)
        # wall between consecutive tick starts while work is active: the
        # inter-token latency a decoding request sees (a prefill between
        # ticks inflates it)
        self._tick_gap_ms = ReservoirSample(self.stats_capacity)
        self._last_tick_start: Optional[float] = None
        # per-slot sampling operands: each slot's request key and
        # temperature ride every tick; greedy and free slots carry zeros
        self._slot_keys = np.zeros((self.pool.n_slots, 2), np.uint32)
        self._slot_temps = np.zeros(self.pool.n_slots, np.float32)
        self._tokens_emitted = 0
        self._ticks = 0
        self._occupancy_sum = 0.0
        self._rejected = 0
        self._t0 = time.monotonic()
        # goodput attribution: step() partitions its own wall clock, and
        # the gap between steps books as queue_wait (work was waiting)
        # or stall (engine idle)
        self.goodput = GoodputLedger()
        self._last_step_end: Optional[float] = None
        self.slo = slo
        self._slo_last = (0, self._t0)
        self._recent: deque = deque(maxlen=int(recent_capacity))
        _flight.register_provider("serving", self.introspect_state)

    # ---- submission ----
    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               trace_id: Optional[str] = None,
               temperature: float = 0.0, rng=None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Enqueue a generation request; raises :class:`AdmissionError`
        (with ``.reason``) when the queue is full or it can never fit.
        ``on_token(token, request_id)`` streams each emitted token;
        ``deadline_s`` is relative to now; ``trace_id`` lets an upstream
        hop (the router) mint the request's trace identity; ``tenant``
        stamps its billing identity.  ``temperature > 0`` samples the
        request's tokens and needs its key ``rng`` (``ValueError``
        otherwise: a silent default key would draw identical
        sequences)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        now = time.monotonic()
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        temperature = float(temperature)
        if temperature > 0.0 and rng is None:
            raise ValueError(
                "temperature > 0 samples tokens and needs an explicit rng "
                "key (prng.PRNGKey(...)): a silent default key would make "
                "every sampled request draw identical token sequences")
        key = (None if rng is None
               else np.asarray(rng).astype(np.uint32).reshape(2))
        req = Request(prompt, max_new_tokens, eos_id=eos_id,
                      deadline_t=(now + deadline_s
                                  if deadline_s is not None else None),
                      on_token=on_token, trace_id=trace_id,
                      temperature=temperature, rng=key, tenant=tenant)
        # tracer stamp + flow begin before the scheduler can see the
        # request (with start()'s thread it may finish at once)
        req.trace_us = {"submitted": obs.now_us()}
        obs.async_event("b", "request", req.trace_id,
                        cat="serving_request", request=req.id,
                        prompt_len=req.prompt_len)
        try:
            self.engine.check_padded_fit(req.prompt_len)
            self.scheduler.submit(req, now)
        except AdmissionError as e:
            with self._lock:
                self._rejected += 1
            obs.async_event("e", "request", req.trace_id,
                            cat="serving_request", reason="rejected",
                            admission_reason=e.reason)
            _flight.note("serving", event="rejected", request=req.id,
                         trace_id=req.trace_id, reason=e.reason)
            raise
        obs.instant("serving/request/queued", cat="serving",
                    request=req.id, trace_id=req.trace_id)
        _flight.note("serving", event="queued", request=req.id,
                     trace_id=req.trace_id, prompt_len=req.prompt_len)
        obs.set_gauge("serving/queue_depth", self.scheduler.queue_depth)
        return RequestHandle(req)

    # ---- the engine iteration ----
    def step(self) -> Dict[str, float]:
        """ONE engine iteration: expire → admit (prefix copy, restore or
        prefill) → tick → evict.  The iteration's wall clock lands in the
        goodput ledger: device calls as ``compute`` (``compile`` on the
        first prefill and the first tick, which build the kernels), the
        rest as ``host``, the gap since the previous step as
        ``queue_wait`` or ``stall``."""
        t_step0 = time.monotonic()
        last = (self._last_step_end if self._last_step_end is not None
                else self._t0)
        gap = t_step0 - last
        if gap > 0:
            had_work = (self.scheduler.queue_depth > 0
                        or self.pool.busy_count > 0)
            self.goodput.add("queue_wait" if had_work else "stall", gap)
        t_host = t_step0

        now = time.monotonic()
        for req in self.scheduler.expire_queued(now):
            obs.instant("serving/request/expired", cat="serving",
                        request=req.id, trace_id=req.trace_id)
            self._finish_tracing(req, "deadline")

        # rc==0 cached prefix slots count as free-after-eviction
        avail = self.pool.free_count
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_count()
        admitted_batch = self.scheduler.admissions(avail, now)
        for batch_i, req in enumerate(admitted_batch):
            # match and PIN before taking a slot: the acquire below may
            # scavenge an rc==0 cached slot, and an unpinned match would
            # be its own eviction victim
            entry, mlen = None, 0
            if self.prefix_cache is not None:
                entry, mlen = self.prefix_cache.match(req.prompt)
                if entry is not None:
                    self.prefix_cache.retain(entry)
                    req.prefix_entry, req.prefix_len = entry, mlen
            slot = self._acquire_slot()
            if slot is None and entry is not None:
                # our own match is the only scavengeable slot: give up
                # the hit rather than stall the pool (and back the
                # counters out: this became a miss)
                self.prefix_cache.release(entry)
                self.prefix_cache.hits -= 1
                self.prefix_cache.misses += 1
                self.prefix_cache.tokens_reused -= mlen
                req.prefix_entry, req.prefix_len = None, 0
                entry, mlen = None, 0
                slot = self._acquire_slot()
            if slot is None:
                # every scavengeable slot is pinned by earlier admissions
                # of this batch: requeue this one and the rest, FIFO
                for later in reversed(admitted_batch[batch_i:]):
                    self.scheduler.requeue_front(later)
                break
            req.slot = slot
            req.status = "running"
            t_admit = time.monotonic()
            req.timestamps["prefill_start"] = t_admit
            t_us = getattr(req, "trace_us", None)
            if t_us is not None:
                obs.complete_event(
                    "request/queue_wait", t_us["submitted"],
                    obs.now_us() - t_us["submitted"], cat="serving_request",
                    trace_id=req.trace_id, request=req.id)
            obs.instant("serving/request/prefill", cat="serving",
                        request=req.id, slot=slot, trace_id=req.trace_id)
            _flight.note("serving", event="admitted", request=req.id,
                         trace_id=req.trace_id, slot=slot)
            # prefix hit: copy the cached slot's K/V; the uncached suffix
            # feeds through the shared tick one token an iteration
            if entry is not None:
                req.forced.extend(req.prompt[mlen:])
                self._set_slot_sampling(slot, req)
                self.goodput.add("host", t_admit - t_host)
                t_cp = time.monotonic()
                try:
                    with obs.span("serving/prefix_copy",
                                  cat="serving_request", request=req.id,
                                  trace_id=req.trace_id, slot=slot,
                                  src_slot=entry.slot, prefix_len=mlen):
                        self.engine.copy_prefix(entry.slot, slot, mlen)
                    t_host = time.monotonic()
                    self.goodput.add("compute", t_host - t_cp)
                except Exception as e:
                    t_host = time.monotonic()
                    self.goodput.add("compute", t_host - t_cp)
                    self._fail_admission(req, slot, "prefix copy", e)
                    continue
                obs.instant("serving/request/prefix_hit", cat="serving",
                            request=req.id, slot=slot,
                            trace_id=req.trace_id, prefix_len=mlen,
                            src_slot=entry.slot)
                _flight.note("serving", event="prefix_hit",
                             request=req.id, trace_id=req.trace_id,
                             slot=slot, prefix_len=mlen)
                with self._lock:
                    self._running[slot] = req
                # no token yet: the suffix's last tick emits the first;
                # only the deadline can evict before that
                self._maybe_evict(req, time.monotonic())
                continue
            # device-cache miss: the host spill tier may still hold the
            # prefix; a restore lands it in this request's slot
            if self.spill is not None:
                t_rs = time.monotonic()
                self.goodput.add("host", t_rs - t_host)
                with obs.span("serving/spill_restore",
                              cat="serving_request", request=req.id,
                              trace_id=req.trace_id, slot=slot):
                    rlen = self._try_restore(req, slot)
                t_host = time.monotonic()
                self.goodput.add("compute" if rlen else "host",
                                 t_host - t_rs)
                if rlen:
                    req.forced.extend(req.prompt[rlen:])
                    self._set_slot_sampling(slot, req)
                    obs.instant("serving/request/spill_restore",
                                cat="serving", request=req.id,
                                slot=slot, trace_id=req.trace_id,
                                prefix_len=rlen)
                    _flight.note("serving", event="restore",
                                 request=req.id, trace_id=req.trace_id,
                                 slot=slot, prefix_len=rlen)
                    with self._lock:
                        self._running[slot] = req
                    self._maybe_evict(req, time.monotonic())
                    continue
            self.goodput.add("host", max(t_admit - t_host, 0.0))
            first_call = self.engine.prefill_calls == 0
            t_pf = time.monotonic()
            try:
                with obs.span("serving/prefill", cat="serving_request",
                              request=req.id, trace_id=req.trace_id,
                              slot=slot):
                    first = self.engine.prefill_into_slot(
                        req.prompt, slot, req.rng, req.temperature)
                self._set_slot_sampling(slot, req)
                t_host = time.monotonic()
                self.goodput.add("compile" if first_call else "compute",
                                 t_host - t_pf)
            except Exception as e:
                t_host = time.monotonic()
                self.goodput.add("compute", t_host - t_pf)
                # never die holding a slot: the request is finished with
                # reason "error" and the engine keeps serving the rest
                self._fail_admission(req, slot, "prefill", e)
                continue
            self._emit(req, first, time.monotonic())
            with self._lock:
                self._running[slot] = req
            self._maybe_evict(req, time.monotonic())

        # one decode tick over the pool (skipped when nothing is active)
        with self._lock:
            active = dict(self._running)
        if active:
            tokens = np.zeros(self.pool.n_slots, np.int32)
            for slot, req in active.items():
                # a prefix-hit request still owing suffix tokens feeds the
                # next PROMPT token (its K/V row gets written; the
                # prediction is discarded until the last one)
                tokens[slot] = (req.forced[0] if req.forced
                                else req.tokens[-1])
            t_tick = time.monotonic()
            self.goodput.add("host", t_tick - t_host)
            with self._lock:
                if self._last_tick_start is not None:
                    self._tick_gap_ms.add(
                        (t_tick - self._last_tick_start) * 1e3)
                self._last_tick_start = t_tick
            tick_bucket = ("compile" if self.engine.tick_calls == 0
                           else "compute")
            t_tick_us = obs.now_us()
            with obs.span("serving/tick", cat="serving",
                          active=len(active)):
                with self.goodput.measure(tick_bucket):
                    nxt = self.engine.tick(tokens, self._slot_keys,
                                           self._slot_temps)
            t_host = time.monotonic()
            dt_ms = (t_host - t_tick) * 1e3
            dt_us = obs.now_us() - t_tick_us
            now = time.monotonic()
            for slot, req in active.items():
                obs.complete_event(
                    "request/decode_tick", t_tick_us, dt_us,
                    cat="serving_request", trace_id=req.trace_id,
                    request=req.id, slot=slot, active=len(active))
                still_forced = False
                if req.forced:
                    req.forced.popleft()
                    still_forced = bool(req.forced)
                if not still_forced:
                    # a miss, or the suffix's last prompt token just ran:
                    # the tick's prediction is the next real token
                    self._emit(req, int(nxt[slot]), now)
                self._tok_lat_ms.add(dt_ms / max(len(active), 1))
                self._maybe_evict(req, now)
        else:
            # an idle step breaks the tick cadence
            with self._lock:
                self._last_tick_start = None

        with self._lock:
            self._ticks += 1
            self._occupancy_sum += self.pool.busy_count / self.pool.n_slots
            stats = {
                "queue_depth": float(self.scheduler.queue_depth),
                "active_slots": float(self.pool.busy_count),
                "tokens_emitted": float(self._tokens_emitted),
            }
        obs.set_gauge("serving/queue_depth", stats["queue_depth"])
        obs.set_gauge("serving/active_slots", stats["active_slots"])
        el = time.monotonic() - self._t0
        if el > 0:
            obs.set_gauge("serving/tokens_per_sec",
                          self._tokens_emitted / el)
        if self.slo is not None and active:
            # the recent rate since the previous observation (idle steps
            # do not count: zero demand is no SLO violation)
            now_t = time.monotonic()
            with self._lock:
                last_tok, last_t = self._slo_last
                emitted = self._tokens_emitted
                self._slo_last = (emitted, now_t)
            dt = now_t - last_t
            if dt > 0:
                self.slo.observe_throughput((emitted - last_tok) / dt)
        if self.metrics_writer is not None:
            self.metrics_writer.write(
                {f"serving/{k}": v for k, v in stats.items()},
                kind="serving_step")
        t_end = time.monotonic()
        self.goodput.add("host", t_end - t_host)
        with self._lock:
            self._last_step_end = t_end
        _flight.note("phase", name="serving/step", tick=self._ticks,
                     active=int(stats["active_slots"]))
        return stats

    def _fail_admission(self, req: Request, slot: int, what: str,
                        e: Exception) -> None:
        self._abort_slot(req, slot)
        req.finish("error", time.monotonic())
        obs.instant("serving/request/error", cat="serving",
                    request=req.id, trace_id=req.trace_id)
        _flight.note("serving", event="error", request=req.id,
                     trace_id=req.trace_id, error=repr(e))
        self._finish_tracing(req, "error")
        print(f"chainermn_tpu_torch.serving: {what} of request {req.id} "
              f"failed: {e!r}", file=sys.stderr)

    def _emit(self, req: Request, token: int, now: float) -> None:
        req.tokens.append(int(token))
        if "first_token" not in req.timestamps:
            req.timestamps["first_token"] = now
            ttft = (now - req.timestamps["submitted"]) * 1e3
            with self._lock:
                self._ttft_ms.add(ttft)
            if self.slo is not None:
                self.slo.observe_ttft(ttft)
            obs.instant("serving/request/first_token", cat="serving",
                        request=req.id, trace_id=req.trace_id)
            obs.async_event("n", "first_token", req.trace_id,
                            cat="serving_request", ttft_ms=round(ttft, 3))
        with self._lock:
            self._tokens_emitted += 1
        obs.add_counter("serving/tokens_total", 1)
        if req.on_token is not None:
            req.on_token(int(token), req.id)

    def _set_slot_sampling(self, slot: int, req: Request) -> None:
        """The occupant's key and temperature as the slot's tick operands
        (zeros for greedy: the key is never consumed)."""
        self._slot_keys[slot] = (req.rng if req.rng is not None
                                 else np.zeros(2, np.uint32))
        self._slot_temps[slot] = np.float32(req.temperature)

    # ---- the disaggregated inject face ----
    def install_request(self, req: Request, slot: int, tokens) -> None:
        """Adopt an already-prefilled request whose K/V slab the transfer
        plane just landed in ``slot`` (the caller committed the reservation
        and set ``pool.pos[slot]``): install its sampling operands, emit the
        tokens the prefill side produced (the first stamps TTFT and
        streams), and tick it from the next step.  This engine never ran a
        prefill for ``req``."""
        req.slot = slot
        req.status = "running"
        now = time.monotonic()
        req.timestamps.setdefault("prefill_start", now)
        self._set_slot_sampling(slot, req)
        obs.instant("serving/request/installed", cat="serving",
                    request=req.id, slot=slot, trace_id=req.trace_id)
        _flight.note("serving", event="installed", request=req.id,
                     trace_id=req.trace_id, slot=slot,
                     pos=int(self.pool.pos[slot]))
        for tok in tokens:
            self._emit(req, int(tok), now)
        with self._lock:
            self._running[slot] = req
        self._maybe_evict(req, now)

    def _finish_tracing(self, req: Request, reason: str) -> None:
        """Close the request's async flow and note the terminal event."""
        obs.async_event("e", "request", req.trace_id,
                        cat="serving_request", reason=reason,
                        n_tokens=len(req.tokens))
        _flight.note("serving", event="finished", request=req.id,
                     trace_id=req.trace_id, reason=reason,
                     n_tokens=len(req.tokens))
        with self._lock:
            self._recent.append(req)

    def _maybe_evict(self, req: Request, now: float) -> None:
        reason = self.scheduler.eviction_reason(req, now)
        if reason is None:
            return
        slot = req.slot
        req.finish(reason, now)
        with self._lock:
            self._running.pop(slot, None)
        self._retire_slot(req, slot)
        obs.instant("serving/request/complete", cat="serving",
                    request=req.id, reason=reason, trace_id=req.trace_id)
        self._finish_tracing(req, reason)

    # ---- slot lifecycle ----
    def _acquire_slot(self) -> Optional[int]:
        """A free slot, scavenging the LRU unpinned prefix entry when the
        free list is empty: the cache borrows capacity, never owns it."""
        slot = self.pool.acquire()
        if slot is None and self.prefix_cache is not None:
            if self.prefix_cache.evict_lru() is not None:
                slot = self.pool.acquire()
        return slot

    def _release(self, slot: int) -> None:
        self.engine.reset_slot(slot)          # on every model rank
        self.pool.release(slot)

    def _uncache_slot(self, slot: int) -> None:
        """The prefix cache's eviction: ``uncache`` resets ``pos`` (on
        every model rank)."""
        self.engine.reset_slot(slot)
        self.pool.uncache(slot)

    def _abort_slot(self, req: Request, slot: int) -> None:
        """Failed admission: unpin the request's prefix source and free
        the slot; K/V written only in part is never donated."""
        if req.prefix_entry is not None and self.prefix_cache is not None:
            self.prefix_cache.release(req.prefix_entry)
            req.prefix_entry = None
        self._slot_temps[slot] = 0.0
        self._release(slot)

    def _retire_slot(self, req: Request, slot: int) -> None:
        """Finished request: unpin its prefix source, then DONATE the
        slot to the prefix cache (busy → cached, rc 0) keyed by every K/V
        row written (``prompt + tokens[:-1]`` clipped to the slot's
        ``pos``), or free it when the cache dedups the donation or is
        off.  A donated slot keeps its ``pos``: no reset."""
        cache = self.prefix_cache
        if req.prefix_entry is not None and cache is not None:
            cache.release(req.prefix_entry)
            req.prefix_entry = None
        # a free or cached slot keeps ticking: its discarded row goes
        # back to greedy
        self._slot_temps[slot] = 0.0
        if cache is not None:
            length = int(self.pool.pos[slot])
            seq = list(req.prompt) + list(req.tokens[:-1])
            if length >= cache.min_prefix_len \
                    and cache.insert(seq[:length], slot, length) is not None:
                self.pool.cache(slot)
                return
        self._release(slot)

    # ---- the cache lifecycle: the spill tier and the fleet hooks ----
    def _on_prefix_insert(self, entry) -> None:
        if self.on_cache_insert is not None:
            self.on_cache_insert(entry)

    def _on_prefix_evict(self, entry) -> None:
        """Fires before the evicted entry's slot returns to the free
        list: spill its K/V into the host tier, then tell the fleet hook
        whether the eviction demoted (spilled) or dropped the prefix."""
        spilled = self._maybe_spill(entry)
        if self.on_cache_evict is not None:
            self.on_cache_evict(entry, spilled)

    def _maybe_spill(self, entry) -> bool:
        """The prefix cache's pre-eviction hook: before the entry's slot
        is freed, pack its K/V into the spill tier."""
        if self.spill is None:
            return False
        meta = {"seq": list(entry.seq), "length": entry.length}
        try:
            payload = self._spill_plane.pack(self.pool, entry.slot,
                                             entry.length, meta)
            ok = self.spill.put(entry.seq, entry.length, payload)
        except Exception as e:  # noqa: BLE001 — a failed spill must not
            # break the eviction it rides on: the prefix re-prefills
            _flight.note("serving", event="spill_failed",
                         slot=entry.slot, error=repr(e))
            return False
        if ok:
            self.engine.spill_followers(entry.slot, entry.length, meta)
            _flight.note("serving", event="spill", slot=entry.slot,
                         prefix_len=entry.length, bytes=len(payload),
                         store_bytes=self.spill.bytes_held)
            obs.instant("serving/spill", cat="serving",
                        prefix_len=entry.length, bytes=len(payload))
        return ok

    def _on_spill_evict(self, seq, length) -> None:
        self.engine.unspill_followers(seq)
        if self.on_spill_evict is not None:
            self.on_spill_evict(seq, length)

    def _try_restore(self, req: Request, slot: int) -> int:
        """Restore a spilled prefix into the request's own slot; returns
        the restored prefix length, or 0 (no usable spill, or a payload
        refused on some rank: the request prefills).  Every row of the
        payload lands, and ``pos`` is set to the matched length: rows
        above it are unreachable."""
        min_len = (self.prefix_cache.min_prefix_len
                   if self.prefix_cache is not None else 2)
        hit = self.spill.match(req.prompt, min_len=min_len)
        if hit is None:
            return 0
        seq, mlen = hit
        payload = self.spill.get(seq)
        if payload is None:
            return 0
        try:
            self.engine.restore(payload, slot, seq, mlen)
        except ValueError as e:
            # CRC / schema / shape refusal: the corrupt state is dropped
            # and counted; wrong K/V is never served
            self.spill.crc_refusals += 1
            self.spill.drop(seq)
            _flight.note("serving", event="spill_crc_refused",
                         request=req.id, trace_id=req.trace_id,
                         error=str(e))
            obs.instant("serving/spill_crc_refused", cat="serving",
                        request=req.id, trace_id=req.trace_id)
            return 0
        except Exception as e:  # noqa: BLE001 — the request prefills
            _flight.note("serving", event="restore_failed",
                         request=req.id, trace_id=req.trace_id,
                         error=repr(e))
            return 0
        self.spill.restores += 1
        return int(mlen)

    # ---- driving ----
    def run(self, steps_budget: Optional[int] = None,
            drain: bool = True) -> int:
        """Drive ``step()`` until the engine is idle (queue empty, no
        active slots) or ``steps_budget`` iterations elapse; returns the
        number of iterations run.  ``drain=False`` waits for work until
        the budget runs out or :meth:`stop`."""
        n = 0
        while not self._stop.is_set():
            if steps_budget is not None and n >= steps_budget:
                break
            busy = (self.scheduler.queue_depth > 0
                    or self.pool.busy_count > 0)
            if not busy:
                if drain:
                    break
                time.sleep(0.001)
                continue
            self.step()
            n += 1
        return n

    def start(self) -> None:
        """Background driver thread (idles when there is no work)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if (self.scheduler.queue_depth == 0
                        and self.pool.busy_count == 0):
                    time.sleep(0.002)
                    continue
                self.step()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def follow(self) -> int:
        """Model ranks other than 0: run the leader's device calls until
        it closes; returns how many ran.  The engine is closed after it
        (a later :meth:`close` does nothing)."""
        try:
            return self.engine.follow()
        finally:
            self._closed = True
            self.pool.caches = []
            self._unregister()

    def close(self) -> None:
        """Retire the engine: stop the driver thread, release the
        followers, drop the pool's device buffers and the flight
        provider; further submits raise.  The leader must reach it, also
        when its driving loop raises (``try`` / ``finally``): the
        followers wait in :meth:`follow` until it does."""
        self.stop()
        if not self._closed:
            self.engine.stop()
        self._closed = True
        self.pool.caches = []
        self._unregister()

    def _unregister(self) -> None:
        if _flight._PROVIDERS.get("serving") == self.introspect_state:
            _flight.unregister_provider("serving")

    # ---- metrics ----
    def reset_stats(self) -> None:
        """Zero the rolling stats and restart the throughput clock (after
        a warm-up); cache entries, pins and spilled payloads stay."""
        with self._lock:
            self._t0 = time.monotonic()
            self._ttft_ms = ReservoirSample(self.stats_capacity)
            self._tok_lat_ms = ReservoirSample(self.stats_capacity)
            self._tick_gap_ms = ReservoirSample(self.stats_capacity)
            self._last_tick_start = None
            self._tokens_emitted = 0
            self._ticks = 0
            self._occupancy_sum = 0.0
            self._rejected = 0
            self.goodput.reset()
            self._last_step_end = None
            self._slo_last = (0, self._t0)
            if self.prefix_cache is not None:
                pc = self.prefix_cache
                pc.hits = pc.misses = pc.tokens_reused = 0
                pc.insertions = pc.rejected_insertions = 0
                pc.evictions = 0
            if self.spill is not None:
                sp = self.spill
                sp.spills = sp.restores = sp.hits = sp.misses = 0
                sp.crc_refusals = sp.evictions = 0
                sp.rejected_oversize = 0

    def metrics(self) -> Dict[str, float]:
        """Host-side serving summary under the JAX engine's keys (the
        Prometheus extra gauges): throughput, latency percentiles, the
        tick-gap variance, ``serving/prefix/*``, ``serving/spill/*`` and
        the goodput gauges."""
        with self._lock:
            el = max(time.monotonic() - self._t0, 1e-9)
            out = {
                "serving/tokens_per_sec": self._tokens_emitted / el,
                "serving/tokens_total": float(self._tokens_emitted),
                "serving/ticks": float(self._ticks),
                "serving/queue_depth": float(self.scheduler.queue_depth),
                "serving/active_slots": float(self.pool.busy_count),
                "serving/rejected_total": float(self._rejected),
                "serving/slot_occupancy_pct": 100.0 * (
                    self._occupancy_sum / self._ticks if self._ticks
                    else 0.0),
            }
            for name, res in (("ttft", self._ttft_ms),
                              ("token_latency", self._tok_lat_ms),
                              ("tick_gap", self._tick_gap_ms)):
                p50 = res.percentile(50)
                if p50 is not None:
                    out[f"serving/{name}_p50_ms"] = p50
                    out[f"serving/{name}_p99_ms"] = res.percentile(99)
            gaps = self._tick_gap_ms.values()
            if len(gaps) >= 2:
                mean = sum(gaps) / len(gaps)
                out["serving/tick_gap_variance_ms2"] = (
                    sum((g - mean) ** 2 for g in gaps) / len(gaps))
        if self.prefix_cache is not None:
            for k, v in self.prefix_cache.stats().items():
                out[f"serving/prefix/{k}"] = v
            out["serving/prefix/cached_slots"] = float(
                self.pool.cached_count)
        if self.spill is not None:
            for k, v in self.spill.stats().items():
                out[f"serving/spill/{k}"] = v
        out.update(self.goodput.gauges("serving/goodput"))
        return out

    # ---- live introspection (/requestz, debug bundles) ----
    def requests_table(self) -> Dict[str, Any]:
        """Queued, running and recently finished requests with their trace
        ids and phase timestamps (the /requestz payload)."""
        with self._lock:
            running = [_request_row(r) for r in self._running.values()]
            recent = [_request_row(r) for r in self._recent]
        return {
            "schema": "chainermn_tpu.requestz.v1",
            "queued": [_request_row(r)
                       for r in self.scheduler.queued_requests()],
            "running": running,
            "recent": list(reversed(recent)),  # newest first
        }

    def introspect_state(self) -> Dict[str, Any]:
        """The ``serving`` flight provider: configuration, slot and queue
        occupancy, device-call counts, goodput, SLO state and the request
        table."""
        state: Dict[str, Any] = {
            "n_slots": self.pool.n_slots,
            "max_total": self.pool.max_total,
            "busy_slots": self.pool.busy_count,
            "free_slots": self.pool.free_count,
            "reserved_slots": self.pool.reserved_count,
            "queue_depth": self.scheduler.queue_depth,
            "queue_capacity": self.scheduler.queue_capacity,
            "ticks": self._ticks,
            "tokens_emitted": self._tokens_emitted,
            "rejected": self._rejected,
            "prefill_calls": self.engine.prefill_calls,
            "prefill_compiles": self.engine.prefill_compiles,
            "tick_calls": self.engine.tick_calls,
            "prefix_copies": self.engine.prefix_copies,
            "goodput": self.goodput.report(),
            "requests": self.requests_table(),
        }
        if self.prefix_cache is not None:
            state["prefix_cache"] = dict(
                self.prefix_cache.stats(),
                cached_slots=self.pool.cached_count,
                total_refcount=self.prefix_cache.total_refcount())
        if self.spill is not None:
            state["spill"] = self.spill.state()
        if self.slo is not None:
            state["slo"] = self.slo.status()
        return state

    def write_prometheus(self, path: str) -> str:
        """Atomic Prometheus textfile: the tracer's counters and gauges
        plus this summary as extra gauges."""
        from ..observability.export import write_prometheus_textfile
        return write_prometheus_textfile(path, extra_gauges=self.metrics())

    def finalize_metrics(self) -> None:
        """Append the ``serving_summary`` JSONL record when a metrics
        writer is configured."""
        if self.metrics_writer is not None:
            self.metrics_writer.write(self.metrics(), kind="serving_summary")
