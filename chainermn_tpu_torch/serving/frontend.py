"""Serving API: submit → handle, one engine iteration per ``step``, metrics.

Counterpart of ``chainermn_tpu/serving/frontend.py``.
:class:`ServingEngine` glues the scheduler, the slot pool and the decode
engine into the loop a service runs::

    eng = ServingEngine(params, head_dim=64, n_slots=8, max_total=1024)
    h = eng.submit([3, 1, 4], max_new_tokens=16)
    eng.run()
    print(h.tokens, h.status, h.ttft_ms)

Each ``step()`` expires overdue queued work, admits (prefills) up to the
interleaving bound, runs ONE decode tick over the pool, streams the new
tokens and evicts finished sequences, so requests join and leave between
ticks (continuous batching).  ``metrics()`` reports the JAX engine's
``serving/*`` keys that this slice has.  Requests are greedy, or sampled
with their own key (``temperature`` and ``rng`` at submit); GQA models
serve like any other.

Tensor parallelism (``mesh=``, JAX ``frontend.py:169-189``): every rank of
the model axis builds the engine over its shards; model rank 0 submits,
schedules and steps it, and every device call it makes is broadcast as a
plan to the other ranks, which call :meth:`ServingEngine.follow` and run
those calls until the leader's :meth:`close`, which the leader calls in
a ``finally`` so that the followers return when its loop raises.  Not
in this slice: prefix cache, host spill, flight recorder, tracer, SLO
tracking, the background thread that steps the engine (``start``/``stop``), prefill length buckets and trace ids.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .._device import resolve_device
from ..convert import tree_map
from ..observability.slo import ReservoirSample
from ..parallel.decode import _kv_heads
from .cache_pool import CachePool
from .engine import DecodeEngine
from .scheduler import AdmissionError, Request, Scheduler

# latency samples kept per percentile (the JAX engine's default)
_STATS_CAPACITY = 1024


class RequestHandle:
    """Caller's view of one submitted request."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def id(self) -> int:
        return self._req.id

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

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes; True iff it did."""
        return self._req.done_event.wait(timeout)


class ServingEngine:
    """Continuous-batching inference over a slot-managed KV pool.

    ``params``: ``init_tp_transformer_lm`` tensors (moved to ``device``);
    with ``mesh``, this rank's shards over ``axis_name``
    (``transformer_lm_specs``), and the pool holds this rank's KV heads.
    ``max_total`` bounds each slot's sequence (prompt + generated); a
    request that cannot fit is rejected at submit (``AdmissionError``,
    reason ``too_long``), as is any submit while the bounded queue is full
    (``queue_full``).
    """

    def __init__(self, params, *, head_dim: int, n_slots: int = 4,
                 max_total: int = 128, queue_capacity: int = 16,
                 max_prefills_per_tick: int = 1, mesh=None,
                 axis_name: str = "model", device="cuda"):
        dev = resolve_device(device)
        n_kv = _kv_heads(params, head_dim)
        params = tree_map(params, lambda t: t.to(dev))
        self.pool = CachePool(n_slots, max_total, len(params["blocks"]),
                              n_kv * head_dim, params["embed"].dtype, dev)
        self.engine = DecodeEngine(params, self.pool, mesh, axis_name,
                                   head_dim=head_dim)
        self.scheduler = Scheduler(
            queue_capacity, max_total,
            max_prefills_per_tick=max_prefills_per_tick,
            max_positions=self.engine.max_positions)
        self._running: Dict[int, Request] = {}   # slot -> request
        # per-slot sampling operands: each slot's request key and
        # temperature ride every tick; greedy and free slots carry zeros
        self._slot_keys = np.zeros((n_slots, 2), np.uint32)
        self._slot_temps = np.zeros(n_slots, np.float32)
        self._lock = threading.Lock()            # guards _running + stats
        self._closed = False
        self._ttft_ms = ReservoirSample(_STATS_CAPACITY)
        self._tok_lat_ms = ReservoirSample(_STATS_CAPACITY)
        # wall between consecutive tick starts while work is active: the
        # inter-token latency a decoding request sees (a prefill between
        # ticks inflates it)
        self._tick_gap_ms = ReservoirSample(_STATS_CAPACITY)
        self._last_tick_start: Optional[float] = None
        self._tokens_emitted = 0
        self._ticks = 0
        self._occupancy_sum = 0.0
        self._rejected = 0
        self._t0 = time.monotonic()

    # ---- submission ----
    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               temperature: float = 0.0, rng=None) -> RequestHandle:
        """Enqueue a generation request; raises :class:`AdmissionError`
        (with ``.reason``) when the queue is full or it can never fit.
        ``on_token(token, request_id)`` streams each emitted token;
        ``deadline_s`` is relative to now.  ``temperature > 0`` samples the
        request's tokens and needs its key ``rng`` (``ValueError``
        otherwise: a silent default key would draw identical sequences)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        temperature = float(temperature)
        if temperature > 0.0 and rng is None:
            raise ValueError(
                "temperature > 0 samples tokens and needs an explicit rng "
                "key (prng.PRNGKey(...)): a silent default key would make "
                "every sampled request draw identical token sequences")
        now = time.monotonic()
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        req = Request(prompt, max_new_tokens, eos_id=eos_id,
                      deadline_t=(now + deadline_s
                                  if deadline_s is not None else None),
                      on_token=on_token, temperature=temperature,
                      rng=(None if rng is None
                           else np.asarray(rng).astype(np.uint32).reshape(2)))
        try:
            self.scheduler.submit(req, now)
        except AdmissionError:
            with self._lock:
                self._rejected += 1
            raise
        return RequestHandle(req)

    # ---- the engine iteration ----
    def step(self) -> Dict[str, float]:
        """ONE engine iteration: expire → admit/prefill → tick → evict."""
        now = time.monotonic()
        self.scheduler.expire_queued(now)
        for req in self.scheduler.admissions(self.pool.free_count, now):
            slot = self.pool.acquire()
            req.slot = slot
            req.status = "running"
            req.timestamps["prefill_start"] = time.monotonic()
            self._slot_keys[slot] = (req.rng if req.rng is not None
                                     else np.zeros(2, np.uint32))
            self._slot_temps[slot] = req.temperature
            try:
                first = self.engine.prefill_into_slot(
                    req.prompt, slot, req.rng, req.temperature)
            except BaseException:
                # never die holding a slot: the failed request is finished
                # with reason "error" and its slot freed before re-raising
                req.finish("error", time.monotonic())
                self._slot_temps[slot] = 0.0
                self._release(slot)
                raise
            self._emit(req, first, time.monotonic())
            with self._lock:
                self._running[slot] = req
            self._maybe_evict(req, time.monotonic())

        with self._lock:
            active = dict(self._running)
        if active:
            tokens = np.zeros(self.pool.n_slots, np.int32)
            for slot, req in active.items():
                tokens[slot] = req.tokens[-1]
            t_tick = time.monotonic()
            with self._lock:
                if self._last_tick_start is not None:
                    self._tick_gap_ms.add(
                        (t_tick - self._last_tick_start) * 1e3)
                self._last_tick_start = t_tick
            nxt = self.engine.tick(tokens, self._slot_keys, self._slot_temps)
            now = time.monotonic()
            dt_ms = (now - t_tick) * 1e3
            for slot, req in active.items():
                self._emit(req, int(nxt[slot]), now)
                self._tok_lat_ms.add(dt_ms / len(active))
                self._maybe_evict(req, now)
        else:
            # an idle step breaks the tick cadence
            with self._lock:
                self._last_tick_start = None

        with self._lock:
            self._ticks += 1
            self._occupancy_sum += self.pool.busy_count / self.pool.n_slots
            return {
                "queue_depth": float(self.scheduler.queue_depth),
                "active_slots": float(self.pool.busy_count),
                "tokens_emitted": float(self._tokens_emitted),
            }

    def _emit(self, req: Request, token: int, now: float) -> None:
        req.tokens.append(int(token))
        if "first_token" not in req.timestamps:
            req.timestamps["first_token"] = now
            with self._lock:
                self._ttft_ms.add((now - req.timestamps["submitted"]) * 1e3)
        with self._lock:
            self._tokens_emitted += 1
        if req.on_token is not None:
            req.on_token(int(token), req.id)

    def _maybe_evict(self, req: Request, now: float) -> None:
        reason = self.scheduler.eviction_reason(req, now)
        if reason is None:
            return
        slot = req.slot
        req.finish(reason, now)
        with self._lock:
            self._running.pop(slot, None)
        # a free slot keeps ticking: its discarded row goes back to greedy
        self._slot_temps[slot] = 0.0
        self._release(slot)

    def _release(self, slot: int) -> None:
        self.engine.reset_slot(slot)          # on every model rank
        self.pool.release(slot)

    # ---- driving ----
    def run(self, steps_budget: Optional[int] = None) -> int:
        """Drive ``step()`` until the engine is idle (queue empty, no active
        slots) or ``steps_budget`` iterations elapse; returns the number of
        iterations run."""
        n = 0
        while steps_budget is None or n < steps_budget:
            if self.scheduler.queue_depth == 0 and self.pool.busy_count == 0:
                break
            self.step()
            n += 1
        return n

    def follow(self) -> int:
        """Model ranks other than 0: run the leader's device calls until
        it closes; returns how many ran.  The engine is closed after it
        (a later :meth:`close` does nothing)."""
        try:
            return self.engine.follow()
        finally:
            self._closed = True
            self.pool.caches = []

    def close(self) -> None:
        """Retire the engine: further submits raise, the followers are
        released and the pool's device buffers are dropped.  The leader
        must reach it, also when its driving loop raises (``try`` /
        ``finally``): the followers wait in :meth:`follow` until it
        does."""
        if not self._closed:
            self.engine.stop()
        self._closed = True
        self.pool.caches = []

    # ---- metrics ----
    def metrics(self) -> Dict[str, float]:
        """Host-side serving summary under the JAX engine's keys."""
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
        return out
