"""Admission + eviction policy for the continuous-batching engine.

A copy of ``chainermn_tpu/serving/scheduler.py`` (pure host Python): the
scheduler decides WHICH sequences occupy the fixed slot pool each tick;
the engine decides what the card computes.

* **Bounded FIFO queue with backpressure.**  ``submit`` raises
  :class:`AdmissionError` with a machine-readable ``reason`` the moment
  the queue is full (``queue_full``) or the request can never fit its
  slot (``too_long``) — a loaded server must refuse work it cannot
  start, not buffer it into an OOM.
* **Prefill/decode interleaving.**  At most ``max_prefills_per_tick``
  waiting requests are prefilled before each decode tick.  Admission is
  strictly FIFO among queued requests.
* **Eviction.**  A sequence leaves its slot when it emits ``eos_id``
  (``eos``), reaches ``max_new_tokens`` (``max_tokens``), or blows its
  deadline (``deadline`` — checked both while queued and while
  decoding).
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from typing import Callable, Deque, List, Optional


class AdmissionError(Exception):
    """Backpressure signal: the request was REJECTED, with a reason.

    ``reason`` is machine-readable: ``queue_full`` (bounded queue at
    capacity — retry later / shed load upstream), ``too_long`` (the
    request can never fit: prompt + max_new_tokens exceeds the pool's
    per-slot capacity or the model's position table), or ``shed_slo``
    (the router's SLO-aware admission control shed the request BEFORE
    the burn-rate tracker pages — degrade by rejecting, not by letting
    the queues collapse).

    ``retry_after_ms`` / ``queue_depth`` ride along when the rejecting
    layer can estimate them (the router always fills both) so a client
    can back off intelligently instead of hammering; ``to_dict()`` is
    the wire shape the serving JSONL stream and HTTP 429 bodies carry.

    ``tenant`` / ``rung``: a multi-tenant rejection names
    WHO was shed and at which degradation-ladder rung — reason
    ``shed_tenant_budget`` (per-tenant admission budget exhausted, or
    best-effort admission paused at the top rung) carries both, and
    ``shed_slo``/``queue_full`` carry tenant attribution whenever the
    submit was tagged.  Absent for untagged traffic, so pre-tenancy
    wire consumers see exactly the old shape.
    """

    def __init__(self, reason: str, detail: str = "", *,
                 retry_after_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 tenant: Optional[str] = None,
                 rung: Optional[int] = None):
        self.reason = reason
        self.detail = detail
        self.retry_after_ms = (None if retry_after_ms is None
                               else float(retry_after_ms))
        self.queue_depth = (None if queue_depth is None
                            else int(queue_depth))
        self.tenant = None if tenant is None else str(tenant)
        self.rung = None if rung is None else int(rung)
        super().__init__(f"{reason}: {detail}" if detail else reason)

    def to_dict(self) -> dict:
        out = {"reason": self.reason, "detail": self.detail}
        if self.retry_after_ms is not None:
            out["retry_after_ms"] = round(self.retry_after_ms, 3)
        if self.queue_depth is not None:
            out["queue_depth"] = self.queue_depth
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.rung is not None:
            out["rung"] = self.rung
        return out


class Request:
    """One generation request's host-side state.

    ``timestamps`` records the phase transitions (monotonic seconds):
    ``submitted`` → ``prefill_start`` → ``first_token`` → ``finished``
    — the per-request span data the observability wiring exports and
    the iteration-level-batching integration test asserts on.

    ``trace_id`` is the request's DISTRIBUTED TRACE IDENTITY:
    unique per process lifetime, stamped on every tracer span/flow
    event, flight-recorder entry, ``/requestz`` row, and streamed token
    record this request produces, so one grep correlates a request
    across the Perfetto timeline, the metrics stream, and a postmortem
    bundle.  A caller-supplied ``trace_id`` (the router mints one per
    request BEFORE dispatch) survives the hop unchanged so
    router-side and replica-side spans merge into one Perfetto lane.

    ``forced`` holds prompt-suffix tokens a prefix-cache hit still owes
    the engine: the cached prefix's K/V was copied in, and the suffix
    is consumed one token per decode tick (each tick writes the
    consumed token's K/V row; its prediction is discarded until the
    LAST prompt token, whose prediction is the first generated token).
    """

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 deadline_t: Optional[float] = None,
                 on_token: Optional[Callable] = None,
                 trace_id: Optional[str] = None,
                 temperature: float = 0.0,
                 rng=None,
                 tenant: Optional[str] = None):
        self.id = next(Request._ids)
        # pid disambiguates across engine restarts on one box; the
        # counter disambiguates within the process
        self.trace_id = trace_id or f"req-{os.getpid():x}-{self.id:08x}"
        self.prompt = prompt
        self.prompt_len = len(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline_t = deadline_t      # absolute monotonic, or None
        self.on_token = on_token
        # sampling plumbing: the lm_generate rng contract —
        # ``temperature > 0`` requires an explicit per-request rng key
        # (a (2,) uint32 PRNGKey, normalized by the frontend); greedy
        # requests carry 0.0 and None.  Both ride the transfer wire
        # unchanged so a disaggregated decode worker samples the exact
        # tokens the fused engine would.
        self.temperature = float(temperature)
        self.rng = rng
        # multi-tenant QoS: the tenant this request bills to
        # (None = untagged).  Rides the fleet wire so worker-side
        # /requestz rows and shed payloads keep the attribution.
        self.tenant = None if tenant is None else str(tenant)
        self.tokens: List[int] = []       # generated tokens, in order
        self.status = "queued"            # queued|running|done|evicted
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self.timestamps = {}
        self.done_event = threading.Event()
        # prefix-cache state: set at admission on a hit
        self.forced: Deque[int] = deque()  # prompt suffix still to feed
        self.prefix_entry = None           # pinned PrefixEntry, or None
        self.prefix_len = 0                # cached tokens skipped

    def finish(self, reason: str, now: float) -> None:
        self.status = "done" if reason in ("eos", "max_tokens") else "evicted"
        self.finish_reason = reason
        self.timestamps["finished"] = now
        self.slot = None
        self.done_event.set()


class Scheduler:
    """Admission queue + slot assignment policy (host state only; the
    caller owns the actual slot pool and engine).

    Thread-safe for ``submit`` against a driver thread calling
    ``expire_queued``/``admissions`` (one lock around the queue).
    """

    def __init__(self, queue_capacity: int, slot_capacity: int,
                 max_prefills_per_tick: int = 1,
                 max_positions: Optional[int] = None):
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, "
                             f"got {queue_capacity}")
        self.queue_capacity = int(queue_capacity)
        self.slot_capacity = int(slot_capacity)   # max_total per slot
        self.max_prefills_per_tick = max(int(max_prefills_per_tick), 1)
        self.max_positions = max_positions        # learned-pos table bound
        self._queue: Deque[Request] = deque()
        self._lock = threading.Lock()

    # ---- admission ----
    def submit(self, req: Request, now: float) -> None:
        """Enqueue or raise :class:`AdmissionError` (backpressure)."""
        total = req.prompt_len + req.max_new_tokens
        cap = self.slot_capacity
        if self.max_positions is not None:
            cap = min(cap, self.max_positions)
        if req.prompt_len < 1:
            raise AdmissionError("too_long", "empty prompt")
        if req.max_new_tokens < 1:
            raise AdmissionError("too_long", "max_new_tokens < 1")
        if total > cap:
            raise AdmissionError(
                "too_long",
                f"prompt {req.prompt_len} + max_new {req.max_new_tokens} "
                f"= {total} exceeds per-slot capacity {cap}")
        with self._lock:
            if len(self._queue) >= self.queue_capacity:
                raise AdmissionError(
                    "queue_full",
                    f"admission queue at capacity {self.queue_capacity}")
            req.timestamps["submitted"] = now
            self._queue.append(req)

    def expire_queued(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline already passed (they could
        only ever return a too-late answer); returns them, finished with
        reason ``deadline``."""
        expired: List[Request] = []
        with self._lock:
            keep: Deque[Request] = deque()
            for req in self._queue:
                if req.deadline_t is not None and now >= req.deadline_t:
                    expired.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        for req in expired:
            req.finish("deadline", now)
        return expired

    def admissions(self, free_slots: int, now: float) -> List[Request]:
        """Pop the FIFO-next requests to prefill this tick: at most
        ``min(free_slots, max_prefills_per_tick)``."""
        out: List[Request] = []
        n = min(int(free_slots), self.max_prefills_per_tick)
        with self._lock:
            while n > 0 and self._queue:
                out.append(self._queue.popleft())
                n -= 1
        return out

    def requeue_front(self, req: Request) -> None:
        """Put an already-admitted request back at the queue HEAD
        (FIFO preserved) when its slot fell through — e.g. a sibling
        admission's prefix hit pinned the cached slot this one was
        counting on scavenging, or a disaggregated transfer found no
        destination.  Bypasses the capacity check: the
        request was already accepted once and must not be re-rejected."""
        with self._lock:
            self._queue.appendleft(req)

    def drain(self) -> List[Request]:
        """Remove and return every queued request, FIFO order — the
        disagg router's dead-worker sweep re-dispatches (or sheds) a
        victim's queue through this instead of stranding the handles
        un-done forever."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
        return out

    # ---- eviction ----
    def eviction_reason(self, req: Request, now: float) -> Optional[str]:
        """Why ``req`` must leave its slot NOW, or None to keep decoding.
        Checked after every emitted token; precedence eos > max_tokens >
        deadline (an EOS on the final permitted token reports ``eos``)."""
        if req.eos_id is not None and req.tokens \
                and req.tokens[-1] == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "max_tokens"
        if req.deadline_t is not None and now >= req.deadline_t:
            return "deadline"
        return None

    # ---- introspection ----
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def queued_requests(self) -> List[Request]:
        """Snapshot of the queue, FIFO order (the /requestz view)."""
        with self._lock:
            return list(self._queue)
