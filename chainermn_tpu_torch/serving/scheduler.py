"""Admission + eviction policy for the continuous-batching engine.

A copy of ``chainermn_tpu/serving/scheduler.py`` (pure host Python),
trimmed to what this slice serves: no prefix-cache suffix feeding, no
tenancy, no trace ids, no requeue/drain for fleets.

* **Bounded FIFO queue with backpressure.**  ``submit`` raises
  :class:`AdmissionError` with a machine-readable ``reason`` when the
  queue is full (``queue_full``) or the request can never fit its slot
  (``too_long``).
* **Prefill/decode interleaving.**  At most ``max_prefills_per_tick``
  waiting requests are prefilled before each decode tick; admission is
  strictly FIFO.
* **Eviction.**  A sequence leaves its slot when it emits ``eos_id``
  (``eos``), reaches ``max_new_tokens`` (``max_tokens``) or blows its
  deadline (``deadline`` — checked while queued and while decoding).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Callable, Deque, List, Optional


class AdmissionError(Exception):
    """Backpressure signal: the request was REJECTED, with a reason
    (``queue_full`` or ``too_long``)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}: {detail}" if detail else reason)

    def to_dict(self) -> dict:
        return {"reason": self.reason, "detail": self.detail}


class Request:
    """One generation request's host-side state.  ``timestamps`` records
    ``submitted`` → ``prefill_start`` → ``first_token`` → ``finished``
    (monotonic seconds).  ``temperature > 0`` samples its tokens with the
    key ``rng`` (uint32 ``(2,)``); greedy requests carry neither."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 deadline_t: Optional[float] = None,
                 on_token: Optional[Callable] = None,
                 temperature: float = 0.0, rng=None):
        self.id = next(Request._ids)
        self.prompt = prompt
        self.prompt_len = len(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline_t = deadline_t      # absolute monotonic, or None
        self.on_token = on_token
        self.temperature = float(temperature)
        self.rng = rng
        self.tokens: List[int] = []       # generated tokens, in order
        self.status = "queued"            # queued|running|done|evicted
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self.timestamps = {}
        self.done_event = threading.Event()

    def finish(self, reason: str, now: float) -> None:
        self.status = "done" if reason in ("eos", "max_tokens") else "evicted"
        self.finish_reason = reason
        self.timestamps["finished"] = now
        self.slot = None
        self.done_event.set()


class Scheduler:
    """Admission queue + slot assignment policy (host state only; the
    caller owns the slot pool and engine).  ``submit`` is thread-safe
    against a driver calling ``expire_queued``/``admissions``."""

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
        """Drop and return queued requests whose deadline passed, finished
        with reason ``deadline``."""
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

    def eviction_reason(self, req: Request, now: float) -> Optional[str]:
        """Why ``req`` must leave its slot now, or None; precedence eos >
        max_tokens > deadline."""
        if req.eos_id is not None and req.tokens \
                and req.tokens[-1] == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "max_tokens"
        if req.deadline_t is not None and now >= req.deadline_t:
            return "deadline"
        return None

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)
