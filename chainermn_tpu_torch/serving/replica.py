"""One serving replica: a named :class:`ServingEngine` + its driver.

A copy of ``chainermn_tpu/serving/replica.py``.

The router (``router.py``) composes N of these into one service — the
ChainerMN ``hierarchical``-communicator lesson applied to serving: a
fast intra-replica lane (the engine's compiled tick over its own slot
pool) under a slower inter-replica lane (host-side dispatch).  The
wrapper is deliberately thin: the engine already owns scheduling,
observability, and metrics; the replica adds only what the ROUTER needs
to make a dispatch decision without reaching into engine internals —

* a stable ``name`` (trace spans, metrics key prefixes, /statusz keys);
* :meth:`load` — the backlog estimate the least-loaded scorer ranks
  (queued + running work in TOKEN units, so prefix-affinity savings
  compare against backlog costs in one currency);
* :meth:`peek_prefix_len` — how much of a prompt this replica's radix
  trie already holds, via the non-mutating peek (probing losers must
  not distort hit rates or LRU order).

In-process replicas each run their own engine (own pool, own kernels'
launches); on one card they share the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .frontend import RequestHandle, ServingEngine


class Replica:
    """Named wrapper around one :class:`ServingEngine`."""

    def __init__(self, name: str, engine: ServingEngine):
        self.name = str(name)
        self.engine = engine

    @classmethod
    def build(cls, params, name: str, **engine_kwargs) -> "Replica":
        return cls(name, ServingEngine(params, **engine_kwargs))

    # ---- dispatch inputs ----
    def load(self) -> Dict[str, Any]:
        """Host-side load snapshot in token units.

        ``backlog_tokens`` = work admitted but not yet delivered: every
        queued request's full cost (prompt prefill + generation) plus
        every running request's remaining generation.  The router's
        score subtracts it from the prefix-affinity credit, and its
        deadline feasibility check multiplies it by the replica's
        measured per-token latency.
        """
        eng = self.engine
        queued = eng.scheduler.queued_requests()
        backlog = sum(r.prompt_len + r.max_new_tokens for r in queued)
        with eng._lock:
            running = list(eng._running.values())
        backlog += sum(max(r.max_new_tokens - len(r.tokens), 0)
                       + len(r.forced) for r in running)
        return {
            "name": self.name,
            "queue_depth": len(queued),
            "queue_capacity": eng.scheduler.queue_capacity,
            "busy_slots": eng.pool.busy_count,
            "free_slots": eng.pool.free_count,
            "cached_slots": eng.pool.cached_count,
            "backlog_tokens": int(backlog),
        }

    def peek_prefix_len(self, prompt) -> int:
        if self.engine.prefix_cache is None:
            return 0
        return self.engine.prefix_cache.peek_len(prompt)

    def token_latency_ms(self, default: float = 20.0) -> float:
        """Measured per-token latency p50 (ms), or ``default`` before
        any tick has been sampled — the deadline estimator's clock."""
        p50 = self.engine._tok_lat_ms.percentile(50)
        return float(p50) if p50 else float(default)

    # ---- pass-throughs ----
    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token=None,
               trace_id: Optional[str] = None,
               temperature: float = 0.0, rng=None,
               tenant: Optional[str] = None) -> RequestHandle:
        return self.engine.submit(
            prompt, max_new_tokens, eos_id=eos_id, deadline_s=deadline_s,
            on_token=on_token, trace_id=trace_id, temperature=temperature,
            rng=rng, tenant=tenant)

    def step(self):
        return self.engine.step()

    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    def close(self) -> None:
        self.engine.close()

    @property
    def idle(self) -> bool:
        return (self.engine.scheduler.queue_depth == 0
                and self.engine.pool.busy_count == 0)
