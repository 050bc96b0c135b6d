"""The drain-aware back-off hint of ``chainermn_tpu/serving/autoscale.py``.

:func:`derive_retry_after_ms` (a copy): ``retry_after_ms`` = tokens
queued / recent tokens-per-second, clamped and jittered, so clients back
off in proportion to real congestion.  The router's rejections carry it.

The autoscaler itself (``AutoscalePolicy``, ``FleetAutoscaler``) drives
the cross-process fleet and is ROADMAP.md's A11 step 3: its names are in
:data:`NOT_PORTED` and raise naming the queue item.
"""

from __future__ import annotations

import random
from typing import Optional

#: The module's names not ported yet: name -> ROADMAP.md queue A item.
NOT_PORTED = {"AutoscalePolicy": "A11", "FleetAutoscaler": "A11",
              "UP_SIGNALS": "A11", "local_spawn_factory": "A11",
              "proc_spawn_factory": "A11"}


def __getattr__(name):
    if name in NOT_PORTED:
        raise AttributeError(
            f"chainermn_tpu_torch.serving.autoscale.{name} is not ported "
            f"yet: see ROADMAP.md, queue A, {NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def derive_retry_after_ms(backlog_tokens: float, tokens_per_sec: float, *,
                          default_token_latency_ms: float = 20.0,
                          floor_ms: float = 1.0,
                          cap_ms: float = 30_000.0,
                          jitter_frac: float = 0.1,
                          rng: Optional[random.Random] = None) -> float:
    """Back-off hint from the MEASURED backlog drain rate.

    ``backlog_tokens / tokens_per_sec`` is the wall the queue needs to
    drain at the recent throughput — the honest "come back when
    capacity plausibly exists" signal.  Edge cases, each clamped into
    ``[floor_ms, cap_ms]``:

    * ``backlog_tokens <= 0`` → ``floor_ms`` (no congestion: retry
      immediately-ish; the floor keeps the hint truthy).
    * ``tokens_per_sec <= 0`` with backlog (cold start, or a wedged
      fleet emitting nothing) → price the backlog at
      ``default_token_latency_ms`` per token instead of dividing by
      zero; the cap bounds the hint when the backlog is huge.

    ``jitter_frac`` spreads retries ±uniformly so a shed burst does not
    re-arrive as a synchronized herd (same rationale as
    ``submit_with_retry``); pass ``rng`` (or ``jitter_frac=0``) for
    deterministic tests.  The jittered value is re-clamped, so the
    bounds hold unconditionally.
    """
    backlog = max(float(backlog_tokens), 0.0)
    tps = float(tokens_per_sec)
    if backlog <= 0.0:
        est = float(floor_ms)
    elif tps > 1e-9:
        est = backlog / tps * 1e3
    else:
        est = backlog * float(default_token_latency_ms)
    est = min(max(est, float(floor_ms)), float(cap_ms))
    if jitter_frac > 0.0:
        u = (rng or random).random()
        est *= 1.0 + float(jitter_frac) * (2.0 * u - 1.0)
        est = min(max(est, float(floor_ms)), float(cap_ms))
    return est
