"""Heartbeat / lease health plane for the cross-process serving fleet.

Counterpart of ``chainermn_tpu/serving/health.py``: a re-export of the
transport-agnostic core :mod:`chainermn_tpu_torch.health`, which the
training gang's self-healing plane runs too.  See the core module for the
semantics (the detection-window arithmetic, receiver-side clocking, epoch
fencing, the circuit breaker).
"""

from __future__ import annotations

from ..health import (  # noqa: F401
    LEASE_SCHEMA,
    CircuitBreaker,
    EpochFence,
    HeartbeatPublisher,
    LeaseTable,
    detection_window_s,
    make_lease,
)

__all__ = [
    "LEASE_SCHEMA",
    "CircuitBreaker",
    "EpochFence",
    "HeartbeatPublisher",
    "LeaseTable",
    "detection_window_s",
    "make_lease",
]
