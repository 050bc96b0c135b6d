"""Training-loop extensions (reference: ``chainermn/extensions/``).

Ported so far: the observation aggregator.  The checkpoint, snapshot,
preemption, watchdog, gang and ``allreduce_persistent`` extensions of the
JAX package are ROADMAP.md's A5 and A7.
"""

from .observation_aggregator import (  # noqa: F401
    ObservationAggregator,
    aggregate_observations,
)

__all__ = ["ObservationAggregator", "aggregate_observations"]
