"""Training-loop extensions (reference: ``chainermn/extensions/``).

Ported so far: the observation aggregator and ``AllreducePersistent``.
The checkpoint, snapshot, preemption, watchdog and gang extensions of the
JAX package are ROADMAP.md's A7.
"""

from .allreduce_persistent import (  # noqa: F401
    AllreducePersistent,
    allreduce_persistent,
)
from .observation_aggregator import (  # noqa: F401
    ObservationAggregator,
    aggregate_observations,
)

__all__ = ["AllreducePersistent", "ObservationAggregator",
           "aggregate_observations", "allreduce_persistent"]
