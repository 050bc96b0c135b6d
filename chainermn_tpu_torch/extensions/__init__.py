"""Training-loop extensions (reference: ``chainermn/extensions/``).

The JAX package's extensions, all ported: the checkpointer (v2
manifests, elastic resume), replica-set snapshots, the preemption
handler, the watchdog, the self-healing gang, the observation aggregator
and ``AllreducePersistent``.
"""

from .allreduce_persistent import (  # noqa: F401
    AllreducePersistent,
    allreduce_persistent,
)
from .checkpoint import (  # noqa: F401
    MANIFEST_SCHEMA,
    MultiNodeCheckpointer,
    create_multi_node_checkpointer,
    reshard_checkpoint,
)
from .gang import GangReconfig, SelfHealingGang  # noqa: F401
from .multi_node_snapshot import (  # noqa: F401
    MultiNodeSnapshot,
    multi_node_snapshot,
)
from .observation_aggregator import (  # noqa: F401
    ObservationAggregator,
    aggregate_observations,
)
from .preemption import PreemptionExit, PreemptionHandler  # noqa: F401
from .watchdog import Watchdog  # noqa: F401

__all__ = [
    "GangReconfig",
    "SelfHealingGang",
    "AllreducePersistent",
    "allreduce_persistent",
    "MANIFEST_SCHEMA",
    "MultiNodeCheckpointer",
    "create_multi_node_checkpointer",
    "reshard_checkpoint",
    "MultiNodeSnapshot",
    "multi_node_snapshot",
    "ObservationAggregator",
    "aggregate_observations",
    "PreemptionExit",
    "PreemptionHandler",
    "Watchdog",
]
