"""Continuous-batching serving: scheduler, slot pool, decode engine,
frontend, prefix cache, host spill tier, replicas, the router, the
disaggregated prefill / decode fleet and the cross-process fleet.

Counterpart of ``chainermn_tpu/serving``: one engine on one card (or its
model ranks at TP > 1), the radix-trie prefix cache with copy-on-extend,
the bounded host spill tier, N in-process replicas behind
:class:`ServingRouter`, the role-split fleet behind :class:`DisaggRouter`
(prefill workers, decode workers and the KV-transfer plane between them),
the cross-process fleet: :class:`WorkerRuntime` role loops
(``engine`` / ``prefill`` / ``decode``), one process each, over the file
lanes' mailboxes, behind the supervised :class:`FleetRouter` (leases,
epoch fencing, the circuit breaker, failover, drain, the fleet cache index
and its priced pulls), with :func:`submit_with_retry`,
:class:`ModelRegistry` and :func:`rolling_upgrade`, the load-driven
:class:`FleetAutoscaler` (one :class:`AutoscalePolicy` a role) and the
seeded scenario engine (:func:`build_scenario`, :func:`run_scenario`).
The in-process fleets (replicas and the role-split fleet) run at TP > 1
too: model rank 0 hosts the router and every engine, the other ranks
build the same fleet and follow its one plan.
"""

from .autoscale import (AutoscalePolicy, FleetAutoscaler,
                        derive_retry_after_ms)
from .cache_pool import CachePool, SlotAllocator
# request_wire resolves here too; JAX's __all__ leaves it to disagg
from .disagg import (DecodeWorker, DisaggRouter, PrefillWorker,  # noqa: F401
                     build_disagg_fleet, request_wire)
from .engine import DecodeEngine
from .fleet_cache import FleetCacheIndex, IndexRecord
from .frontend import RequestHandle, ServingEngine
from .lanes import FileLaneStore
from .models import ModelRegistry, ModelVariant
from .prefix_cache import PrefixCache, PrefixEntry
from .replica import Replica
from .router import ServingRouter, build_fleet
from .scenarios import (SCENARIO_SCHEMA, build_scenario, materialize_prompt,
                        run_scenario, stream_digest)
from .scheduler import AdmissionError, Request, Scheduler
from .spill import HostSpillStore
from .tenancy import DegradationLadder, Tenant, TenantTable
from .transfer import KvTransferPlane

__all__ = ["AdmissionError", "AutoscalePolicy", "CachePool",
           "DecodeEngine", "DecodeWorker", "DegradationLadder",
           "DisaggRouter", "FileLaneStore", "FleetAutoscaler",
           "FleetCacheIndex", "FleetRouter", "HostSpillStore",
           "IndexRecord", "KvTransferPlane", "ModelRegistry",
           "ModelVariant", "PrefillWorker", "PrefixCache", "PrefixEntry",
           "Replica", "Request", "RequestHandle", "SCENARIO_SCHEMA",
           "Scheduler", "ServingEngine", "ServingRouter", "SlotAllocator",
           "Tenant", "TenantTable", "WorkerClient", "WorkerRuntime",
           "build_disagg_fleet", "build_fleet", "build_local_fleet",
           "build_proc_fleet", "build_scenario", "derive_retry_after_ms",
           "materialize_prompt", "rolling_upgrade", "run_scenario",
           "stream_digest", "submit_with_retry"]

#: JAX's serving names not ported yet: name -> ROADMAP.md queue A item
#: (empty: A11 step 3b brought the autoscaler and the scenario engine).
NOT_PORTED: dict = {}


#: Resolved on first use: ``python -m chainermn_tpu_torch.serving.worker``
#: (the fleet's process entry) must not find its module imported already.
_LAZY = {"WorkerRuntime": "worker", "FleetRouter": "fleet",
         "WorkerClient": "fleet", "build_local_fleet": "fleet",
         "build_proc_fleet": "fleet", "rolling_upgrade": "fleet",
         "submit_with_retry": "fleet"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    if name in NOT_PORTED:
        raise AttributeError(
            f"chainermn_tpu_torch.serving.{name} is not ported yet: see "
            f"ROADMAP.md, queue A, {NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
