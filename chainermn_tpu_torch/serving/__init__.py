"""Continuous-batching serving: scheduler, slot pool, decode engine,
frontend, prefix cache, host spill tier, replicas, the router, the
disaggregated prefill / decode fleet and the cross-process fleet.

Counterpart of ``chainermn_tpu/serving``: one engine on one card (or its
model ranks at TP > 1), the radix-trie prefix cache with copy-on-extend,
the bounded host spill tier, N in-process replicas behind
:class:`ServingRouter`, the role-split fleet behind :class:`DisaggRouter`
(prefill workers, decode workers and the KV-transfer plane between them,
at TP = 1), and the cross-process fleet: :class:`WorkerRuntime` role loops
(``engine`` / ``prefill`` / ``decode``), one process each, over the file
lanes' mailboxes, behind the supervised :class:`FleetRouter` (leases,
epoch fencing, the circuit breaker, failover, drain, the fleet cache index
and its priced pulls), with :func:`submit_with_retry`,
:class:`ModelRegistry` and :func:`rolling_upgrade`.  JAX's names that this
package does not have yet (the autoscaler and the scenario engine) are in
:data:`NOT_PORTED` and raise naming their ROADMAP.md queue item.
"""

from .autoscale import derive_retry_after_ms
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
from .scheduler import AdmissionError, Request, Scheduler
from .spill import HostSpillStore
from .tenancy import DegradationLadder, Tenant, TenantTable
from .transfer import KvTransferPlane

__all__ = ["AdmissionError", "CachePool", "DecodeEngine", "DecodeWorker",
           "DegradationLadder", "DisaggRouter", "FileLaneStore",
           "FleetCacheIndex", "FleetRouter", "HostSpillStore",
           "IndexRecord", "KvTransferPlane", "ModelRegistry",
           "ModelVariant", "PrefillWorker", "PrefixCache", "PrefixEntry",
           "Replica", "Request", "RequestHandle", "Scheduler",
           "ServingEngine", "ServingRouter", "SlotAllocator", "Tenant",
           "TenantTable", "WorkerClient", "WorkerRuntime",
           "build_disagg_fleet", "build_fleet", "build_local_fleet",
           "build_proc_fleet", "derive_retry_after_ms", "rolling_upgrade",
           "submit_with_retry"]

#: JAX's serving names not ported yet: name -> ROADMAP.md queue A item
#: (A11 step 3b: the autoscaler and the scenario engine).
NOT_PORTED = dict.fromkeys(
    ("AutoscalePolicy", "FleetAutoscaler", "SCENARIO_SCHEMA",
     "build_scenario", "run_scenario", "stream_digest",
     "materialize_prompt"), "A11")


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
