"""Continuous-batching serving: scheduler, slot pool, decode engine,
frontend, prefix cache, host spill tier, replicas, the router and the
disaggregated prefill / decode fleet.

Counterpart of ``chainermn_tpu/serving``: one engine on one card (or its
model ranks at TP > 1), the radix-trie prefix cache with copy-on-extend,
the bounded host spill tier, N in-process replicas behind
:class:`ServingRouter`, and the role-split fleet behind
:class:`DisaggRouter` (prefill workers, decode workers and the KV-transfer
plane between them, at TP = 1).  JAX's names that this package does not
have yet (the cross-process fleet and its workers, the autoscaler, the
fleet cache index, the model registry, the scenario engine) are in
:data:`NOT_PORTED` and raise naming their ROADMAP.md queue item.
"""

from .autoscale import derive_retry_after_ms
from .cache_pool import CachePool, SlotAllocator
# request_wire resolves here too; JAX's __all__ leaves it to disagg
from .disagg import (DecodeWorker, DisaggRouter, PrefillWorker,  # noqa: F401
                     build_disagg_fleet, request_wire)
from .engine import DecodeEngine
from .frontend import RequestHandle, ServingEngine
from .lanes import FileLaneStore
from .prefix_cache import PrefixCache, PrefixEntry
from .replica import Replica
from .router import ServingRouter, build_fleet
from .scheduler import AdmissionError, Request, Scheduler
from .spill import HostSpillStore
from .tenancy import DegradationLadder, Tenant, TenantTable
from .transfer import KvTransferPlane

__all__ = ["AdmissionError", "CachePool", "DecodeEngine", "DecodeWorker",
           "DegradationLadder", "DisaggRouter", "FileLaneStore",
           "HostSpillStore", "KvTransferPlane", "PrefillWorker",
           "PrefixCache", "PrefixEntry", "Replica", "Request",
           "RequestHandle", "Scheduler", "ServingEngine", "ServingRouter",
           "SlotAllocator", "Tenant", "TenantTable", "build_disagg_fleet",
           "build_fleet", "derive_retry_after_ms"]

#: JAX's serving names not ported yet: name -> ROADMAP.md queue A item
#: (A11 step 3).
NOT_PORTED = dict.fromkeys(
    ("AutoscalePolicy", "FleetAutoscaler", "FleetCacheIndex", "IndexRecord",
     "WorkerRuntime", "FleetRouter", "WorkerClient", "build_proc_fleet",
     "build_local_fleet", "submit_with_retry", "rolling_upgrade",
     "ModelRegistry", "ModelVariant", "SCENARIO_SCHEMA", "build_scenario",
     "run_scenario", "stream_digest", "materialize_prompt"), "A11")


def __getattr__(name):
    if name in NOT_PORTED:
        raise AttributeError(
            f"chainermn_tpu_torch.serving.{name} is not ported yet: see "
            f"ROADMAP.md, queue A, {NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
