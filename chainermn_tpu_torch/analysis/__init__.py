"""chainermn_tpu_torch.analysis — SPMD-aware static analyzer for the port.

Counterpart of ``chainermn_tpu/analysis/``.  The MPI heritage of this
codebase makes collective *ordering and symmetry* a correctness
invariant: a collective executed under rank-dependent control flow
deadlocks the gang, a reused PRNG key silently draws identical samples,
and a zero-copy view of a host buffer that is later mutated in place
races an asynchronous reader (the serving pos-vector bug).  This package
catches that family mechanically, over the port's own tree and against
its own baselines (``chainermn_tpu_torch/.spmd-lint-baseline.json`` and
``.concurrency-baseline.json``).

Two complementary engines, as in JAX:

* **AST engine** (``ast_engine``) — pure stdlib ``ast``; the same rules
  and fingerprints as JAX's (on JAX sources the same findings), taught
  the port's idiom: ``torch.distributed`` collectives and
  ``dist.get_rank()``, ``torch.from_numpy`` / ``as_tensor`` aliasing under
  a ``non_blocking`` copy, the port's ``prng`` and ``manual_seed``.
* **trace engine** (``trace_engine``, the counterpart of JAX's
  ``jaxpr_engine``) — eager torch has no jaxpr, so it RUNS the
  registered entry points (``entrypoints.py``; on the card unless the
  caller passes the CPU) and reads the collective sequence off the
  accounted collective face and the programs off the kernel-dispatch
  layer: ``unbound-axis``, ``recompile-hazard``, ``entrypoint-error``.

Beside them: the shard-flow analyzer (``shardflow``: the replication
report, the static collective cost and the peak-live memory of each
registered entry point's call, recorded as a dispatch graph by
``dispatch_graph`` and reconciled against the comm ledger, with the
port's own ``.shardflow-baseline.json``), the lock-discipline lint
(``concurrency``) and its runtime recorder (``lockassert``, under
``CHAINERMN_TPU_TORCH_LOCK_ASSERT``), the protocol model checker
(``protocol``), the collective schedule IR and its verifier
(``schedule``, ``schedule_check``) with the cost-model calibration
(``calibrate``), all copies but the first.

Runner: ``python -m chainermn_tpu_torch.analysis [paths]`` (exit 0 clean
/ 1 findings / 2 unusable; ``--gate`` runs every plane the port has).

Importing this package imports neither torch nor jax: only stdlib, numpy
and relative imports at top level (the trace engine and the entry points
import torch when they run).
"""

from .findings import (  # noqa: F401
    Baseline,
    Finding,
    SEVERITIES,
    load_baseline,
)
from .registry import CollectiveRegistry, default_registry  # noqa: F401
from .ast_engine import (  # noqa: F401
    AST_RULES,
    analyze_file,
    analyze_paths,
    analyze_source,
)
from .concurrency import CONCURRENCY_RULES  # noqa: F401  (stdlib-only)
from .protocol import ALL_MODELS as PROTOCOL_MODELS  # noqa: F401
from .schedule import (  # noqa: F401  (stdlib+numpy only)
    CALIBRATION_SCHEMA,
    GENERATORS as SCHEDULE_GENERATORS,
    Schedule,
    Topology,
)
from .schedule_check import (  # noqa: F401
    FLEET_PAIRS,
    SCHEDULE_EXEC_SCHEMA,
    SEEDED_FAULTS,
    ScheduleExecProfile,
    verify_schedule,
)
from .calibrate import (  # noqa: F401  (stdlib+numpy only)
    drift_report,
    fit_calibration,
    load_calibration,
    schedule_critical_path,
)
from .trace_engine import TRACE_RULES  # noqa: F401  (stdlib at import)
from .shardflow import (  # noqa: F401  (stdlib-only at import time)
    SHARDFLOW_RULES,
    ShardflowReport,
)

#: JAX names of this package the port has not: none.
NOT_PORTED: dict = {}

__all__ = [
    "AST_RULES",
    "Baseline",
    "CALIBRATION_SCHEMA",
    "CONCURRENCY_RULES",
    "CollectiveRegistry",
    "FLEET_PAIRS",
    "Finding",
    "PROTOCOL_MODELS",
    "SCHEDULE_EXEC_SCHEMA",
    "SCHEDULE_GENERATORS",
    "SEEDED_FAULTS",
    "SEVERITIES",
    "SHARDFLOW_RULES",
    "Schedule",
    "ScheduleExecProfile",
    "ShardflowReport",
    "TRACE_RULES",
    "Topology",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "default_registry",
    "drift_report",
    "fit_calibration",
    "load_baseline",
    "load_calibration",
    "schedule_critical_path",
    "verify_schedule",
]


def __getattr__(name):
    if name in NOT_PORTED:
        raise AttributeError(
            f"chainermn_tpu_torch.analysis.{name} is not ported yet: see "
            f"ROADMAP.md, queue A, {NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
