"""The collective surface, *derived* from source — not hardcoded strings.

Counterpart of ``chainermn_tpu/analysis/registry.py``.  Rules need to know
"what is a collective" for four vocabularies:

* the in-step face: public functions of the port's ``ops/collective.py``
  (parsed from its AST, minus the explicitly non-communicating helpers);
* the eager face: ``CommunicatorBase`` collectives — read out of
  ``communicators/base.py``'s ``_ACCOUNTED_OPS`` literal plus the
  ``*_obj`` pickle-lane methods defined on the class;
* the raw ``jax.lax`` primitives JAX's wrappers lower to (kept, so the
  engine reads JAX sources as the JAX package's engine does);
* ``torch.distributed``'s gang-synchronising calls
  (:data:`TORCH_DIST_COLLECTIVES`), matched only when called through the
  module (``dist.all_reduce(...)``, ``torch.distributed.barrier()``), so
  that a method of the same name on another object (JAX sources have
  them) is not a collective.

Rank taint gains ``dist.get_rank()`` (and its group-rank siblings)
beside the port's ``axis_index`` / ``process_index`` and the ``rank``
attributes.

Parsing (not importing) keeps the AST engine jax-free and means a new
collective added to ``ops/collective.py`` is linted the day it lands —
the same closure property the observability accounting test enforces
(tests/test_observability_fleet.py's completeness guard).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import FrozenSet, Optional

#: ops/collective.py defs that are *not* gang-synchronizing: helpers,
#: per-rank queries, and the static cost-model faces.  Everything else
#: public in that module is treated as a collective.  (axis_index/
#: axis_size read topology, they don't sync; the *_cost functions are
#: pure arithmetic the shard-flow analyzer and bench share.)
_NON_COLLECTIVE_OPS = frozenset({
    "zeros_like_vma", "axis_index", "axis_size",
    "collective_wire_cost", "quantized_ring_cost",
    "quantized_ring_static_groups", "choose_pipeline_depth",
    "block_quantize", "block_dequantize",
    # the port's: whether a card tensor is staged through host memory
    "host_staged",
})

#: jax.lax collective primitives (the fixed upstream vocabulary the named
#: wrappers lower onto).
JAX_LAX_COLLECTIVES = frozenset({
    "psum", "pmean", "pmax", "pmin", "psum_scatter", "all_gather",
    "all_to_all", "ppermute", "pshuffle", "pswapaxes",
})

#: Expressions whose value differs per rank/process — the taint sources
#: for the collective-deadlock rule.  Attribute tails (``comm.rank``) and
#: call names (``jax.process_index()``) both match by final identifier.
RANK_ATTRS = frozenset({"rank", "intra_rank", "inter_rank"})
RANK_CALLS = frozenset({"axis_index", "process_index"})

#: ``torch.distributed`` calls every rank of a group must make together
#: (collectives, point-to-point and barriers), matched when called through
#: the module (:data:`TORCH_DIST_MODULES`).
TORCH_DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "batch_isend_irecv", "broadcast",
    "broadcast_object_list", "gather", "gather_object", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_single",
    "scatter", "scatter_object_list", "send", "recv", "isend", "irecv",
    "new_group", "new_subgroups",
})

#: The spellings of the ``torch.distributed`` module at a call site.
TORCH_DIST_MODULES = frozenset({"dist", "torch.distributed"})

#: ``torch.distributed`` calls whose value differs per rank.
TORCH_DIST_RANK_CALLS = frozenset({
    "get_rank", "get_group_rank", "get_node_local_rank"})


def _dotted(expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _dotted(expr.value)
        return f"{base}.{expr.attr}" if base is not None else None
    return None


def _is_dist_call(fn, names: FrozenSet[str]) -> bool:
    """``dist.<name>(...)`` / ``torch.distributed.<name>(...)``."""
    return (isinstance(fn, ast.Attribute) and fn.attr in names
            and _dotted(fn.value) in TORCH_DIST_MODULES)


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parse(path: str) -> Optional[ast.Module]:
    try:
        with open(path) as fh:
            return ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _public_defs(tree: ast.Module) -> FrozenSet[str]:
    return frozenset(
        n.name for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and not n.name.startswith("_"))


def _accounted_ops(tree: ast.Module) -> FrozenSet[str]:
    """Evaluate the ``_ACCOUNTED_OPS = (...)`` literal in base.py."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_ACCOUNTED_OPS"):
            try:
                val = ast.literal_eval(node.value)
            except ValueError:
                continue
            return frozenset(v for v in val if isinstance(v, str))
    return frozenset()


def _obj_lane_methods(tree: ast.Module) -> FrozenSet[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "CommunicatorBase":
            for item in node.body:
                if (isinstance(item, ast.FunctionDef)
                        and item.name.endswith("_obj")):
                    out.add(item.name)
    return frozenset(out)


@dataclass(frozen=True)
class CollectiveRegistry:
    """Names the whole collective surface for the rules."""

    ops_collectives: FrozenSet[str]       # ops/collective.py public defs
    comm_methods: FrozenSet[str]          # CommunicatorBase collectives
    lax_collectives: FrozenSet[str] = JAX_LAX_COLLECTIVES
    rank_attrs: FrozenSet[str] = RANK_ATTRS
    rank_calls: FrozenSet[str] = RANK_CALLS
    extra: FrozenSet[str] = field(default_factory=frozenset)
    dist_collectives: FrozenSet[str] = TORCH_DIST_COLLECTIVES
    dist_rank_calls: FrozenSet[str] = TORCH_DIST_RANK_CALLS

    @property
    def all_collective_names(self) -> FrozenSet[str]:
        """Every identifier that, used as the called name (``psum(...)``)
        or attribute tail (``comm.allreduce(...)``), marks a collective."""
        return (self.ops_collectives | self.comm_methods
                | self.lax_collectives | self.extra)

    def is_collective_call(self, node) -> bool:
        """True when an ``ast.Call``'s target names a collective."""
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id in self.all_collective_names
        if isinstance(fn, ast.Attribute):
            return (fn.attr in self.all_collective_names
                    or _is_dist_call(fn, self.dist_collectives))
        return False

    def is_rank_call(self, node) -> bool:
        """True when an ``ast.Call`` returns a per-rank value:
        ``axis_index(...)``, ``jax.process_index()``,
        ``dist.get_rank()``."""
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id in self.rank_calls
        if isinstance(fn, ast.Attribute):
            return (fn.attr in self.rank_calls
                    or _is_dist_call(fn, self.dist_rank_calls))
        return False


def default_registry(package_root: Optional[str] = None) -> CollectiveRegistry:
    """Build the registry from the shipped sources (default: the port's
    own ``ops/collective.py`` and ``communicators/base.py``).  Falls back
    to a minimal lax-and-torch.distributed registry when the sources are
    missing (running the engine against a foreign tree is still
    useful)."""
    root = package_root or _package_root()
    ops_names: FrozenSet[str] = frozenset()
    comm_names: FrozenSet[str] = frozenset()

    ops_tree = _parse(os.path.join(root, "ops", "collective.py"))
    if ops_tree is not None:
        ops_names = _public_defs(ops_tree) - _NON_COLLECTIVE_OPS

    base_tree = _parse(os.path.join(root, "communicators", "base.py"))
    if base_tree is not None:
        comm_names = _accounted_ops(base_tree) | _obj_lane_methods(base_tree)

    return CollectiveRegistry(ops_collectives=ops_names,
                              comm_methods=comm_names)
