"""Shard-flow analyzer: sharding, memory and collective-cost model of one
recorded call, reconciled against the runtime comm ledger.

Counterpart of ``chainermn_tpu/analysis/shardflow.py``, with JAX's public
names, rules, finding texts and fingerprints.  JAX reads a jaxpr; eager
torch has none, so each registered entry point (``entrypoints.py``) is RUN
once, on the card unless the caller passes the CPU, under the comm
ledger's step bracket and the dispatch-graph recorder
(``dispatch_graph.py``), and the three questions are asked of the
recorded graph:

* **Replication report** — is each argument leaf, and each sizeable
  intermediate, REPLICATED across the entry's declared data axis?  JAX
  reads each leaf's binding off its ``shard_map`` equation; the port has
  no ``shard_map``, so each build declares ``in_specs`` (per
  ``arg_labels`` root, the mesh axes each leaf's dimensions are split
  over, JAX's bindings copied) over the leaves ``shardflow_args`` names
  (default: the trace arguments).  Intermediates are reported by
  propagating varying-axis sets over the graph with JAX's rules:
  reducing collectives (``psum``, ``pmax``, ``pmin``, ``all_gather``,
  ``bcast``; the int8 ring, a mean) subtract their axes, ``psum_scatter``,
  ``ppermute`` and ``all_to_all`` add theirs, every other node unions its
  inputs.  A leaf's bytes are this rank's block (JAX reads the global
  value: the same at axis size 1, where every entry runs); a host scalar
  counts 4 bytes, as JAX's int32 scalar does.  ``axis_index`` returns a
  host int here, so a tensor built from the rank is invisible to the
  propagation (a standing difference: the AST engine covers
  rank-dependent control flow).  ``unexpected-replication`` and
  ``stale-replication-annotation`` fire as in JAX.

* **Static collective cost model** — one :class:`CollectiveCost` per
  accounted node (``observability.comm.collective``, outermost): its
  primitive ``LEDGER_TO_PRIMITIVE[op]``, its payload in the ledger's
  convention (``comm.payload_info`` of the node's recorded inputs, at the
  wire dtype when the call names one), and its ``wire_bytes`` and
  ``messages`` from ``ops.collective.collective_wire_cost`` at the
  group's size.  A composite (the int8 ring, ``LEDGER_TO_PRIMITIVE`` →
  None) is costed by its wire legs, one cost per ``send`` (a
  ``ppermute``) and per gather, as JAX's program holds the ring's
  equations.  ``trip_count`` is always 1: an eager loop unrolls, and each
  pass is its own node.

* **Peak live memory** — linear-scan liveness over the graph by storage:
  the graph's inputs are live from the start to their last use, a value
  from the node that creates it to its last use, the call's outputs to
  the end; a kernel-wrapper or collective node contributes its outputs
  only.  JAX's figure is the no-fusion upper bound of a compiled program.
  Eager torch frees a storage only when its last Python reference drops,
  so the port's figure is what a program that frees each value at its
  last use would hold: a lower bound of what the caching allocator holds
  over the call, before the allocator's rounding.

Static↔dynamic reconciliation
-----------------------------
One run gives two sides that share no count: the ledger's rows of the
run (``CommAccountant.step`` → ``last_step_report``, split into wrapped
and noted as JAX's ``_ledger_groups`` does) and the recorded graph.  Per
``primitive@axis`` group::

    static_group_bytes == wrapped_ledger_bytes + declared noted bytes

(JAX's ``vma`` branch: the port's noted rows are always executed
collectives, so they are nodes of the graph; there is no legacy-autodiff
``ad_transpose_bytes``).  ``composite`` declarations swap their ledger
row for ``quantized_ring_static_groups``, as in JAX.  And the check a
jaxpr gives JAX for free: **every raw c10d op must sit inside an
accounted node**, with the bytes the node's primitive puts on the wire —
``psum`` / ``pmean`` → ``allreduce_`` of the payload, ``all_gather`` →
the ``allgather_`` input, ``reduce_scatter`` → the reduce-scatter input,
``all_to_all`` → ``alltoall_base_``, ``bcast`` → ``broadcast_``,
``ppermute`` / ``shift`` → each ``send``.  A raw c10d op outside every
accounted node, or a leg whose bytes differ from its node's, is a
``comm-ledger-gap``.  The only tolerance is ``pad_tolerance`` (0 for the
shipped dtypes).

The port's baseline is ``chainermn_tpu_torch/.shardflow-baseline.json``;
the runner is ``python -m chainermn_tpu_torch.analysis.shardflow`` (exit
0/1/2) and the ``shardflow`` stage of ``--gate``.  Importing this module
imports neither torch nor jax.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

SHARDFLOW_SCHEMA = "chainermn_tpu.shardflow.v1"
SHARDFLOW_BASELINE_FILENAME = ".shardflow-baseline.json"

SHARDFLOW_RULES: Dict[str, Tuple[str, str]] = {
    "unexpected-replication": (
        "warning", "argument replicated across the data axis without a "
                   "declared expectation"),
    "stale-replication-annotation": (
        "warning", "declared expected replication no longer observed — "
                   "delete the annotation (the sharding landed)"),
    "comm-ledger-gap": (
        "error", "static collective bytes and the runtime comm ledger "
                 "disagree (cost-model rot, or a collective bypassing "
                 "the accounted face)"),
    "shardflow-error": (
        "error", "entry point failed to build/trace/execute under the "
                 "shard-flow analyzer"),
}

#: primitive aliases → canonical name (JAX's jaxpr spells both)
_PRIM_ALIAS = {"reduce_scatter": "psum_scatter"}

#: Collectives whose result is replication-INVARIANT over their axes…
_REDUCING_PRIMS = frozenset({"psum", "pmax", "pmin", "all_gather"})
#: …and collectives whose result stays (or becomes) rank-varying.
_VARYING_PRIMS = frozenset({"psum_scatter", "ppermute", "all_to_all",
                            "pshuffle", "pgather"})

#: How many intermediates the replication report keeps (largest first).
_TOP_INTERMEDIATES = 5

#: wire-leg kind → the primitive a composite's leg is costed as
_LEG_PRIMITIVE = {"allreduce": "psum", "allgather": "all_gather",
                  "reduce_scatter": "psum_scatter",
                  "alltoall": "all_to_all", "broadcast": "all_gather",
                  "send": "ppermute"}
#: primitive → the wire-leg kind that carries it (``bcast`` is booked as
#: an ``all_gather`` and rides ``broadcast_``: :data:`_OP_LEG`)
_PRIMITIVE_LEG = {"psum": "allreduce", "pmax": "allreduce",
                  "pmin": "allreduce", "all_gather": "allgather",
                  "psum_scatter": "reduce_scatter",
                  "all_to_all": "alltoall", "ppermute": "send"}
_OP_LEG = {"bcast": "broadcast"}
#: leg kinds that carry no payload of their own
_PASSIVE_LEGS = frozenset({"recv", "barrier"})


def _canon(prim_name: str) -> str:
    return _PRIM_ALIAS.get(prim_name, prim_name)


def _primitive(op: str) -> Optional[str]:
    """The primitive a ledger op's wire leg is (None: a composite)."""
    from ..ops.collective import LEDGER_TO_PRIMITIVE

    if op in LEDGER_TO_PRIMITIVE:
        return LEDGER_TO_PRIMITIVE[op]
    return _canon(op)


def _short(node) -> str:
    """A node's primitive name for the report: ``aten.mm.default`` → ``mm``;
    a collective's ledger op; a kernel wrapper's name."""
    if node.kind == "aten" and node.name.count(".") >= 1:
        return node.name.split(".")[1]
    return node.name


# --------------------------------------------------------------------------
# static collective cost model
# --------------------------------------------------------------------------

@dataclass
class CollectiveCost:
    """One accounted collective of the recorded call."""

    primitive: str                 # canonical primitive name
    axes: Tuple[str, ...]
    payload_bytes: int             # ledger convention (input payload)
    wire_bytes: int                # physical ring bytes per rank
    messages: int                  # per-rank wire messages
    dtype: str
    shape: Tuple[int, ...]
    trip_count: int = 1            # always 1: eager loops unroll

    @property
    def group(self) -> str:
        return f"{self.primitive}@{'+'.join(self.axes)}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "primitive": self.primitive, "axes": list(self.axes),
            "payload_bytes": self.payload_bytes,
            "wire_bytes": self.wire_bytes, "messages": self.messages,
            "dtype": self.dtype, "shape": list(self.shape),
            "trip_count": self.trip_count,
        }


def static_costs(graph) -> List[CollectiveCost]:
    """Every outermost accounted collective of ``graph``, costed at its
    group's size; a composite by its wire legs."""
    from ..ops.collective import collective_wire_cost

    out: List[CollectiveCost] = []
    for n in graph.nodes:
        if n.kind != "collective":
            continue
        prim = _primitive(n.name)
        if prim is None:
            for leg in n.all_legs():
                lp = _LEG_PRIMITIVE.get(leg.kind)
                if lp is None:
                    continue
                cost = collective_wire_cost(lp, leg.nbytes, n.axis_size)
                out.append(CollectiveCost(
                    primitive=lp, axes=n.axes, payload_bytes=leg.nbytes,
                    wire_bytes=cost["wire_bytes"],
                    messages=cost["messages"], dtype=leg.dtype,
                    shape=tuple(leg.shape)))
            continue
        cost = collective_wire_cost(prim, n.payload_bytes, n.axis_size)
        out.append(CollectiveCost(
            primitive=prim, axes=n.axes, payload_bytes=n.payload_bytes,
            wire_bytes=cost["wire_bytes"], messages=cost["messages"],
            dtype=n.payload_dtype, shape=tuple(n.payload_shape)))
    return out


def group_bytes(costs: Sequence[CollectiveCost],
                trip_adjusted: bool = False) -> Dict[str, int]:
    """``primitive@axis`` → summed payload bytes (ledger convention)."""
    out: Dict[str, int] = {}
    for c in costs:
        k = c.group
        out[k] = out.get(k, 0) + c.payload_bytes * (
            c.trip_count if trip_adjusted else 1)
    return out


def _leg_gaps(graph) -> List[Tuple[str, str]]:
    """``(message, snippet)`` of every raw c10d op outside the accounted
    face and every accounted node whose wire legs do not carry its
    payload."""
    out: List[Tuple[str, str]] = []

    def check(n):
        for c in n.children:
            check(c)
        prim = _primitive(n.name)
        if prim is None or n.children:
            # a composite is held to its declaration; a node made of
            # nested accounted calls, by its children's legs
            return
        want = _OP_LEG.get(n.name) or _PRIMITIVE_LEG.get(prim)
        legs = [g for g in n.legs if g.kind not in _PASSIVE_LEGS]
        if not legs:
            return        # nothing on the wire (a send to itself)
        group = f"{n.name}@{'+'.join(n.axes)}"
        if want == "send":
            bad = any(g.kind != "send" or g.nbytes != n.payload_bytes
                      for g in legs)
        else:
            bad = (any(g.kind != want for g in legs)
                   or sum(g.nbytes for g in legs) != n.payload_bytes)
        if bad:
            ops = ", ".join(f"{g.op} {g.nbytes} B" for g in legs)
            out.append((
                f"collective `{group}`: its wire legs ({ops}) do not carry "
                f"the {n.payload_bytes} payload bytes the ledger books for "
                f"it — a wire leg and the accounted payload disagree "
                "(ops.collective)", f"leg:{group}"))

    for n in graph.nodes:
        if n.kind == "c10d":
            leg = n.legs[0]
            prim = _LEG_PRIMITIVE.get(leg.kind, leg.kind)
            out.append((
                f"raw collective `{leg.op}` ({prim}, {leg.nbytes} bytes) "
                "runs outside the accounted face — the runtime ledger "
                "never sees it; route it through ops.collective or a "
                "communicator method", f"raw:{leg.op}"))
        elif n.kind == "collective":
            check(n)
    return out


# --------------------------------------------------------------------------
# peak live memory (liveness over the graph)
# --------------------------------------------------------------------------

def peak_live_bytes(graph) -> int:
    """Peak byte total of simultaneously live storages in ``graph``.

    Linear-scan liveness, as JAX's: an input is live from the start to
    its last use, a value from the node that creates it to its last use,
    the call's outputs to the end.  A bracket node (a kernel wrapper or an
    accounted collective) contributes its outputs only.  What a program
    that frees each value at its last use would hold (module docstring)."""
    return _live_scan(graph, inputs=True)


def peak_defined_bytes(graph, device_type: Optional[str] = None) -> int:
    """Peak byte total of simultaneously live storages the call CREATES
    (on ``device_type`` only, when given), by the same scan: the most
    memory the call must allocate at once above what it found resident,
    whoever holds the inputs.  A lower bound of the caching allocator's
    peak over the call less what it held before."""
    return _live_scan(graph, inputs=False, device_type=device_type)


def _live_scan(graph, inputs: bool, device_type: Optional[str] = None
               ) -> int:
    def counted(v) -> bool:
        return device_type is None or \
            graph.values[v].device.split(":")[0] == device_type

    nodes = graph.nodes
    last: Dict[int, int] = {}
    for i, n in enumerate(nodes):
        for v in n.inputs + n.outputs:
            last[v] = i
    for v in graph.outputs:
        last[v] = len(nodes)
    alive: Set[int] = set()
    live = 0
    for v in graph.inputs if inputs else ():
        if v in last and v not in alive and counted(v):
            alive.add(v)
            live += graph.nbytes(v)
    peak = live
    for i, n in enumerate(nodes):
        for v in n.defs:
            if v in last and v not in alive and counted(v):
                alive.add(v)
                live += graph.nbytes(v)
        peak = max(peak, live)
        for v in n.inputs + n.outputs:
            if v in alive and last.get(v, -1) <= i:
                alive.discard(v)
                live -= graph.nbytes(v)
    return peak


# --------------------------------------------------------------------------
# replication analysis (varying-axes propagation)
# --------------------------------------------------------------------------

def _keystr(key) -> str:
    """One pytree path entry in ``jax.tree_util.keystr``'s spelling."""
    kind, k = key
    if kind == "attr":
        return f".{k}"
    return f"[{k!r}]"


def _is_spec(x) -> bool:
    return hasattr(x, "axes") and not isinstance(x, (dict, list, tuple))


def _flatten_with_path(x, path=()):
    """``[(path, leaf)]`` over dicts (``['k']``), named tuples
    (``.field``), lists and tuples (``[i]``), as JAX flattens a pytree;
    ``None`` is an empty subtree."""
    if x is None:
        return []
    if isinstance(x, dict):
        out = []
        for k in sorted(x):
            out.extend(_flatten_with_path(x[k], path + (("key", k),)))
        return out
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        out = []
        for f in x._fields:
            out.extend(_flatten_with_path(getattr(x, f),
                                          path + (("attr", f),)))
        return out
    if isinstance(x, (list, tuple)):
        out = []
        for i, v in enumerate(x):
            out.extend(_flatten_with_path(v, path + (("idx", i),)))
        return out
    return [(path, x)]


def _spec_axes(spec) -> Set[str]:
    axes: Set[str] = set()
    for d in getattr(spec, "axes", ()):
        if d is None:
            continue
        axes.update(d if isinstance(d, (tuple, list)) else (d,))
    return axes


def _leaf_specs(value, spec) -> List[Set[str]]:
    """The split axes of each leaf of ``value`` under ``spec`` (a spec
    leaf applies to the whole subtree, as JAX's prefix specs do; no spec
    is whole on every rank)."""
    if spec is None or _is_spec(spec):
        axes = _spec_axes(spec) if spec is not None else set()
        return [set(axes) for _ in _flatten_with_path(value)]
    if isinstance(value, dict):
        out = []
        for k in sorted(value):
            out.extend(_leaf_specs(value[k], spec.get(k)))
        return out
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        out = []
        for f in value._fields:
            out.extend(_leaf_specs(getattr(value, f), getattr(spec, f)))
        return out
    if isinstance(value, (list, tuple)):
        out = []
        for v, s in zip(value, spec):
            out.extend(_leaf_specs(v, s))
        return out
    return [set()]


def _leaf_labels(args: Sequence[Any],
                 arg_labels: Optional[Sequence[str]]) -> List[str]:
    """One label per flattened arg leaf: ``<arg_label><pytree path>``."""
    labels = []
    for idx, a in enumerate(args):
        if arg_labels and idx < len(arg_labels):
            root = arg_labels[idx]
        else:
            root = f"arg{idx}"
        for path, _leaf in _flatten_with_path(a):
            labels.append(root + "".join(_keystr(k) for k in path))
    return labels


def _leaf_nbytes(leaf) -> int:
    """A leaf's bytes in the ledger's convention: a tensor's or an
    array's, 4 for a host scalar (JAX's int32 scalar), 0 for anything
    else (a dtype, a string)."""
    if isinstance(leaf, (bool, int, float)):
        return 4
    if getattr(leaf, "shape", None) is None \
            or getattr(leaf, "dtype", None) is None:
        return 0
    from ..observability.comm import payload_info

    return payload_info(leaf)[0]


def replication_report(graph, args: Sequence[Any], data_axis: str,
                       arg_labels: Optional[Sequence[str]] = None,
                       in_specs: Optional[Sequence[Any]] = None
                       ) -> Dict[str, Any]:
    """Which argument leaves / intermediates of a recorded call are
    replicated across ``data_axis``?

    ``in_specs[i]`` binds argument ``i`` as JAX's ``shard_map`` in_specs
    do (a spec tree or a prefix of one); a leaf whose spec never splits a
    dimension over ``data_axis`` is fully materialized on every replica
    of that axis.  Intermediates come from varying-axes propagation over
    ``graph``.  Returns JAX's document::

        {"args": {root_label: {"replicated_bytes", "total_bytes",
                               "fully_replicated", "leaves": [...]}},
         "intermediates": [top-N largest replicated],
         "replicated_arg_bytes": total}
    """
    labels = _leaf_labels(args, arg_labels)
    leaves: List[Any] = []
    axes_of: List[Set[str]] = []
    for idx, a in enumerate(args):
        spec = in_specs[idx] if in_specs is not None \
            and idx < len(in_specs) else None
        leaves.extend(leaf for _, leaf in _flatten_with_path(a))
        axes_of.extend(_leaf_specs(a, spec))

    vary: Dict[int, Set[str]] = {}
    groups: Dict[str, Dict[str, Any]] = {}
    for label, leaf, axes in zip(labels, leaves, axes_of):
        vid = graph.value_of(leaf) if hasattr(leaf, "untyped_storage") \
            else None
        if vid is not None:
            vary.setdefault(vid, set()).update(axes)
        nbytes = _leaf_nbytes(leaf)
        if nbytes <= 0:
            continue
        root = label.split("[", 1)[0].split("/", 1)[0]
        g = groups.setdefault(root, {
            "replicated_bytes": 0, "total_bytes": 0,
            "fully_replicated": True, "leaves": []})
        g["total_bytes"] += nbytes
        if data_axis not in axes:
            g["replicated_bytes"] += nbytes
            g["leaves"].append({"label": label, "nbytes": nbytes})
        else:
            g["fully_replicated"] = False
    for g in groups.values():
        g["fully_replicated"] = (g["fully_replicated"]
                                 and g["total_bytes"] > 0)

    intermediates: List[Dict[str, Any]] = []
    for n, vset in _propagate_vary(graph, vary):
        if data_axis in vset:
            continue
        nbytes = sum(graph.nbytes(v) for v in n.defs)
        if nbytes <= 0:
            continue
        intermediates.append({"primitive": _short(n),
                              "shape": list(n.shape), "dtype": n.dtype,
                              "nbytes": nbytes})
    intermediates.sort(key=lambda d: -d["nbytes"])
    return {
        "data_axis": data_axis,
        "args": groups,
        "intermediates": intermediates[:_TOP_INTERMEDIATES],
        "replicated_arg_bytes": sum(
            g["replicated_bytes"] for g in groups.values()),
    }


def _propagate_vary(graph, vary: Dict[int, Set[str]]
                    ) -> List[Tuple[Any, Set[str]]]:
    """``(node, varying axes of its outputs)`` in run order, ``vary``
    seeding the inputs (a value not in it is replicated).  Reducing
    collectives (and the int8 ring, a mean) subtract their axes,
    redistributing ones add them, every other node unions its inputs; a
    node's written values take its set."""
    out: List[Tuple[Any, Set[str]]] = []
    for n in graph.nodes:
        base: Set[str] = set()
        for v in n.inputs:
            base |= vary.get(v, set())
        res = base
        if n.kind == "collective":
            prim = _primitive(n.name)
            if prim is None or prim in _REDUCING_PRIMS:
                res = base - set(n.axes)
            elif prim in _VARYING_PRIMS:
                res = base | set(n.axes)
        for v in n.outputs:
            vary[v] = set(res)
        out.append((n, set(res)))
    return out


# --------------------------------------------------------------------------
# the per-entry-point analysis + reconciliation
# --------------------------------------------------------------------------

@dataclass
class ShardflowReport:
    """Everything the analyzer learned about one entry point: JAX's
    fields, then the port's (the device the call ran on, the bytes of the
    storages on that device it found resident, the peak of the storages
    it creates there (:func:`peak_defined_bytes`), its kernel-wrapper
    nodes,
    the kernel launches it made, and its graph's node count with the
    autograd backward ops among them: ``*_backward*`` aten ops, which
    run on the autograd engine's thread on the card)."""

    name: str
    data_axis: Optional[str] = None
    costs: List[CollectiveCost] = field(default_factory=list)
    static_groups: Dict[str, int] = field(default_factory=dict)
    ledger_wrapped: Dict[str, int] = field(default_factory=dict)
    ledger_noted: Dict[str, int] = field(default_factory=dict)
    expected_static: Dict[str, int] = field(default_factory=dict)
    replication: Dict[str, Any] = field(default_factory=dict)
    peak_live_bytes: Optional[int] = None
    reconciled: Optional[bool] = None
    error: Optional[str] = None
    device: Optional[str] = None
    input_bytes: Optional[int] = None
    peak_defined_bytes: Optional[int] = None
    kernels: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    n_nodes: Optional[int] = None
    n_backward: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "data_axis": self.data_axis,
            "costs": [c.to_dict() for c in self.costs],
            "static_groups": dict(self.static_groups),
            "ledger_wrapped": dict(self.ledger_wrapped),
            "ledger_noted": dict(self.ledger_noted),
            "expected_static": dict(self.expected_static),
            "replication": self.replication,
            "peak_live_bytes": self.peak_live_bytes,
            "reconciled": self.reconciled,
            "error": self.error,
            "device": self.device,
            "input_bytes": self.input_bytes,
            "peak_defined_bytes": self.peak_defined_bytes,
            "kernels": dict(self.kernels),
            "launches": dict(self.launches),
            "n_nodes": self.n_nodes,
            "n_backward": self.n_backward,
        }


def _ledger_groups(rows: Dict[str, Dict[str, Any]]
                   ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Split ledger rows into (wrapped per primitive-group, noted per raw
    row key), mapping wrapper op names onto canonical primitives via
    ``ops.collective.LEDGER_TO_PRIMITIVE``.  Rows aggregate per
    ``op@axis`` and may mix wrapped calls with noted bookings — the
    accountant keeps the noted share in ``noted_bytes``, so the split is
    exact even on a shared key."""
    from ..ops.collective import LEDGER_TO_PRIMITIVE

    wrapped: Dict[str, int] = {}
    noted: Dict[str, int] = {}
    for key, row in rows.items():
        op, _, axis = key.partition("@")
        noted_part = int(row.get("noted_bytes", 0))
        wrapped_part = int(row["bytes"]) - noted_part
        if noted_part:
            noted[key] = noted.get(key, 0) + noted_part
        if wrapped_part:
            prim = LEDGER_TO_PRIMITIVE.get(op, _canon(op))
            if prim is None:
                # composite op (quantized ring): reconciled through the
                # declaring entry point's ``composite`` dict; an
                # UNDECLARED composite row surfaces as a group mismatch
                prim = op
            group = f"{prim}@{axis}"
            wrapped[group] = wrapped.get(group, 0) + wrapped_part
    return wrapped, noted


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run_under_ledger(fn, args, name: str, pre=(), device="cuda"):
    """``(graph, per-op ledger rows, kernel launches)`` of ONE call of
    ``fn(*args)``, recorded under the comm ledger's step bracket (tracing
    on for the call; prior process-global observability state restored
    afterwards).  ``pre``: tensors registered as values before the call
    (the argument leaves the replication report maps)."""
    from .. import observability as obs
    from .. import ops
    from ..observability.comm import get_accountant
    from .dispatch_graph import record

    was_enabled = obs.enabled()
    obs.enable()
    acct = get_accountant()
    before = ops.launch_counts()
    try:
        with acct.step(("shardflow", name)):
            graph, _, _ = record(fn, args, pre)
            _sync(device)
        report = acct.last_step_report or {}
        rows = dict(report.get("per_op", {}))
    finally:
        if not was_enabled:
            obs.disable()
    after = ops.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] - before.get(k, 0)}
    return graph, rows, launches


def analyze_entrypoint(ep, reconcile: bool = True, pad_tolerance: int = 0,
                       device="cuda", size: str = "tiny"
                       ) -> Tuple[List[Finding], ShardflowReport]:
    """Full shard-flow analysis of one registered entry point, built on
    ``device`` at ``size`` (``"tiny"`` / ``"full"``)."""
    report = ShardflowReport(name=ep.name, device=str(device))
    findings: List[Finding] = []
    loc = f"entrypoint:{ep.name}"

    def fail(stage: str, e: BaseException):
        report.error = f"{stage} failed: {type(e).__name__}: {e}"
        findings.append(Finding(
            rule="shardflow-error", severity="error", path=loc, line=0,
            message=report.error, context=ep.name, snippet=ep.description))

    try:
        spec = ep.build(device=device, size=size)
    except Exception as e:  # noqa: BLE001
        fail("build", e)
        return findings, report
    try:
        _analyze_spec(ep, spec, report, findings, loc, fail, reconcile,
                      pad_tolerance, device)
    finally:
        teardown = spec.get("teardown")
        if teardown is not None:
            teardown()
    return findings, report


def _analyze_spec(ep, spec, report, findings, loc, fail, reconcile,
                  pad_tolerance, device) -> None:
    fn, args = spec["trace"]
    data_axis = spec.get("data_axis")
    report.data_axis = data_axis
    expected_repl: Dict[str, str] = dict(spec.get("expected_replication", {}))
    sf_args = spec.get("shardflow_args", args)
    pre = [leaf for a in sf_args for _, leaf in _flatten_with_path(a)
           if hasattr(leaf, "untyped_storage")]

    # ---- one run: the ledger's rows and the recorded graph ----
    try:
        graph, rows, launches = _run_under_ledger(fn, args, ep.name, pre,
                                                  device)
    except Exception as e:  # noqa: BLE001
        fail("ledger run", e)
        return
    report.launches = launches
    report.kernels = graph.kernel_counts()
    report.input_bytes = graph.input_bytes(str(device).split(":")[0])
    report.n_nodes = len(graph.nodes)
    report.n_backward = sum(1 for n in graph.nodes
                            if n.kind == "aten" and "backward" in n.name)

    # ---- static side ----
    report.costs = static_costs(graph)
    report.static_groups = group_bytes(report.costs)
    report.peak_live_bytes = peak_live_bytes(graph)
    report.peak_defined_bytes = peak_defined_bytes(
        graph, str(device).split(":")[0])

    # ---- replication report + findings ----
    if data_axis:
        try:
            report.replication = replication_report(
                graph, sf_args, data_axis, spec.get("arg_labels"),
                spec.get("in_specs"))
        except Exception as e:  # noqa: BLE001
            fail("replication analysis", e)
            return
        groups = report.replication.get("args", {})
        for root, g in sorted(groups.items()):
            if g["replicated_bytes"] <= 0:
                continue
            if root in expected_repl:
                g["expected"] = expected_repl[root]
                continue
            full = "fully" if g["fully_replicated"] else "partially"
            findings.append(Finding(
                rule="unexpected-replication", severity="warning",
                path=loc, line=0, context=root,
                message=(
                    f"argument `{root}` is {full} replicated across data "
                    f"axis '{data_axis}' ({g['replicated_bytes']} of "
                    f"{g['total_bytes']} bytes on EVERY replica) — shard "
                    "it, or declare expected_replication with the reason "
                    "(entrypoints.py)"),
                snippet=f"replicated:{root}"))
        for root, reason in sorted(expected_repl.items()):
            g = groups.get(root)
            if g is None or g["replicated_bytes"] <= 0:
                findings.append(Finding(
                    rule="stale-replication-annotation", severity="warning",
                    path=loc, line=0, context=root,
                    message=(
                        f"expected_replication[{root!r}] ({reason!r}) no "
                        "longer matches a replicated argument — the "
                        "sharding landed; delete the annotation so the "
                        "report shows the red→green diff"),
                    snippet=f"expected:{root}"))

    if not reconcile:
        return

    # ---- static↔dynamic reconciliation ----
    wrapped, noted = _ledger_groups(rows)
    report.ledger_wrapped = wrapped
    report.ledger_noted = noted
    declared_noted: Dict[str, int] = dict(spec.get("noted", {}))
    expected: Dict[str, int] = dict(wrapped)

    # COMPOSITE rows (LEDGER_TO_PRIMITIVE → None, the int8 ring): the
    # entry declares, per ledger row, the bytes the accountant must have
    # booked for it and the per-primitive-group payload bytes its wire
    # legs carry (``ops.collective.quantized_ring_static_groups``); the
    # row is swapped for its groups before the comparison
    composite_ok = True
    for key, decl in sorted(dict(spec.get("composite", {})).items()):
        booked = expected.pop(key, 0)
        want_row = int(decl.get("ledger_bytes", 0))
        if booked != want_row:
            composite_ok = False
            findings.append(Finding(
                rule="comm-ledger-gap", severity="error", path=loc,
                line=0, context=ep.name,
                message=(
                    f"composite ledger row `{key}` books {booked} "
                    f"bytes but the entry point declares {want_row} "
                    "— the compressed-wire convention and the "
                    "declaration drifted apart"),
                snippet=f"composite:{key}"))
        for g, b in dict(decl.get("static_groups", {})).items():
            expected[g] = expected.get(g, 0) + int(b)
    # the noted collectives are executed calls: nodes of the graph
    from ..ops.collective import LEDGER_TO_PRIMITIVE
    for key, b in declared_noted.items():
        op, _, axis = key.partition("@")
        prim = LEDGER_TO_PRIMITIVE.get(op, _canon(op)) or op
        g = f"{prim}@{axis}"
        expected[g] = expected.get(g, 0) + int(b)
    report.expected_static = expected

    ok = composite_ok
    for g in sorted(set(expected) | set(report.static_groups)):
        want = expected.get(g, 0)
        got = report.static_groups.get(g, 0)
        if abs(want - got) > pad_tolerance:
            ok = False
            findings.append(Finding(
                rule="comm-ledger-gap", severity="error", path=loc,
                line=0, context=ep.name,
                message=(
                    f"collective group `{g}`: traced program carries "
                    f"{got} payload bytes but the runtime ledger "
                    f"accounts for {want} (wrapped "
                    f"{wrapped.get(g, 0)}) — the static cost model "
                    "rotted, or a collective on this path bypasses the "
                    "accounted face (ops.collective)"),
                snippet=f"group:{g}"))
    for key, brow in sorted(noted.items()):
        want = declared_noted.get(key)
        if want is None:
            ok = False
            findings.append(Finding(
                rule="comm-ledger-gap", severity="error", path=loc,
                line=0, context=ep.name,
                message=(
                    f"noted ledger row `{key}` ({brow} bytes) has no "
                    "declaration on this entry point — declare it in "
                    "the build spec's `noted` dict (with the bytes) "
                    "so the reconciliation can hold it to account"),
                snippet=f"noted:{key}"))
        elif abs(int(want) - brow) > pad_tolerance:
            ok = False
            findings.append(Finding(
                rule="comm-ledger-gap", severity="error", path=loc,
                line=0, context=ep.name,
                message=(
                    f"noted ledger row `{key}` books {brow} bytes but "
                    f"the entry point declares {want} — the note in "
                    "the builder and the declaration drifted apart"),
                snippet=f"noted:{key}"))
    for key, want in sorted(declared_noted.items()):
        if key not in noted:
            ok = False
            findings.append(Finding(
                rule="comm-ledger-gap", severity="error", path=loc,
                line=0, context=ep.name,
                message=(
                    f"declared noted collective `{key}` ({want} "
                    "bytes) was never booked by the run — the "
                    "builder's comm.note disappeared; update the "
                    "declaration"),
                snippet=f"noted:{key}"))
    # ---- the wire legs: every raw c10d op inside an accounted node ----
    for message, snippet in _leg_gaps(graph):
        ok = False
        findings.append(Finding(
            rule="comm-ledger-gap", severity="error", path=loc, line=0,
            context=ep.name, message=message, snippet=snippet))
    report.reconciled = ok


def analyze_entrypoints(eps: Optional[Sequence[Any]] = None,
                        reconcile: bool = True, device="cuda",
                        size: str = "tiny"
                        ) -> Tuple[List[Finding], List[ShardflowReport]]:
    """Shard-flow analysis over registered entry points (default: all).

    Entry points registered with ``shardflow=False`` are skipped — the
    observability-tee variants re-run the very same programs their base
    entries already analyze."""
    if eps is None:
        from .entrypoints import ENTRYPOINTS
        eps = ENTRYPOINTS
    findings: List[Finding] = []
    reports: List[ShardflowReport] = []
    for ep in eps:
        if not getattr(ep, "shardflow", True):
            continue
        f, r = analyze_entrypoint(ep, reconcile=reconcile, device=device,
                                  size=size)
        findings.extend(f)
        reports.append(r)
    return findings, reports


# --------------------------------------------------------------------------
# runner (python -m chainermn_tpu_torch.analysis.shardflow)
# --------------------------------------------------------------------------

def _own_baseline() -> str:
    """The port's baseline: ``chainermn_tpu_torch/.shardflow-baseline.json``."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), SHARDFLOW_BASELINE_FILENAME)


def find_shardflow_baseline(start: Optional[str] = None) -> Optional[str]:
    """Nearest ``.shardflow-baseline.json`` at or above ``start`` — the
    one upward walk of ``findings.find_baseline``, parameterized by
    filename.  With no ``start``, the port's own baseline if it exists
    (never the JAX package's, one level up)."""
    from .findings import find_baseline

    if start is None:
        own = _own_baseline()
        return own if os.path.exists(own) else None
    return find_baseline(start, filename=SHARDFLOW_BASELINE_FILENAME)


def _select_entrypoints(names: Optional[Sequence[str]]):
    from .entrypoints import select_entrypoints

    return select_entrypoints(names, for_shardflow=True)


def _render_report(r: ShardflowReport) -> str:
    lines = [f"== {r.name} (data axis: {r.data_axis or '-'}) =="]
    if r.error:
        lines.append(f"  ERROR: {r.error}")
    if r.reconciled is not None:
        lines.append("  static<->ledger: "
                     + ("RECONCILED" if r.reconciled else "MISMATCH"))
    for g in sorted(set(r.static_groups) | set(r.expected_static)):
        lines.append(
            f"    {g:28s} static {r.static_groups.get(g, 0):>10d} B   "
            f"ledger-expected {r.expected_static.get(g, 0):>10d} B")
    for k, b in sorted(r.ledger_noted.items()):
        lines.append(f"    {k:28s} noted  {b:>10d} B (declared)")
    phys = sum(c.wire_bytes * c.trip_count for c in r.costs)
    msgs = sum(c.messages * c.trip_count for c in r.costs)
    lines.append(f"  physical wire estimate: {phys} B, {msgs} messages "
                 f"(ring decomposition at the run's group sizes)")
    if r.peak_live_bytes is not None:
        lines.append(f"  peak live memory / replica: {r.peak_live_bytes} B "
                     f"(freed at last use; {r.input_bytes} B resident "
                     f"inputs; {r.peak_defined_bytes} B at most created "
                     "at once)")
    if r.n_nodes is not None:
        lines.append(f"  graph: {r.n_nodes} nodes ({r.n_backward} "
                     "autograd backward ops)")
    if r.kernels:
        lines.append("  kernel wrappers: " + ", ".join(
            f"{k} x{n}" for k, n in sorted(r.kernels.items())))
    repl = r.replication or {}
    for root, g in sorted(repl.get("args", {}).items()):
        mark = ("expected: " + g["expected"] if "expected" in g
                else ("REPLICATED" if g["replicated_bytes"] else "sharded"))
        lines.append(
            f"    arg {root:12s} {g['replicated_bytes']:>8d}/"
            f"{g['total_bytes']:<8d} B replicated  [{mark}]")
    for it in repl.get("intermediates", []):
        lines.append(
            f"    intermediate {it['primitive']:16s} "
            f"{tuple(it['shape'])!s:14s} {it['dtype']:9s} "
            f"{it['nbytes']} B replicated")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """Shard-flow report runner.  Exit contract (the lint's): 0 = clean
    modulo baseline, 1 = findings, 2 = unusable inputs (bad arguments, a
    broken baseline, or the card asked for and absent)."""
    import argparse
    import json
    import sys

    from .baseline import BaselineGate

    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis.shardflow",
        description="Shard-flow analyzer: sharding/memory/collective-cost "
                    "model of each registered entry point's recorded "
                    "call, reconciled against the runtime comm ledger")
    p.add_argument("--entry", action="append", default=None,
                   help="restrict to one registered entry point (repeat "
                        "for several; default: all)")
    p.add_argument("--list-entrypoints", action="store_true",
                   help="print the registered entry points and exit")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable JSON document on stdout")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: nearest "
                        f"{SHARDFLOW_BASELINE_FILENAME} above the package)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report everything")
    p.add_argument("--fix-baseline", action="store_true",
                   help="regenerate the baseline from current findings "
                        "(keeps existing comments; entries for entry "
                        "points not selected via --entry are carried "
                        "over untouched)")
    p.add_argument("--device", default="cuda",
                   help="where the entry points run (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--size", default="tiny", choices=("tiny", "full"),
                   help="entry widths: JAX's tiny fixture, or the "
                        "decode-bench LM for the kernel-bearing entries")
    args = p.parse_args(argv)

    if args.list_entrypoints:
        from .entrypoints import ENTRYPOINTS
        for ep in ENTRYPOINTS:
            tag = "" if getattr(ep, "shardflow", True) \
                else "  [shardflow: skipped]"
            print(f"{ep.name:36s} {ep.description}{tag}")
        return 0

    eps, err = _select_entrypoints(args.entry)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if str(args.device).startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("error: --device cuda but no CUDA device is available "
                  "(pass --device cpu to run the entry points on the "
                  "host)", file=sys.stderr)
            return 2

    findings, reports = analyze_entrypoints(eps, device=args.device,
                                            size=args.size)

    gate = BaselineGate(args.baseline or find_shardflow_baseline(),
                        enabled=not args.no_baseline)
    err = gate.load()
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2

    if args.fix_baseline:
        analyzed = {f"entrypoint:{r.name}" for r in reports}
        gate.fix(findings,
                 in_scope=lambda e: e["path"] in analyzed,
                 default_target=_own_baseline(), out=sys.stderr)
        return 0

    findings, accepted = gate.filter(findings)

    if args.json:
        print(json.dumps({
            "schema": SHARDFLOW_SCHEMA,
            "baseline": gate.path if gate.baseline is not None else None,
            "n_accepted_by_baseline": len(accepted),
            "findings": [f.to_dict() for f in findings],
            "reports": [r.to_dict() for r in reports],
        }, indent=2))
    else:
        for r in reports:
            print(_render_report(r))
        for f in findings:
            print(f.render())
        sev: Dict[str, int] = {}
        for f in findings:
            sev[f.severity] = sev.get(f.severity, 0) + 1
        tally = ", ".join(f"{n} {s}" for s, n in sorted(sev.items())) \
            or "no findings"
        extra = (f" ({len(accepted)} accepted by baseline)"
                 if accepted else "")
        print(f"shardflow: {tally}{extra} over {len(reports)} "
              f"entry point(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover - python -m face
    import sys

    sys.exit(main())
