"""Portable array redistribution: ``reshard(tree, src_spec, dst_spec)``.

Counterpart of ``chainermn_tpu/parallel/reshard.py``.  A redistribution
between two partition specs of the 1-D data axis lowers to the minimal
collective for the (src, dst) pair instead of all_gather-then-slice
(which moves P x the necessary bytes and materialises the whole array on
every rank):

    ==================  =====================  =======================
    src → dst           collective             per-rank wire bytes
    ==================  =====================  =======================
    R → R               (none)                 0
    R → S(a)            local slice            0
    S(a) → S(a)         (none)                 0
    S(a) → R            all_gather             block × (P-1)
    S(a) → S(b), a≠b    all_to_all             block × (P-1)/P
    ==================  =====================  =======================

where ``R`` is replicated, ``S(a)`` is sharded along logical axis ``a``
across the ranks, and "block" is the per-rank shard.  Every wire leg goes
through the port's in-step collectives (``ops.collective``);
:func:`reshard_cost` predicts each leg's payload and ring wire bytes with
the same ``collective_wire_cost`` as the JAX package.

Two faces, one spec language:

* :func:`reshard` — each rank calls it on its own per-rank blocks (the
  port's processes stand where JAX's ``shard_map`` body runs);
  :func:`make_reshard` wraps it into a callable over a mesh.
* :func:`reshard_host` — the device-free twin for checkpoint shards:
  re-partitions a list of per-process host trees from one world size /
  layout to another (the elastic-restore path of
  ``extensions/checkpoint.py``).  Leaves are numpy arrays or torch CPU
  tensors (bf16 included): torch leaves are joined and sliced with torch,
  numpy leaves with numpy.

Spec language (``ShardSpec``): ``None`` = replicated; an ``int`` = that
logical axis is evenly partitioned across the ranks.  A spec is a single
value (applied to every leaf) or a tree matching ``tree``.

``lower_schedule`` and ``reshard_host(schedule=...)`` route through the
JAX package's verified collective schedules (``analysis/schedule_check``),
which are ROADMAP.md's A13: ``lower_schedule`` is listed in
:data:`NOT_PORTED` and ``schedule=`` raises naming A13.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from .. import _tree

ShardSpec = Union[None, int]

#: JAX names of this module that wait for another queue item.
NOT_PORTED = {"lower_schedule": "A13"}

__all__ = [
    "ShardSpec", "reshard", "make_reshard", "reshard_host", "reshard_cost",
    "reshard_tree_cost", "partition_spec_of", "validate_spec",
]


def __getattr__(name):
    if name in NOT_PORTED:
        raise AttributeError(
            f"chainermn_tpu_torch.parallel.reshard.{name} is not ported "
            f"yet: see ROADMAP.md, queue A, {NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def validate_spec(spec: ShardSpec, ndim: Optional[int] = None,
                  what: str = "spec") -> ShardSpec:
    """Normalize/validate one leaf spec: None, or an in-range axis int."""
    if spec is None:
        return None
    if isinstance(spec, bool) or not isinstance(spec, int):
        raise TypeError(
            f"{what} must be None (replicated) or an int logical axis, "
            f"got {spec!r}")
    if ndim is not None and not -ndim <= spec < ndim:
        raise ValueError(
            f"{what}={spec} out of range for a rank-{ndim} array")
    if ndim is not None and spec < 0:
        spec += ndim
    return spec


def _spec_tree(tree, spec):
    """Broadcast a single spec over a tree, or validate a spec tree."""
    leaves, treedef = _tree.flatten(tree)
    if spec is None or isinstance(spec, int):
        return [spec] * len(leaves), leaves, treedef
    try:
        spec_leaves = treedef.flatten_up_to(spec)
    except ValueError:
        n = len(_tree.leaves(spec, is_leaf=lambda x: x is None))
        raise ValueError(
            f"spec pytree has {n} leaves but the array tree has "
            f"{len(leaves)}") from None
    return spec_leaves, leaves, treedef


def partition_spec_of(spec: ShardSpec, ndim: int, axis_name: str) -> tuple:
    """The partition a leaf spec denotes, as the entries of JAX's
    ``PartitionSpec``: ``()`` replicated, else ``None`` for each axis
    before the sharded one and then ``axis_name``."""
    spec = validate_spec(spec, ndim)
    if spec is None:
        return ()
    return tuple([None] * spec + [axis_name])


def _reshard_leaf(x, src: ShardSpec, dst: ShardSpec, axis_name):
    """One leaf's redistribution, on this rank's block."""
    from ..ops import collective as _col

    ndim = x.dim()
    src = validate_spec(src, ndim, "src_spec")
    dst = validate_spec(dst, ndim, "dst_spec")
    if src == dst:
        return x
    p = _col.axis_size(axis_name)
    if src is None and dst is not None:
        # replicated → sharded: a local slice, zero wire bytes
        if x.shape[dst] % p:
            raise ValueError(
                f"cannot shard axis {dst} of shape {tuple(x.shape)} across "
                f"{p} ranks: {x.shape[dst]} % {p} != 0")
        block = x.shape[dst] // p
        idx = _col.axis_index(axis_name)
        return x.narrow(dst, idx * block, block).clone()
    if dst is None:
        # sharded → replicated: the blocks gathered back along the axis
        return _col.all_gather(x, axis_name, axis=src, tiled=True)
    # sharded(a) → sharded(b): ONE all_to_all — each rank keeps 1/P of
    # its block and receives 1/P from every peer
    if x.shape[dst] % p:
        raise ValueError(
            f"cannot reshard to axis {dst}: block shape {tuple(x.shape)} "
            f"has {x.shape[dst]} % {p} != 0")
    return _col.all_to_all(x, axis_name, split_axis=dst, concat_axis=src,
                           tiled=True)


def reshard(tree, src_spec, dst_spec, axis_name="mn"):
    """Redistribute ``tree`` (this rank's blocks, torch tensors) from
    ``src_spec`` to ``dst_spec`` over ``axis_name``'s group (a name of
    :func:`~chainermn_tpu_torch.topology.make_mesh`, or a ``Mesh``).
    Every rank calls it.  Specs are single values or trees matching
    ``tree``."""
    src_leaves, leaves, treedef = _spec_tree(tree, src_spec)
    dst_leaves, _, _ = _spec_tree(tree, dst_spec)
    return treedef.unflatten([
        _reshard_leaf(x, s, d, axis_name)
        for x, s, d in zip(leaves, src_leaves, dst_leaves)])


def make_reshard(mesh, src_spec, dst_spec, axis_name=None,
                 example=None) -> Callable:
    """``fn(tree) -> tree``: each rank passes its blocks laid out per
    ``src_spec`` and gets its blocks per ``dst_spec``, over ``mesh``'s
    group (``axis_name`` names another mesh of the world).  ``example``
    (optional) checks the spec trees' structure up front."""
    ax = axis_name or mesh

    def fn(tree):
        return reshard(tree, src_spec, dst_spec, ax)

    if example is not None:
        _spec_tree(example, src_spec)
        _spec_tree(example, dst_spec)
    return fn


def _itemsize(dtype) -> int:
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def reshard_cost(shape: Sequence[int], dtype, src: ShardSpec,
                 dst: ShardSpec, axis_size: int) -> dict:
    """Static prediction for one leaf's redistribution: which collective,
    its payload bytes (the per-rank input block of the call, the JAX comm
    ledger's convention), and the physical ring wire bytes via
    ``ops.collective.collective_wire_cost``."""
    from ..ops.collective import collective_wire_cost

    shape = tuple(shape)
    ndim = len(shape)
    src = validate_spec(src, ndim, "src")
    dst = validate_spec(dst, ndim, "dst")
    p = int(axis_size)
    item = _itemsize(dtype)
    total = int(np.prod(shape)) * item if shape else item
    block = total // p if p else total

    def out(primitive, ledger_bytes):
        wire = (collective_wire_cost(primitive, ledger_bytes, p)
                if primitive else {"wire_bytes": 0, "messages": 0})
        return {"primitive": primitive, "ledger_bytes": int(ledger_bytes),
                "wire_bytes": int(wire["wire_bytes"]),
                "messages": int(wire["messages"])}

    if src == dst or p <= 1:
        return out(None, 0)
    if src is None and dst is not None:
        return out(None, 0)          # local slice
    if dst is None:
        return out("all_gather", block)
    return out("all_to_all", block)


def reshard_tree_cost(tree, src_spec, dst_spec, axis_size: int) -> dict:
    """Sum of :func:`reshard_cost` over a tree: the whole transfer's
    predicted payload / wire bytes."""
    src_leaves, leaves, _ = _spec_tree(tree, src_spec)
    dst_leaves, _, _ = _spec_tree(tree, dst_spec)
    total = {"ledger_bytes": 0, "wire_bytes": 0, "messages": 0,
             "per_primitive": {}}
    for x, s, d in zip(leaves, src_leaves, dst_leaves):
        c = reshard_cost(x.shape, x.dtype, s, d, axis_size)
        total["ledger_bytes"] += c["ledger_bytes"]
        total["wire_bytes"] += c["wire_bytes"]
        total["messages"] += c["messages"]
        if c["primitive"]:
            row = total["per_primitive"].setdefault(
                c["primitive"], {"ledger_bytes": 0, "calls": 0})
            row["ledger_bytes"] += c["ledger_bytes"]
            row["calls"] += 1
    return total


# ---------------------------------------------------------------------------
# host-side twin: checkpoint shard re-partitioning (no device)
# ---------------------------------------------------------------------------

def _split_even(n: int, parts: int, what: str) -> int:
    if parts < 1:
        raise ValueError(f"{what}: need at least 1 partition, got {parts}")
    if n % parts:
        raise ValueError(
            f"{what}: axis length {n} does not divide evenly into "
            f"{parts} partitions")
    return n // parts


def _is_torch(x) -> bool:
    import torch

    return isinstance(x, torch.Tensor)


def _ndim(x) -> int:
    return x.dim() if _is_torch(x) else np.asarray(x).ndim


def _concat(vals, axis):
    """Join blocks along ``axis``: torch leaves with torch, the rest with
    numpy."""
    if all(_is_torch(v) for v in vals):
        import torch
        return torch.cat(list(vals), dim=axis)
    return np.concatenate([np.asarray(v) for v in vals], axis=axis)


def reshard_host(shards: Sequence[Any], src_layout, dst_layout,
                 dst_count: int, *, schedule: Optional[str] = None,
                 topology=None) -> List[Any]:
    """Re-partition per-process host trees between world sizes.

    ``shards`` is the COMPLETE old-world list (one tree per source
    process, rank order); ``src_layout``/``dst_layout`` follow the same
    spec language as :func:`reshard` (single spec or spec tree), with
    one host-side addition: the string ``"per_rank"`` marks state that
    is rank-SPECIFIC rather than a partition of a logical array — new
    rank ``r`` inherits old rank ``r % len(shards)``'s value (iterator
    cursors and RNG must be re-derived by the caller).  Returns
    ``dst_count`` trees.  A spec tree is read at the state's leaves, so
    ``None`` nodes of the state (torch optimizers keep some) need no spec.

    Exactness contract: for replicated leaves the output is shard 0's
    value bit-for-bit on every destination; for sharded leaves the
    concatenation of destination blocks equals the concatenation of
    source blocks.  Nothing touches a device.

    ``schedule`` (the JAX package's verified collective schedules) is
    ROADMAP.md's A13 and raises here.
    """
    if schedule is not None:
        raise NotImplementedError(
            "reshard_host(schedule=...) routes through the verified "
            "collective schedules (analysis/schedule_check), which are not "
            "ported yet: see ROADMAP.md, queue A, A13")
    del topology
    if not shards:
        raise ValueError("reshard_host: empty shard list")
    if dst_count < 1:
        raise ValueError(f"reshard_host: dst_count must be >= 1, got "
                         f"{dst_count}")
    src_count = len(shards)

    def norm(layout):
        leaves0, treedef = _tree.flatten(shards[0])
        if layout is None or isinstance(layout, (int, str)):
            return [layout] * len(leaves0), treedef
        # the layout is read at the state's leaves: a ``None`` node of the
        # state (an optimizer's ``foreach: None``) has no spec of its own
        return treedef.flatten_up_to(layout), treedef

    src_specs, treedef = norm(src_layout)
    dst_specs, _ = norm(dst_layout)
    shard_leaves = [_tree.flatten(s)[0] for s in shards]
    for i, ls in enumerate(shard_leaves):
        if len(ls) != len(shard_leaves[0]):
            raise ValueError(
                f"shard {i} has {len(ls)} leaves, shard 0 has "
                f"{len(shard_leaves[0])} — shards disagree on structure")

    out_leaves: List[List[Any]] = [[] for _ in range(dst_count)]
    for li in range(len(shard_leaves[0])):
        src = src_specs[li]
        dst = dst_specs[li]
        vals = [shard_leaves[p][li] for p in range(src_count)]
        if src == "per_rank" or dst == "per_rank":
            if src != dst:
                raise ValueError(
                    "per_rank state cannot be resharded to/from an array "
                    f"partition (leaf {li}: src={src!r}, dst={dst!r})")
            for r in range(dst_count):
                out_leaves[r].append(vals[r % src_count])
            continue
        if src is None:
            full = vals[0]
        else:
            src = validate_spec(src, _ndim(vals[0]), "src_layout")
            full = _concat(vals, src)
        if dst is None:
            for r in range(dst_count):
                out_leaves[r].append(full)
            continue
        if not _is_torch(full):
            full = np.asarray(full)
        dst = validate_spec(dst, _ndim(full), "dst_layout")
        block = _split_even(full.shape[dst], dst_count,
                            f"reshard_host leaf {li}")
        for r in range(dst_count):
            if _is_torch(full):
                out_leaves[r].append(
                    full.narrow(dst, r * block, block).clone())
            else:
                idx = [slice(None)] * full.ndim
                idx[dst] = slice(r * block, (r + 1) * block)
                out_leaves[r].append(full[tuple(idx)])
    return [treedef.unflatten(ls) for ls in out_leaves]
