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

:func:`lower_schedule` lowers a spec pair to a VERIFIED collective
schedule (``analysis/schedule_check``, a copy of JAX's), and
``reshard_host(schedule=...)`` routes sharded leaves through that
schedule's interpreter, bit-identical to the direct path.  A bf16 torch
leaf moves as its ``int16`` bytes (numpy has no bf16) under the dtype
name JAX gives it (``"bfloat16"``), so the schedule and its fingerprint
are JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from .. import _tree

ShardSpec = Union[None, int]

#: JAX names of this module that wait for another queue item: none.
NOT_PORTED: dict = {}

__all__ = [
    "ShardSpec", "reshard", "make_reshard", "reshard_host", "reshard_cost",
    "reshard_tree_cost", "partition_spec_of", "validate_spec",
    "lower_schedule",
]


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


def lower_schedule(shape, dtype, src_spec, dst_spec, src_world: int,
                   dst_world: int, kind: str = "auto", topology=None,
                   n_chunks: int = 2, depth: int = 2):
    """Lower one (src, dst) spec pair to a VERIFIED collective schedule.

    ``kind`` names a generator (``single`` — the monolithic lowering
    :func:`reshard` performs — ``chunked``, ``pipelined``,
    ``hierarchical``) or ``"auto"`` to pick the cheapest verified
    candidate under the r04 cost model.  Every returned schedule has
    passed the full :mod:`~chainermn_tpu_torch.analysis.schedule_check`
    verifier (coverage vs the array_split statics, exhaustive BFS of the
    start/done machine, interpreter byte-exactness); an unverifiable
    schedule raises instead of escaping.  ``dtype`` is a name
    (``"float32"``, ``"bfloat16"``), a numpy dtype or a torch dtype.
    """
    from ..analysis.schedule_check import verified_schedule
    from ..observability.comm import _dtype_name

    return verified_schedule(kind, shape, _dtype_name(dtype), src_spec,
                             dst_spec, src_world, dst_world, topology,
                             n_chunks=n_chunks, depth=depth)


def _emit_schedule_exec(prof) -> None:
    """Fan one profiled execution's records out to the observability
    plane: every op becomes an HLC-stamped journal line
    (``kind="schedule_exec"``, fingerprint-keyed), a tracer complete
    event on the live trace, and a ``schedule_exec/*`` counter bump in
    the comm ledger."""
    from ..observability import comm as _comm
    from ..observability import journal as _journal
    from ..observability import trace as _trace

    recs = prof.run_records()
    if not recs:
        return
    if _journal.enabled():
        for rec in recs:
            _journal.emit("schedule_exec",
                          **{k: v for k, v in rec.items()
                             if k != "schema"})
    _comm.record_schedule_exec(recs)
    if _trace.enabled():
        # the run just finished: back-date each op from "now" so the
        # lane lines up with the surrounding spans.
        base = _trace.now_us() - prof.wall_us()
        for rec in recs:
            _trace.complete_event(
                f"sched/{rec['op']}({rec['arg']})",
                int(base + rec["t_us"]), max(1, int(rec["wall_us"])),
                cat="schedule_exec", link=rec["link"],
                rank=rec["rank"], bytes=rec["bytes"],
                fingerprint=rec["fingerprint"])


def _host_bytes(v):
    """``(numpy array, dtype name, back)``: a leaf's host array (a bf16
    leaf as its int16 bytes), JAX's name for its dtype, and the function
    that turns a block of the array back into a leaf of ``v``'s kind."""
    from ..observability.comm import _dtype_name

    if _is_torch(v):
        import torch

        t = v.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy(), "bfloat16",
                    lambda a: torch.from_numpy(a).view(torch.bfloat16))
        return t.numpy(), _dtype_name(t.dtype), torch.from_numpy
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":     # a numpy bf16 (ml_dtypes) array
        dt = a.dtype
        return a.view(np.int16), "bfloat16", lambda b: b.view(dt)
    return a, str(a.dtype), lambda b: b


def _scheduled_leaf(vals, src_axis: int, dst_spec, dst_count: int,
                    kind: str, topology):
    """Route one sharded leaf through a verified schedule's interpreter.

    Returns the per-destination blocks, or ``None`` when the leaf falls
    outside the schedule geometry (unequal source blocks, uneven
    destination split, mixed dtypes or kinds) — the caller then takes the
    direct concatenate/slice path, which is byte-identical by the
    verifier's own oracle.

    When the journal or tracer is live the execution runs under a
    :class:`~chainermn_tpu_torch.analysis.schedule_check.ScheduleExecProfile`
    and every op lands in the observability plane (see
    :func:`_emit_schedule_exec`); with both off, not a single record is
    built.
    """
    from ..analysis.schedule import block_shape
    from ..analysis.schedule_check import run_schedule

    if len({_is_torch(v) for v in vals}) != 1:
        return None
    host = [_host_bytes(v) for v in vals]
    arrs = [h[0] for h in host]
    first, name, back = arrs[0], host[0][1], host[0][2]
    if any(a.shape != first.shape or h[1] != name
           for a, h in zip(arrs[1:], host[1:])):
        return None
    if not 0 <= src_axis < first.ndim:
        return None
    shape = list(first.shape)
    shape[src_axis] = shape[src_axis] * len(arrs)
    shape = tuple(shape)
    if isinstance(dst_spec, int):
        if not 0 <= dst_spec < first.ndim:
            return None
        if shape[dst_spec] % dst_count:
            return None                  # direct path raises the error
    sched = lower_schedule(shape, name, src_axis, dst_spec, len(arrs),
                           dst_count, kind=kind, topology=topology)
    profiler = None
    from ..observability import journal as _journal
    from ..observability import trace as _trace
    if _journal.enabled() or _trace.enabled():
        from ..analysis.schedule_check import ScheduleExecProfile
        profiler = ScheduleExecProfile(sched)
    outs = run_schedule(sched, [np.ascontiguousarray(a).reshape(-1)
                                for a in arrs], profiler=profiler)
    if profiler is not None:
        _emit_schedule_exec(profiler)
    return [back(outs[r].reshape(block_shape(shape, dst_spec, r, dst_count)))
            for r in range(dst_count)]


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

    ``schedule`` routes sharded-source array leaves through a VERIFIED
    collective schedule instead of the direct concatenate/slice:
    ``"auto"`` picks the cheapest candidate under the r04 cost model, or
    name a generator (``"single"``, ``"chunked"``, ``"pipelined"``,
    ``"hierarchical"`` — the latter staging cross-slice bytes over a
    gateway when ``topology`` has a DCN tier).  Every schedule has passed
    :func:`~chainermn_tpu_torch.analysis.schedule_check.verify_schedule`,
    so the result is bit-identical to the direct path; leaves outside the
    schedule geometry (replicated/``per_rank`` sources, unequal blocks)
    keep the direct path.  A torch leaf comes back as a torch tensor of
    its dtype, bf16 included.
    """
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
            if schedule is not None:
                blocks = _scheduled_leaf(vals, src, dst, dst_count,
                                         schedule, topology)
                if blocks is not None:
                    for r in range(dst_count):
                        out_leaves[r].append(blocks[r])
                    continue
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
