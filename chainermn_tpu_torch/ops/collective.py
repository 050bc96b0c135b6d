"""In-step collectives over a process group.

Counterpart of ``chainermn_tpu/ops/collective.py``'s plain collectives
(``psum``, ``pmean``, ``pmax``, ``pmin``, ``pmean_if_bound``,
``all_gather``, ``all_to_all``, ``reduce_scatter``, ``ppermute``,
``shift``, ``axis_index``, ``axis_size``, ``bcast``) and a copy of
``collective_wire_cost``.  JAX calls them inside one SPMD program where
``axis_name`` is bound; here each rank is a process that calls them
eagerly on its own tensor.  ``axis_name`` names an axis of the N-D mesh
bound by ``with mesh:`` (:func:`~chainermn_tpu_torch.topology.make_nd_mesh`;
the collective runs over this rank's group along that axis), or else the
group of :func:`~chainermn_tpu_torch.topology.make_mesh` (the world), or is
a :class:`~chainermn_tpu_torch.topology.Mesh` whose group they run over.
Each returns this rank's block of JAX's result; none writes its input.

A gloo group has no card path for most collectives (its send / recv,
all-gather, reduce-scatter, all-to-all), so when the group's backend is
gloo a card tensor is staged through host memory: copied to the host, sent
and copied back.  The group's backend decides, before the call.

``psum`` / ``pmean`` / ``pmax`` / ``pmin`` / ``bcast`` also take a dict,
list or tuple of tensors, as JAX's take a pytree.  ``ppermute`` and
``shift`` post every send and receive of the permutation as one
``batch_isend_irecv`` (a ring of blocking sends deadlocks on NCCL); a
pair from a rank to itself is a copy.  They are not differentiable: the
``torch.autograd.Function`` forms are ROADMAP.md's A8 (``functions/``),
and the int8 ring and ``hierarchical_pmean`` are A9.

Each collective carries the collective guard of
:mod:`chainermn_tpu_torch.health` (:func:`~chainermn_tpu_torch.health.guarded`):
with a guard installed, a call that does not complete within the guard's
window aborts loudly naming the lost rank(s).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..health import guarded
from ..topology import DEFAULT_AXIS_NAME, Mesh, bound_axis, make_mesh

# torch 2.13 flags reduce_scatter_tensor as deprecated in favour of
# reduce_scatter_single; older torch has only the former
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def collective_wire_cost(primitive: str, payload_bytes: int,
                         axis_size: int) -> dict:
    """Physical wire cost of ONE collective on a ring schedule:
    ``{"wire_bytes": per-rank bytes on the wire, "messages": per-rank
    message count}``.  ``payload_bytes`` is the call's input payload; an
    all-reduce is reduce-scatter + all-gather, each moving ``(P-1)/P`` of
    the payload over ``P-1`` hops.  At axis size 1 everything is free."""
    p = int(axis_size)
    if p <= 1:
        return {"wire_bytes": 0, "messages": 0}
    b = int(payload_bytes)
    if primitive in ("psum", "pmax", "pmin"):            # all-reduce
        return {"wire_bytes": 2 * b * (p - 1) // p, "messages": 2 * (p - 1)}
    if primitive in ("psum_scatter", "reduce_scatter"):  # reduce-scatter
        return {"wire_bytes": b * (p - 1) // p, "messages": p - 1}
    if primitive == "all_gather":   # payload = the PER-RANK input block
        return {"wire_bytes": b * (p - 1), "messages": p - 1}
    if primitive == "all_to_all":
        return {"wire_bytes": b * (p - 1) // p, "messages": p - 1}
    if primitive in ("ppermute", "pshuffle"):
        return {"wire_bytes": b, "messages": 1}
    return {"wire_bytes": b, "messages": 1}  # unknown: conservative


def _mesh(axis_name) -> Mesh:
    if isinstance(axis_name, Mesh):
        return axis_name
    return bound_axis(axis_name) or make_mesh(axis_name)


def host_staged(mesh: Mesh, x) -> bool:
    """Whether ``x`` goes through host memory on ``mesh``'s group: a card
    tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _staged(mesh: Mesh, x):
    """``(x or its host copy, the device to return to)``."""
    return (x.cpu(), x.device) if host_staged(mesh, x) else (x, x.device)


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _all_reduce(x, op, mesh):
    out, dev = _staged(mesh, x.detach())
    out = out.clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out.to(dev)


@guarded("psum")
def psum(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _tree_map(lambda v: _all_reduce(v, dist.ReduceOp.SUM, mesh), x)


@guarded("pmean")
def pmean(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _tree_map(
        lambda v: _all_reduce(v, dist.ReduceOp.SUM, mesh) / mesh.size, x)


@guarded("pmax")
def pmax(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _tree_map(lambda v: _all_reduce(v, dist.ReduceOp.MAX, mesh), x)


@guarded("pmin")
def pmin(x, axis_name=DEFAULT_AXIS_NAME):
    mesh = _mesh(axis_name)
    return _tree_map(lambda v: _all_reduce(v, dist.ReduceOp.MIN, mesh), x)


def pmean_if_bound(x, axis_name: Optional[str] = DEFAULT_AXIS_NAME):
    """The cross-rank mean when there is a process group to mean over;
    identity otherwise (JAX: when ``axis_name`` is not bound)."""
    if axis_name is None or not dist.is_initialized():
        return x
    return pmean(x, axis_name)


@guarded("all_gather")
def all_gather(x, axis_name=DEFAULT_AXIS_NAME, axis: int = 0,
               tiled: bool = True):
    """Every rank's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new axis ``axis``."""
    mesh = _mesh(axis_name)
    x, dev = _staged(mesh, x.detach().contiguous())
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    parts = [p.to(dev) for p in parts]     # join on the caller's device
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


@guarded("all_to_all")
def all_to_all(x, axis_name=DEFAULT_AXIS_NAME, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True):
    """Chunk ``j`` of ``x`` along ``split_axis`` goes to rank ``j``; the
    chunks received are joined along ``concat_axis`` in rank order.
    Untiled, ``split_axis`` has the group's size, each chunk is one index
    of it (the axis removed) and the chunks stack on a new axis
    ``concat_axis``."""
    mesh = _mesh(axis_name)
    if tiled:
        chunks = x.detach().chunk(mesh.size, dim=split_axis)
    else:
        chunks = x.detach().unbind(split_axis)
    if len(chunks) != mesh.size or x.shape[split_axis] % mesh.size:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split into {mesh.size} equal chunks")
    send, dev = _staged(mesh, torch.stack(chunks).contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    parts = recv.to(dev).unbind(0)         # join on the caller's device
    return torch.cat(parts, dim=concat_axis) if tiled \
        else torch.stack(parts, dim=concat_axis)


@guarded("reduce_scatter")
def reduce_scatter(x, axis_name=DEFAULT_AXIS_NAME, scatter_axis: int = 0):
    """The cross-rank sum of ``x``, of which this rank keeps block
    ``rank`` along ``scatter_axis``."""
    mesh = _mesh(axis_name)
    if x.shape[scatter_axis] % mesh.size:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape)} does not "
                         f"divide by {mesh.size}")
    inp, dev = _staged(mesh, x.detach().movedim(scatter_axis, 0)
                       .contiguous())
    out = inp.new_empty((inp.shape[0] // mesh.size,) + inp.shape[1:])
    _reduce_scatter(out, inp, group=mesh.group)
    return out.movedim(0, scatter_axis).to(dev)


@guarded("ppermute")
def ppermute(x, perm, axis_name=DEFAULT_AXIS_NAME):
    """``perm`` is a list of ``(source, dest)`` rank pairs: rank ``dest``
    gets ``source``'s ``x``; a rank no pair sends to gets zeros."""
    mesh = _mesh(axis_name)
    me = dist.get_rank(mesh.group)
    x, dev = _staged(mesh, x.detach().contiguous())
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, _peer(mesh, dst),
                                  mesh.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _peer(mesh, src),
                                  mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(dev)


def _peer(mesh, r):
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def shift(x, offset: int, axis_name=DEFAULT_AXIS_NAME,
          size: Optional[int] = None):
    """Ring shift by ``offset``: rank ``i``'s ``x`` lands on rank
    ``(i + offset) % size``."""
    if size is None:
        size = _mesh(axis_name).size
    return ppermute(x, [(i, (i + offset) % size) for i in range(size)],
                    axis_name)


def axis_index(axis_name=DEFAULT_AXIS_NAME) -> int:
    return dist.get_rank(_mesh(axis_name).group)


def axis_size(axis_name=DEFAULT_AXIS_NAME) -> int:
    return _mesh(axis_name).size


@guarded("bcast")
def bcast(x, root: int = 0, axis_name=DEFAULT_AXIS_NAME):
    """Every rank gets rank ``root``'s block."""
    mesh = _mesh(axis_name)

    def one(v):
        out, dev = _staged(mesh, v.detach())
        out = out.clone()
        dist.broadcast(out, src=_peer(mesh, root), group=mesh.group)
        return out.to(dev)

    return _tree_map(one, x)


__all__ = ["all_gather", "all_to_all", "axis_index", "axis_size", "bcast",
           "collective_wire_cost", "host_staged", "pmax", "pmean",
           "pmean_if_bound", "pmin",
           "ppermute", "psum", "reduce_scatter", "shift"]
