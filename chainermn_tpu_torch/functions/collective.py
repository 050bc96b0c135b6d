"""Differentiable collective communication.

Counterpart of ``chainermn_tpu/functions/collective.py`` (reference:
``chainermn/functions/collective_communication.py``).  JAX gets each
backward from autodiff of one SPMD program; here each rank is a process
that calls the function eagerly on its own block (``axis_name`` names the
world, or is a :class:`~chainermn_tpu_torch.topology.Mesh`), and each is a
``torch.autograd.Function`` whose backward is the transpose collective:

=============  ===========================================
forward        backward
=============  ===========================================
allgather      sum-reduce-scatter
all_to_all     all_to_all with the axes swapped
bcast(root)    the cotangents summed onto root, 0 elsewhere
gather(root)   root's cotangent slab r to rank r
scatter(root)  every rank's cotangent gathered to root
=============  ===========================================

The convention is JAX's under ``shard_map`` with a per-rank local loss:
each rank's ``backward()`` starts from its own local loss, and the
gradient is that of the sum of the local losses.  A loss that was itself
all-reduced (the same on every rank) must not be the tensor ``backward()``
starts from: the all-reduce's backward sums every rank's cotangent, so
each gradient would come out ``size`` times too large.

``_psum`` / ``_pmean`` are the differentiable all-reduce (its backward
all-reduces the cotangent) that ``MultiNodeBatchNormalization`` needs;
JAX's ``functions`` has none, so they are not exported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import collective as col
from ..topology import DEFAULT_AXIS_NAME


def _rank(mesh) -> int:
    return dist.get_rank(mesh.group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, mean):
        ctx.mesh, ctx.mean = mesh, mean
        return col.pmean(x, mesh) if mean else col.psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return (col.pmean(g, ctx.mesh) if ctx.mean
                else col.psum(g, ctx.mesh)), None, None


def _psum(x, axis_name=DEFAULT_AXIS_NAME):
    """Differentiable cross-rank sum; its backward sums the cotangents."""
    return _AllReduce.apply(x, col._mesh(axis_name), False)


def _pmean(x, axis_name=DEFAULT_AXIS_NAME):
    """Differentiable cross-rank mean; its backward means the cotangents."""
    return _AllReduce.apply(x, col._mesh(axis_name), True)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tiled):
        ctx.mesh, ctx.axis, ctx.tiled = mesh, axis, tiled
        return col.all_gather(x, mesh, axis=axis, tiled=tiled)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis % g.dim()
        if ctx.tiled:
            out = col.reduce_scatter(g, ctx.mesh, scatter_axis=axis)
        else:
            out = col.reduce_scatter(g.movedim(axis, 0), ctx.mesh)[0]
        return out, None, None, None


def allgather(x, axis_name=DEFAULT_AXIS_NAME, axis: int = 0,
              tiled: bool = False):
    """Every rank's block, stacked on a new axis ``axis`` (``tiled=False``,
    ChainerMN's tuple of per-rank arrays) or concatenated along it."""
    return _AllGather.apply(x, col._mesh(axis_name), axis, tiled)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_axis, concat_axis, tiled):
        ctx.args = (mesh, split_axis, concat_axis, tiled)
        return col.all_to_all(x, mesh, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        mesh, split_axis, concat_axis, tiled = ctx.args
        return (col.all_to_all(g.contiguous(), mesh, concat_axis, split_axis,
                               tiled), None, None, None, None)


def all_to_all(x, axis_name=DEFAULT_AXIS_NAME, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = False):
    """Block transpose across ranks: chunk ``j`` of ``x`` along
    ``split_axis`` goes to rank ``j`` (see ``ops.collective.all_to_all``)."""
    return _AllToAll.apply(x, col._mesh(axis_name), split_axis, concat_axis,
                           tiled)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, root):
        ctx.mesh, ctx.root = mesh, root
        return col.bcast(x, root, mesh)

    @staticmethod
    def backward(ctx, g):
        total = col.psum(g.contiguous(), ctx.mesh)
        if _rank(ctx.mesh) != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


def bcast(x, root: int = 0, axis_name=DEFAULT_AXIS_NAME):
    """Every rank gets ``root``'s block; the backward sums every rank's
    cotangent onto ``root`` (zeros elsewhere)."""
    return _Bcast.apply(x, col._mesh(axis_name), root)


def _gather_to(x, mesh, root):
    """The ``(size, *s)`` stack of every rank's ``x`` on ``root``, zeros
    elsewhere."""
    x = x.detach().contiguous()
    out = x.new_zeros((mesh.size, *x.shape))
    parts = list(out.unbind(0)) if _rank(mesh) == root else None
    dist.gather(x, parts, dst=col._peer(mesh, root), group=mesh.group)
    return out


def _scatter_from(x, mesh, root):
    """Slab ``r`` of ``root``'s ``(size, *s)`` block on rank ``r``."""
    x = x.detach().contiguous()
    out = torch.empty_like(x[0])
    parts = list(x.unbind(0)) if _rank(mesh) == root else None
    dist.scatter(out, parts, src=col._peer(mesh, root), group=mesh.group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, root):
        ctx.mesh, ctx.root = mesh, root
        return _gather_to(x, mesh, root)

    @staticmethod
    def backward(ctx, g):
        return _scatter_from(g, ctx.mesh, ctx.root), None, None


def gather(x, root: int = 0, axis_name=DEFAULT_AXIS_NAME):
    """``root`` gets the ``(size, *s)`` stack of every rank's block (zeros
    elsewhere); the backward sends root's cotangent slab ``r`` to rank
    ``r``."""
    return _Gather.apply(x, col._mesh(axis_name), root)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, root):
        ctx.mesh, ctx.root = mesh, root
        if x.shape[0] != mesh.size:
            raise ValueError(f"scatter needs a leading axis of {mesh.size}, "
                             f"got {tuple(x.shape)}")
        return _scatter_from(x, mesh, root)

    @staticmethod
    def backward(ctx, g):
        return _gather_to(g, ctx.mesh, ctx.root), None, None


def scatter(x, root: int = 0, axis_name=DEFAULT_AXIS_NAME):
    """Rank ``r`` gets slab ``r`` of ``root``'s ``(size, *s)`` block (every
    rank passes a block of that shape; only root's is read); the backward
    gathers every rank's cotangent to ``root``."""
    return _Scatter.apply(x, col._mesh(axis_name), root)


__all__ = ["all_to_all", "allgather", "bcast", "gather", "scatter"]
