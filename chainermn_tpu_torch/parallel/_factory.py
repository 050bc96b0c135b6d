"""Partition specs and the global face shared by the parallel modules.

Counterpart of ``chainermn_tpu/parallel/_factory.py``.  Every strategy
has two faces: the per-rank functions (JAX: inside ``shard_map``) and a
face over GLOBAL tensors.  Here each rank is a process, so the global face
slices each global argument by its spec onto this rank, runs the per-rank
function with the mesh bound, and gathers the result by the output spec.

A :class:`PartitionSpec` (``P``) names, for each dimension of a tensor,
the mesh axis it is sharded over, or None where it is whole; ``P()``
replicates.  Both directions are differentiable under the replicated
convention of the tensor-parallel layers: slicing's backward gathers the
cotangent blocks of the sharded dimensions, and gathering's backward
keeps this rank's block (every rank holds the same cotangent of a
replicated result).  With ``sum_grads=True`` the global face serves a
per-rank function whose backward follows the local-loss convention of
``functions/`` (the gradient of the sum of every rank's local loss; the
sequence-parallel, MoE and pipeline strategies): a replicated argument's
gradient is then summed over the ranks it is replicated on, and a
replicated result's cotangent is split evenly over them.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from ..convert import tree_map
from ..ops import collective as col
from ..topology import DEFAULT_AXIS_NAME, Mesh, bound_axis, make_nd_mesh

NEG_INF = -1e30


class PartitionSpec:
    """``P(None, 'model')``: dimension ``i`` is sharded over the mesh axis
    named by entry ``i`` (None: whole); missing trailing entries are
    whole.  A leaf of a spec tree, as JAX's is (not a tuple)."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes}"


P = PartitionSpec


def resolve_mesh_axis(mesh, axis_name: Optional[str]):
    """Default mesh: every rank on one axis named ``axis_name`` (default
    ``DEFAULT_AXIS_NAME``); default axis: the mesh's first."""
    if mesh is None:
        import torch.distributed as dist

        mesh = make_nd_mesh((axis_name or DEFAULT_AXIS_NAME,),
                            (dist.get_world_size(),))
    return mesh, axis_name or mesh.axis_names[0]


def model_axis(axis_name):
    """The 1-D mesh a tensor-parallel function reduces over, or None when
    there is nothing to reduce: ``axis_name`` None (no model axis, the
    one-card path) or an axis of size 1.  A name must be an axis of the
    N-D mesh bound by ``with mesh:`` (JAX raises on an unbound name too);
    a :class:`~chainermn_tpu_torch.topology.Mesh` is taken as is."""
    if axis_name is None:
        return None
    if isinstance(axis_name, Mesh):
        axis = axis_name
    else:
        axis = bound_axis(axis_name)
        if axis is None:
            raise NameError(f"unbound axis name {axis_name!r}: call inside "
                            f"`with mesh:` of a mesh that has it")
    return axis if axis.size > 1 else None


def _sharded_dims(spec, mesh):
    return [(d, mesh.axis(ax)) for d, ax in enumerate(spec) if ax is not None]


def local_block(x, spec, mesh):
    """This rank's block of the global ``x`` under ``spec`` (a view)."""
    for d, axis in _sharded_dims(spec, mesh):
        if x.shape[d] % axis.size:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"by axis {axis.axis_name!r} of {axis.size}")
        n = x.shape[d] // axis.size
        x = x.narrow(d, col.axis_index(axis) * n, n)
    return x


def gather_block(x, spec, mesh):
    """The global tensor from every rank's block ``x`` under ``spec``."""
    for d, axis in _sharded_dims(spec, mesh):
        if axis.size > 1:
            x = col.all_gather(x, axis, axis=d, tiled=True)
    return x


def _replicas(spec, mesh, sum_grads):
    """The axes of ``mesh`` (size > 1) that ``spec`` replicates over, when
    ``sum_grads``; none otherwise."""
    if not sum_grads:
        return []
    named = set(spec)
    return [mesh.axis(n) for n in mesh.axis_names
            if n not in named and mesh.shape[n] > 1]


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, sum_grads):
        ctx.spec, ctx.mesh, ctx.sum_grads = spec, mesh, sum_grads
        return local_block(x, spec, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for axis in _replicas(ctx.spec, ctx.mesh, ctx.sum_grads):
            g = col.psum(g, axis)
        return gather_block(g, ctx.spec, ctx.mesh), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, sum_grads):
        ctx.spec, ctx.mesh, ctx.sum_grads = spec, mesh, sum_grads
        return gather_block(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        g = local_block(g, ctx.spec, ctx.mesh).contiguous()
        for axis in _replicas(ctx.spec, ctx.mesh, ctx.sum_grads):
            g = g / axis.size
        return g, None, None, None


def _spec_tree(spec, tree):
    """A lone spec as a prefix: the same spec for every leaf of ``tree``."""
    return tree_map(tree, lambda _: spec)


def _zip_map(fn, tree, specs):
    if isinstance(specs, PartitionSpec) and isinstance(tree, (dict, list,
                                                             tuple)):
        specs = _spec_tree(specs, tree)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard(tree, specs, mesh, sum_grads: bool = False):
    """Differentiable: this rank's blocks of the global tensors ``tree``."""
    return _zip_map(lambda x, s: _Shard.apply(x, s, mesh, sum_grads), tree,
                    specs)


def gather(tree, specs, mesh, sum_grads: bool = False):
    """Differentiable: the global tensors from this rank's blocks."""
    return _zip_map(lambda x, s: _Gather.apply(x, s, mesh, sum_grads), tree,
                    specs)


def make_global_apply(kernel: Callable, mesh, in_specs, out_specs,
                      sum_grads: bool = False):
    """``apply(*args)`` over global tensors: each arg sliced onto this rank
    by its in-spec (a pytree prefix), ``kernel`` run with ``mesh`` bound,
    the result gathered by ``out_specs``.  Every rank of the mesh calls it
    with the same global arguments.  ``sum_grads``: ``kernel``'s backward
    follows the local-loss convention (see the module docstring)."""
    def apply(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} args, got {len(args)}")
        with mesh:
            local = [shard(a, s, mesh, sum_grads)
                     for a, s in zip(args, in_specs)]
            return gather(kernel(*local), out_specs, mesh, sum_grads)

    return apply


def make_sp_attention(kernel: Callable, mesh, axis_name: Optional[str],
                      causal: bool):
    """Wrap a per-rank attention ``kernel(q, k, v, axis_name=...,
    causal=...)`` into ``fn(q, k, v)`` over GLOBAL ``(B, S, H, D)``
    tensors sequence-sharded over the mesh axis."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    spec = P(None, ax)              # shard the sequence axis
    return make_global_apply(partial(kernel, axis_name=ax, causal=causal),
                             mesh, (spec, spec, spec), spec)
