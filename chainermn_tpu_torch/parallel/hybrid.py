"""Hybrid data x model parallelism: the training step over a ``('data', 'model')`` mesh.

Counterpart of ``chainermn_tpu/parallel/hybrid.py``.  JAX's step is one
SPMD program under ``shard_map``; here each rank is a process that holds
its shards of the parameters (:func:`shard_pytree`, the layout of
``transformer_lm_specs`` / ``tensor_parallel.tp_mlp_specs``) and its rows
of the batch:

* :func:`make_hybrid_shard_map_step` runs ``loss_fn(params, local_batch)``
  with the mesh bound, so the TP layers reduce over ``'model'``
  themselves; after ``backward`` it averages the gradients over
  ``data_axis`` only (JAX: autodiff of the loss's ``pmean`` over
  ``'data'``) and returns that ``pmean`` of the loss;
* :func:`make_hybrid_train_step` is the same step over the GLOBAL batch,
  whose leading axis it slices over ``'data'`` onto this rank.

JAX's step is functional (``params, opt_state, batch → params, opt_state,
loss``).  This one is not: the optimizer is a ``torch.optim`` optimizer
built over this rank's parameter leaves (:func:`param_leaves`), and each
step updates them IN PLACE.  The optax recipes map as ``optax.sgd(lr)`` →
``torch.optim.SGD(leaves, lr)`` and ``optax.adam(lr)`` →
``torch.optim.Adam(leaves, lr)`` (the same defaults: b1 0.9, b2 0.999,
eps 1e-8 added outside the square root); :func:`state_specs_like` says
which optimizer state follows which parameter shard.

ZeRO-1 and FSDP shard the data-parallel state over one data axis, each
leaf on the first dimension of JAX's shape that the axis divides
(:func:`zero1_specs`).  JAX's faces are functional (``init_zero1_state``
returns an optax state laid out by the specs, and the step maps
``params, opt_state, batch``); here the optimizer is the state:

* :func:`init_zero1_state` takes ``optimizer(leaves) -> torch.optim
  optimizer`` and returns it built over NEW tensors, this rank's blocks of
  the leaves (a leaf with no divisible dimension whole), so Adam's
  moments are ``1/P`` of each leaf; :func:`make_zero1_train_step`'s step
  takes the replicated params, means the local gradients by ONE bucketed
  reduce-scatter onto the blocks (an all-reduce for the whole leaves),
  steps the optimizer on the blocks and all-gathers them back into the
  params, in place: replicated at the step boundary, as JAX keeps them;
* :func:`init_fsdp_params` returns this rank's blocks as the params
  themselves, :func:`init_fsdp_state` builds the optimizer over them, and
  :func:`make_fsdp_train_step`'s step all-gathers every leaf for use
  through one differentiable gather whose backward is the bucketed
  reduce-scatter (``functions.allgather``'s transpose), divided by ``P``:
  each block's gradient is the mean over the global batch.  The params
  stay sharded at the step boundary.

Both take this rank's rows of the batch (JAX: the global batch sharded
over the axis) and return the loss's mean over the axis.  A layer-wise
norm (LARS, LAMB, AGC: :mod:`chainermn_tpu_torch.optim`) of a sharded
leaf sums its squares over the axis (:func:`~chainermn_tpu_torch.optim
.shard_norms`), so it covers the whole leaf as GSPMD's does.  An
``nn.Linear`` weight is JAX's ``(in, out)`` kernel held transposed:
``transposed`` names such leaves, whose spec then shards the same slice
of the same logical tensor as JAX's does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch

from ..convert import flatten
from ..ops import collective as col
from ..optimizers import compressed_mean, gradient_average
from ..topology import Mesh
from ._factory import P, _zip_map, local_block


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tensors of a nested params dict, in a fixed order."""
    return list(flatten(params).values())


def shard_pytree(tree, mesh, specs):
    """This rank's blocks of the GLOBAL tensors (or numpy arrays) of
    ``tree`` under ``specs`` (one spec for every leaf, or a matching tree),
    each a contiguous tensor of its own."""
    def one(x, spec):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return local_block(t, spec, mesh).contiguous().clone()

    return _zip_map(one, tree, specs)


def state_specs_like(optimizer, params, param_specs):
    """The spec of each state of ``optimizer`` (a ``torch.optim``
    optimizer over ``param_leaves(params)``), by leaf: ``{leaf name:
    {state name: spec}}``.  A state tensor of the parameter's shape (Adam's
    ``exp_avg`` / ``exp_avg_sq``, momentum) follows the parameter's spec;
    any other (the step count) is replicated.  Read after the first step,
    when the states exist."""
    specs = flatten(param_specs)
    out = {}
    for name, leaf in flatten(params).items():
        state = optimizer.state.get(leaf, {})
        out[name] = {k: (specs[name] if isinstance(v, torch.Tensor)
                         and v.shape == leaf.shape else P())
                     for k, v in state.items()}
    return out


def make_hybrid_shard_map_step(loss_fn: Callable, optimizer, params,
                               mesh=None, data_axis: str = "data",
                               param_specs=None, has_aux: bool = False):
    """``step(params, local_batch) -> loss``: ``loss_fn(params,
    local_batch)`` under autograd with ``mesh`` bound (None: no mesh, one
    rank), ``backward``, the gradients averaged over ``data_axis`` when the
    mesh has it with more than one rank, one ``optimizer.step()``, then the
    gradients are dropped (``zero_grad(set_to_none=True)``).  The returned
    loss is the mean over ``data_axis``, detached.  The leaves of
    ``params`` are marked as requiring gradients here and updated in place
    by the optimizer, which must have been built over them.

    ``param_specs`` (a tree like ``params``): a leaf sharded over
    ``data_axis`` (the experts of ``moe_mlp``) keeps its gradient local,
    divided by the axis size (JAX: the gradient of the loss's mean of a
    varying leaf); the others are averaged.  With ``has_aux``,
    ``loss_fn`` returns ``(loss, aux)`` (a dict of scalars) and the step
    ``(loss, aux)``, ``aux`` meaned over ``data_axis`` too."""
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if any(id(leaf) not in owned for leaf in leaves):
        raise ValueError("the optimizer must be built over param_leaves(params)")
    data = None
    if mesh is not None and data_axis in mesh.axis_names \
            and mesh.shape[data_axis] > 1:
        data = mesh.axis(data_axis)
    local = set()
    if param_specs is not None:
        local = {name for name, spec in flatten(param_specs).items()
                 if data_axis in tuple(spec)}

    def step(params, batch):
        with mesh or contextlib.nullcontext():
            out = loss_fn(params, batch)
            loss, aux = out if has_aux else (out, None)
            loss.backward()
            if data is not None:
                named = flatten(params)
                gradient_average([t for n, t in named.items()
                                  if n not in local], data)
                for n in local:
                    named[n].grad.div_(data.size)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return (_mean_over(loss, data), _mean_over(aux, data)) \
                if has_aux else _mean_over(loss, data)

    return step


def make_hybrid_train_step(loss_fn: Callable, optimizer, params, mesh=None,
                           data_axis: str = "data", param_specs=None,
                           has_aux: bool = False):
    """:func:`make_hybrid_shard_map_step` over the GLOBAL batch: ``step(
    params, batch)`` takes this rank's rows of each batch tensor (the
    leading axis sharded over ``data_axis``), then runs the step.
    ``params`` are this rank's shards, as the step updates them in
    place."""
    inner = make_hybrid_shard_map_step(loss_fn, optimizer, params, mesh,
                                       data_axis, param_specs, has_aux)
    if mesh is None or data_axis not in mesh.axis_names:
        return inner
    rows = P(data_axis)

    def step(params, batch):
        return inner(params, tuple(local_block(b, rows, mesh)
                                   for b in batch))

    return step


# ---------------------------------------------------------------------------
# ZeRO-1 and FSDP over one data axis
# ---------------------------------------------------------------------------

def _data_axis(mesh, axis_name: Optional[str]):
    """``(name, 1-D mesh)`` of the data axis: ``axis_name``, or the mesh's
    only axis (an N-D mesh needs the name)."""
    names = (mesh.axis_name,) if isinstance(mesh, Mesh) else mesh.axis_names
    if axis_name is not None:
        if axis_name not in names:
            raise ValueError(f"axis {axis_name!r} not in mesh axes {names}")
    elif len(names) == 1:
        axis_name = names[0]
    else:
        raise ValueError(f"mesh has axes {names}; pass axis_name= "
                         f"explicitly")
    return axis_name, mesh if isinstance(mesh, Mesh) else mesh.axis(axis_name)


def _named_map(fn, tree, prefix=""):
    """``fn(name, leaf)`` over nested dicts and lists, names as
    :func:`flatten`'s."""
    def name(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _named_map(fn, v, name(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_named_map(fn, v, name(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def zero1_specs(params, mesh, axis_name: Optional[str] = None,
                transposed=()):
    """ZeRO-1 specs: each leaf sharded over the data axis on the first
    dimension of its JAX shape that the axis size divides, else ``P()``.
    ``transposed`` names the 2-D leaves held as the transpose of JAX's
    (:func:`~chainermn_tpu_torch.optim.linear_weights`' ``nn.Linear``
    weights): their spec names the dimension that is JAX's."""
    axis_name, axis = _data_axis(mesh, axis_name)
    n, flipped = axis.size, set(transposed)

    def spec_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        flip = name in flipped and len(shape) == 2
        for d, s in enumerate(shape[::-1] if flip else shape):
            if s % n == 0 and s >= n:
                d = 1 - d if flip else d
                return P(*([None] * d + [axis_name]))
        return P()

    return _named_map(spec_for, params)


def _dims(specs) -> List[Optional[int]]:
    """The sharded dimension of each leaf of a spec tree (None: whole)."""
    out = []
    for spec in flatten(specs).values():
        axes = [d for d, ax in enumerate(spec) if ax is not None]
        out.append(axes[0] if axes else None)
    return out


def _block(x, d, axis):
    m = x.shape[d] // axis.size
    return x.narrow(d, col.axis_index(axis) * m, m)


def _rows(t, d, p):
    """``(P, n)``: row ``r`` is block ``r`` of ``t`` along ``d``, in fp32."""
    return t.float().movedim(d, 0).reshape(p, -1)


def _scatter_mean(grads, dims, axis):
    """Each gradient's mean over the axis: the block of this rank (ONE
    reduce-scatter of a bucket) where ``dims`` names a dimension, whole
    (one all-reduce) where it is None."""
    p = axis.size
    out = list(grads)
    cut = [i for i, d in enumerate(dims) if d is not None]
    if cut:
        rows = [_rows(grads[i], dims[i], p) for i in cut]
        mine = col.reduce_scatter(torch.cat(rows, 1), axis)[0] / p
        off = 0
        for i, r in zip(cut, rows):
            g, d, n = grads[i], dims[i], r.shape[1]
            shape = list(g.movedim(d, 0).shape)
            shape[0] //= p
            out[i] = mine[off:off + n].view(shape).movedim(0, d).to(g.dtype)
            off += n
    whole = [i for i, d in enumerate(dims) if d is None]
    for i, g in zip(whole, compressed_mean([grads[i] for i in whole],
                                           axis)):
        out[i] = g
    return out


def _gather(blocks, dims, axis):
    """The whole leaves from every rank's blocks (ONE all-gather of a
    bucket); a block whose dim is None is whole already."""
    p = axis.size
    out = list(blocks)
    cut = [i for i, d in enumerate(dims) if d is not None]
    if not cut:
        return out
    rows = [_rows(blocks[i], dims[i], 1) for i in cut]
    every = col.all_gather(torch.cat(rows, 1), axis, axis=0, tiled=True)
    off = 0
    for i, r in zip(cut, rows):
        b, d, n = blocks[i], dims[i], r.shape[1]
        shape = list(b.movedim(d, 0).shape)
        shape[0] *= p
        out[i] = every[:, off:off + n].reshape(shape).movedim(0, d).to(
            b.dtype)
        off += n
    return out


def _sharded_optimizer(optimizer, blocks, dims, axis):
    """``optimizer(blocks)`` with the sharded blocks' layer-wise norms
    summed over the axis."""
    from ..optim import shard_norms

    opt = optimizer(blocks)
    shard_norms(opt, {b: (axis, d) for b, d in zip(blocks, dims)
                      if d is not None})
    return opt


def _owned(optimizer, leaves, face, same=False):
    """The optimizer's tensors, each shaped as (or, ``same``, being) the
    leaf in its place."""
    have = [p for group in optimizer.param_groups for p in group["params"]]
    if len(have) != len(leaves) or any(
            (a is not b) if same else (a.shape != b.shape)
            for a, b in zip(have, leaves)):
        raise ValueError(f"the optimizer must come from {face} over these "
                         f"params")
    return have


def _mean_over(x, axis):
    """``x`` (a tensor or a dict / list of them) detached and meaned over
    ``axis`` (None or one rank: as is)."""
    x = col._tree_map(lambda t: t.detach(), x)
    return x if axis is None or axis.size == 1 else col.pmean(x, axis)


def init_zero1_state(optimizer, params, mesh, axis_name: Optional[str] = None,
                     transposed=()):
    """``optimizer(leaves)`` (e.g. ``partial(torch.optim.Adam, lr=1e-2)``)
    built over this rank's blocks of the leaves of ``params`` (the
    replicated params) by :func:`zero1_specs`: new tensors, so its state
    (Adam's moments, momentum) is ``1/P`` of each sharded leaf."""
    _, axis = _data_axis(mesh, axis_name)
    dims = _dims(zero1_specs(params, mesh, axis_name, transposed))
    blocks = [(_block(t.detach(), d, axis) if d is not None else t.detach())
              .clone() for t, d in zip(param_leaves(params), dims)]
    return _sharded_optimizer(optimizer, blocks, dims, axis)


def make_zero1_train_step(loss_fn: Callable, optimizer, params, mesh,
                          axis_name: Optional[str] = None,
                          has_aux: bool = False, transposed=()):
    """``step(params, local_batch) -> loss`` (``(loss, aux)``): ZeRO-1 over
    the data axis.  ``loss_fn(params, local_batch)`` is the mean over this
    rank's rows; ``params`` are replicated leaf tensors, ``optimizer`` is
    :func:`init_zero1_state`'s over them.  After ``backward`` the
    gradients are meaned onto this rank's blocks (a reduce-scatter), the
    optimizer steps the blocks (which start each step as this rank's
    blocks of ``params``), and the blocks are all-gathered back into
    ``params`` in place.  Returns the loss (and aux) meaned over the
    axis."""
    _, axis = _data_axis(mesh, axis_name)
    dims = _dims(zero1_specs(params, mesh, axis_name, transposed))
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    blocks = _owned(optimizer, [
        _block(t, d, axis) if d is not None else t
        for t, d in zip(leaves, dims)], "init_zero1_state")

    def step(params, batch):
        out = loss_fn(params, batch)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        grads = _scatter_mean([t.grad if t.grad is not None
                               else torch.zeros_like(t) for t in leaves],
                              dims, axis)
        with torch.no_grad():
            for b, t, d, g in zip(blocks, leaves, dims, grads):
                b.copy_(_block(t, d, axis) if d is not None else t)
                b.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for t, new in zip(leaves, _gather(blocks, dims, axis)):
                t.copy_(new)
                t.grad = None
        return (_mean_over(loss, axis), _mean_over(aux, axis)) if has_aux \
            else _mean_over(loss, axis)

    return step


def init_fsdp_params(params, mesh, axis_name: Optional[str] = None,
                     transposed=()):
    """This rank's blocks of ``params`` (global leaves: tensors or numpy)
    by :func:`zero1_specs`, as new contiguous tensors: the FSDP params,
    ``1/P`` of the model per rank.  Their specs are ``zero1_specs(params,
    ...)`` of the same global ``params``."""
    from ..convert import _to_tensor

    _, axis = _data_axis(mesh, axis_name)

    def one(x, spec):
        t = x.detach() if isinstance(x, torch.Tensor) else _to_tensor(x)
        d = _dims(spec)[0]
        return (_block(t, d, axis) if d is not None else t).contiguous() \
            .clone()

    return _zip_map(one, params,
                    zero1_specs(params, mesh, axis_name, transposed))


def init_fsdp_state(optimizer, params, mesh, param_specs,
                    axis_name: Optional[str] = None):
    """``optimizer(leaves)`` built over the FSDP params themselves
    (:func:`init_fsdp_params`' blocks, whose specs are ``param_specs``):
    its state shards as the params do."""
    _, axis = _data_axis(mesh, axis_name)
    return _sharded_optimizer(optimizer, param_leaves(params),
                              _dims(param_specs), axis)


class _FsdpGather(torch.autograd.Function):
    """Every leaf whole from this rank's blocks (one all-gather); the
    backward is the transpose, each block's cotangent summed over the
    ranks by one reduce-scatter (a whole leaf's by an all-reduce), then
    divided by ``P``: the gradient of the mean of the ranks' losses."""

    @staticmethod
    def forward(ctx, dims, axis, *blocks):
        ctx.dims, ctx.axis = dims, axis
        return tuple(t if d is not None else t.clone()
                     for t, d in zip(_gather(list(blocks), dims, axis), dims))

    @staticmethod
    def backward(ctx, *cots):
        cots = [torch.zeros_like(c) if c is None else c for c in cots]
        return (None, None, *_scatter_mean(cots, ctx.dims, ctx.axis))


def _rebuild(tree, leaves):
    """``tree``'s structure (nested dicts and lists, :func:`flatten`'s
    order) over ``leaves``."""
    names = list(flatten(tree))
    lookup = dict(zip(names, leaves))
    return _named_map(lambda name, _: lookup[name], tree)


def make_fsdp_train_step(loss_fn: Callable, optimizer, params, mesh,
                         param_specs, axis_name: Optional[str] = None,
                         has_aux: bool = False):
    """``step(params, local_batch) -> loss`` (``(loss, aux)``): FSDP over
    the data axis.  ``params`` are :func:`init_fsdp_params`' blocks (specs
    ``param_specs``), ``optimizer`` is :func:`init_fsdp_state`'s.  Each
    step gathers every leaf whole for ``loss_fn(whole_params,
    local_batch)`` (the mean over this rank's rows) through
    :class:`_FsdpGather`, whose backward leaves each block's gradient the
    mean over the global batch; the optimizer updates the blocks in place.
    Returns the loss (and aux) meaned over the axis."""
    _, axis = _data_axis(mesh, axis_name)
    dims = _dims(param_specs)
    blocks = param_leaves(params)
    if len(dims) != len(blocks):
        raise ValueError(f"{len(dims)} specs for {len(blocks)} leaves")
    for b in blocks:
        b.requires_grad_(True)
    _owned(optimizer, blocks, "init_fsdp_state", same=True)

    def step(params, batch):
        whole = _FsdpGather.apply(dims, axis, *blocks)
        out = loss_fn(_rebuild(params, whole), batch)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return (_mean_over(loss, axis), _mean_over(aux, axis)) if has_aux \
            else _mean_over(loss, axis)

    step.gather = lambda: _rebuild(params, [t.detach() for t in _gather(
        blocks, dims, axis)])
    return step
