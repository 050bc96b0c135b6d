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
which optimizer state follows which parameter shard.  ZeRO-1 and FSDP are
ROADMAP.md's A9.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

import torch

from ..convert import flatten
from ..ops import collective as col
from ..optimizers import gradient_average
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

    def mean(x):
        x = col._tree_map(lambda t: t.detach(), x)
        return x if data is None else col.pmean(x, data)

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
            return (mean(loss), mean(aux)) if has_aux else mean(loss)

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
