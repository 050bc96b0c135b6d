"""Pipeline parallelism: the GPipe schedule and the 1F1B schedule.

Counterpart of ``chainermn_tpu/parallel/pipeline.py``.  Stages live on the
ranks of one mesh axis; stage ``i``'s weights are the ``i``-th slice of a
stage-stacked params tree.  The homogeneous-pipeline contract holds:
``stage_fn(stage_params, x) -> y`` with ``y`` of ``x``'s shape and dtype,
and ``num_microbatches`` divides the batch.

* :func:`pipeline_apply` (GPipe): ``M + P - 1`` ticks; every tick each
  rank runs ``stage_fn`` on its microbatch in flight and hands the
  activation to the next stage (``ppermute`` ``i → i + 1``, the
  differentiable one of ``functions/``).  Stage 0's pick of the next
  microbatch and the last stage's emits are tensor selects, never Python
  branches, so every rank's autograd graph has the same collectives and
  its backward, the reverse pipeline, runs them in the same order.  One
  differentiable sum over the axis replicates the result; ``remat``
  recomputes each stage in the backward (``torch.utils.checkpoint``).
* :func:`pipeline_1f1b_grads` (1F1B): each tick every stage runs one
  forward and one backward microbatch (the backward a ``torch.func.vjp``
  of ``stage_fn`` at the input kept in a ``2P - 1``-slot buffer), the
  activations riding the ``+1`` ring and the cotangents the ``-1`` ring;
  it returns the loss and the gradients directly, accumulated in fp32.

The backward of :func:`pipeline_apply` follows the local-loss convention
of ``functions/``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..convert import flatten, tree_map
from ..functions.collective import _psum
from ..functions.point_to_point import _ppermute
from ..ops import collective as col
from ._factory import (P, _zip_map, make_global_apply, model_axis,
                       resolve_mesh_axis)


def _stage_axis(axis_name):
    """``(axis or None, P, this rank's stage)``."""
    axis = model_axis(axis_name)
    if axis is None:
        return None, 1, 0
    return axis, axis.size, col.axis_index(axis)


def _squeeze(stage_params, axis_name, p):
    bad = [tuple(a.shape) for _, a in sorted(flatten(stage_params).items())
           if a.dim() == 0 or a.shape[0] != 1]       # JAX's leaf order
    if bad:
        raise ValueError(
            f"stage_params leaves must carry a leading stage axis of "
            f"length 1 per device (got shapes {bad}); the stacked stage "
            f"count must equal the '{axis_name}' mesh axis size ({p}), or "
            f"pass squeeze_stage_axis=False for already-squeezed params")
    return tree_map(stage_params, lambda a: a[0])


def _microbatches(x, m):
    if x.shape[0] % m:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by num_microbatches {m}")
    return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))


def pipeline_apply(stage_fn: Callable, stage_params, x, *, axis_name,
                   num_microbatches: int, squeeze_stage_axis: bool = True,
                   remat: bool = False):
    """Run ``x`` through the ``P`` stages with GPipe microbatching.

    ``stage_params``: this rank's stage slice (leaves with a leading stage
    axis of 1, stripped here, unless ``squeeze_stage_axis=False``);
    ``x``: the whole batch ``(B, ...)``, the same on every rank.  Returns
    ``stage_{P-1} ∘ … ∘ stage_0`` of every microbatch, the same on every
    rank."""
    axis, p, stage = _stage_axis(axis_name)
    fn = stage_fn
    if remat:
        def fn(prm, h):
            return checkpoint(stage_fn, prm, h, use_reentrant=False)
    if squeeze_stage_axis:
        stage_params = _squeeze(stage_params, axis_name, p)
    m = num_microbatches
    mb = _microbatches(x, m)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == p - 1, device=x.device)
    state = torch.zeros_like(mb[0])
    outs = []
    for t in range(m + p - 1):
        # stage 0 takes the next microbatch (zeros once they run out);
        # every other stage keeps what the ring delivered last tick
        inp = mb[t] if t < m else torch.zeros_like(mb[0])
        y = fn(stage_params, torch.where(first, inp, state))
        if t >= p - 1:          # the last stage emits microbatch t - (P-1)
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if axis is not None and t + 1 < m + p - 1:
            state = _ppermute(y, [(i, (i + 1) % p) for i in range(p)], axis)
    out = torch.stack(outs)
    if axis is not None:
        out = _psum(out, axis)  # only the last stage holds real outputs
    return out.reshape(x.shape)


def pipeline_1f1b_grads(stage_fn: Callable, loss_fn: Callable, stage_params,
                        x, targets, *, axis_name, num_microbatches: int,
                        squeeze_stage_axis: bool = True):
    """1F1B pipeline schedule: returns ``(loss, param_grads)``.

    Stage ``s`` forwards microbatch ``t - s`` and backwards microbatch
    ``t - 2(P-1) + s`` at tick ``t``; the last stage seeds the cotangent
    from ``loss_fn(y_mb, target_mb)`` (a mean over the microbatch) the
    tick its forward finishes.  Returns the mean loss over the
    microbatches (the same on every rank) and the gradients of this
    rank's stage params (a leading stage axis of 1; the params' dtype)."""
    axis, p, stage = _stage_axis(axis_name)
    m = num_microbatches
    if squeeze_stage_axis:
        stage_params = _squeeze(stage_params, axis_name, p)
    mb = _microbatches(x, m)
    tgt = _microbatches(targets, m)
    buf_len = 2 * p - 1
    # the input of microbatch f sits in slot f % buf_len from its forward
    # to its backward, 2(P-1-s) ticks later, before the next write there
    buf = [None] * buf_len
    fwd_state = torch.zeros_like(mb[0])
    cot_in = torch.zeros_like(mb[0])
    grads = tree_map(stage_params, lambda a: torch.zeros(
        a.shape, dtype=torch.float32, device=a.device))
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    is_last = stage == p - 1

    def clip(i):
        return min(max(i, 0), m - 1)

    for t in range(m + 2 * (p - 1)):
        f = t - stage                      # forward microbatch
        b = t - 2 * (p - 1) + stage        # backward microbatch
        valid_f, valid_b = 0 <= f < m, 0 <= b < m
        x_in = mb[clip(t)] if stage == 0 else fwd_state
        with torch.no_grad():
            y = stage_fn(stage_params, x_in)
        buf[f % buf_len] = x_in
        cot = cot_in
        if is_last:
            seed, l_f = torch.func.grad_and_value(loss_fn)(y, tgt[clip(f)])
            if valid_f:
                loss_acc = loss_acc + l_f.float()
            cot = seed if valid_f else torch.zeros_like(y)
        x_bwd = x_in if is_last else buf[b % buf_len]
        if x_bwd is None:                  # a slot not written yet (b < 0)
            x_bwd = torch.zeros_like(mb[0])
        _, vjp = torch.func.vjp(stage_fn, stage_params, x_bwd)
        dparams, dx = vjp(cot.to(y.dtype))
        if valid_b:
            grads = _zip_map(lambda g, d: g + d.float(), grads, dparams)
        if axis is not None:
            fwd_state = col.ppermute(y, [(i, (i + 1) % p) for i in range(p)],
                                     axis)
            cot_in = col.ppermute(dx, [(i, (i - 1) % p) for i in range(p)],
                                  axis)
    loss = loss_acc if axis is None else col.psum(loss_acc, axis)
    grads = _zip_map(lambda g, a: (g[None] / m).to(a.dtype), grads,
                     stage_params)
    return loss / m, grads


def _check_stacked(stacked, n_stages, ax):
    for leaf in flatten(stacked).values():
        if leaf.dim() == 0 or leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage-stacked leaf has leading dim "
                f"{leaf.shape[0] if leaf.dim() else None}, but the "
                f"'{ax}' mesh axis has {n_stages} stages")


def make_pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, mesh=None,
                       axis_name: Optional[str] = None,
                       num_microbatches: int = 8):
    """Global face of :func:`pipeline_1f1b_grads`: ``fn(stage_stacked_params,
    x, targets) -> (loss, stage_stacked_grads)``."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    n_stages = mesh.shape[ax]
    inner = make_global_apply(
        partial(pipeline_1f1b_grads, stage_fn, loss_fn, axis_name=ax,
                num_microbatches=num_microbatches),
        mesh, (P(ax), P(), P()), (P(), P(ax)))

    def apply(stage_stacked_params, x, targets):
        _check_stacked(stage_stacked_params, n_stages, ax)
        return inner(stage_stacked_params, x, targets)

    return apply


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage trees (one per stage, one structure) into
    the stage-stacked tree the pipeline shards: every leaf gains a leading
    axis of length ``P``."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([s[k] for s in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_stage_params([s[i] for s in per_stage_params])
                for i in range(len(first))]
    return torch.stack([torch.as_tensor(a) for a in per_stage_params])


def make_pipeline(stage_fn: Callable, mesh=None,
                  axis_name: Optional[str] = None,
                  num_microbatches: int = 8, remat: bool = False):
    """Global face: ``fn(stage_stacked_params, x) -> y``, the params sharded
    one stage a rank along the mesh axis and ``x`` replicated;
    differentiable (the params' gradients come back stage-stacked)."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    n_stages = mesh.shape[ax]
    inner = make_global_apply(
        partial(pipeline_apply, stage_fn, axis_name=ax,
                num_microbatches=num_microbatches, remat=remat),
        mesh, (P(ax), P()), P(), sum_grads=True)

    def apply(stage_stacked_params, x):
        _check_stacked(stage_stacked_params, n_stages, ax)
        return inner(stage_stacked_params, x)

    return apply


__all__ = ["make_pipeline", "make_pipeline_1f1b", "pipeline_1f1b_grads",
           "pipeline_apply", "stack_stage_params"]
