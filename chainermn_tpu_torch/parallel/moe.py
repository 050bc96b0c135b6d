"""Expert parallelism: the mixture-of-experts MLP with all-to-all dispatch.

Counterpart of ``chainermn_tpu/parallel/moe.py`` (the Switch-Transformer /
Mesh-TF dispatch formulation):

* routing is a dense argmax + cumsum over a ``(tokens, experts)`` one-hot
  (the first index wins a tie, as in ``jnp.argmax``; the one-hot cumsums
  are exact in fp32), top-1 (Switch) or top-2 (GShard, second choices
  queued behind every first choice);
* experts are sharded along the axis (``E / P`` a rank) and tokens travel
  to their expert and back by two ``functions.all_to_all`` calls;
* capacity is fixed, ``ceil(topk · T / E · capacity_factor)``: tokens
  past it are dropped (their output is zero);
* the load-balancing loss (Switch eq. 4) is taken from ``fraction`` and
  ``mean_prob``, each averaged over the ranks first.

The dispatch is piecewise constant, so the router's gradient flows only
through the gates and ``mean_prob``.  The backward follows the local-loss
convention of ``functions/``: the gradient of the sum of every rank's
local loss (``mean_prob``'s mean is differentiable, its backward the mean
of the cotangents).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..functions.collective import _pmean, all_to_all
from ..ops import collective as col
from ..topology import DEFAULT_AXIS_NAME
from ._factory import P, make_global_apply, model_axis, resolve_mesh_axis
from .tensor_parallel import matmul_f32


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    inside = (idx >= 0) & (idx < n)
    return (F.one_hot(idx.clamp(0, n - 1), n) * inside[:, None]).to(dtype)


def moe_mlp(x, params, *, axis_name, num_experts: int,
            capacity_factor: float = 1.25,
            activation: Optional[Callable] = None, router_topk: int = 1):
    """Top-1 or top-2 MoE MLP over expert-sharded weights.

    ``x (T, D)``: this rank's tokens.  ``params``: ``router (D, E)``
    replicated; ``wi (E/P, D, F)``, ``bi (E/P, F)``, ``wo (E/P, F, D)``,
    ``bo (E/P, D)`` this rank's experts (:func:`moe_mlp_specs`).
    ``activation`` defaults to gelu (tanh approximation, as
    ``jax.nn.gelu``).  Returns ``(y (T, D), aux)``: dropped tokens give
    zero rows; ``aux`` is the load-balancing scalar, averaged over the
    ranks."""
    if router_topk not in (1, 2):
        raise ValueError(f"router_topk must be 1 or 2, got {router_topk}")
    axis = model_axis(axis_name)
    p = 1 if axis is None else axis.size
    e = num_experts
    if e % p:
        raise ValueError(f"num_experts {e} not divisible by axis size {p}")
    act = activation or (lambda h: F.gelu(h, approximate="tanh"))
    e_local = e // p
    t, d = x.shape
    capacity = int(math.ceil(router_topk * t / e * capacity_factor))

    # route: an fp32 softmax for stable gating
    probs = torch.softmax(matmul_f32(x, params["router"]), dim=-1)  # (T, E)
    onehot = _one_hot(probs.argmax(-1), e, probs.dtype)
    gate1 = (probs * onehot).sum(-1)

    # the aux loss over GLOBAL first-choice statistics: each mean over the
    # ranks BEFORE the product
    fraction, mean_prob = onehot.mean(0), probs.mean(0)
    if axis is not None:
        fraction = col.pmean(fraction, axis)
        mean_prob = _pmean(mean_prob, axis)
    aux = e * (fraction * mean_prob).sum()

    # each token's place at its expert: (cumsum - 1) · onehot summed over
    # the experts
    pos_idx = ((onehot.cumsum(0) - 1.0) * onehot).sum(-1).long()
    keep = (pos_idx < capacity).to(x.dtype)
    dispatch = (onehot.to(x.dtype)[:, :, None]
                * _one_hot(pos_idx, capacity, x.dtype)[:, None, :]
                * keep[:, None, None])                          # (T, E, C)
    if router_topk == 2:
        onehot2 = _one_hot((probs * (1.0 - onehot)).argmax(-1), e,
                           probs.dtype)
        gate2 = (probs * onehot2).sum(-1)
        # second choices queue behind ALL first choices at their expert
        first_counts = onehot.sum(0)
        pos2_idx = ((onehot2.cumsum(0) - 1.0) * onehot2
                    + first_counts[None] * onehot2).sum(-1).long()
        keep2 = (pos2_idx < capacity).to(x.dtype)
        dispatch2 = (onehot2.to(x.dtype)[:, :, None]
                     * _one_hot(pos2_idx, capacity, x.dtype)[:, None, :]
                     * keep2[:, None, None])
        denom = torch.clamp(gate1 + gate2, min=1e-9)
        combine = (dispatch * (gate1 / denom).to(x.dtype)[:, None, None]
                   + dispatch2 * (gate2 / denom).to(x.dtype)[:, None, None])
        dispatch = dispatch + dispatch2
    else:
        combine = dispatch * gate1.to(x.dtype)[:, None, None]

    # to the experts: (T, E, C) x (T, D) → (E, C, D), then every rank's
    # tokens for this rank's experts
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)
    recv = expert_in if axis is None else all_to_all(
        expert_in, axis, split_axis=0, concat_axis=0, tiled=True)
    recv = recv.reshape(p, e_local, capacity, d).transpose(0, 1) \
        .reshape(e_local, p * capacity, d)

    h = torch.einsum("egd,edf->egf", recv.float(),
                     params["wi"].float()).to(x.dtype)
    h = act(h + params["bi"][:, None, :])
    out = torch.einsum("egf,efd->egd", h.float(),
                       params["wo"].float()).to(x.dtype)
    out = out + params["bo"][:, None, :]

    # back to the tokens' owners
    out = out.reshape(e_local, p, capacity, d).transpose(0, 1) \
        .reshape(e, capacity, d)
    back = out if axis is None else all_to_all(
        out, axis, split_axis=0, concat_axis=0, tiled=True)
    y = torch.einsum("tec,ecd->td", combine, back)
    return y.to(x.dtype), aux.to(x.dtype)


def init_moe_mlp_params(rng, d_model: int, d_hidden: int, num_experts: int,
                        dtype=torch.float32, device="cpu") -> dict:
    """GLOBAL params for :func:`moe_mlp` (expert-stacked leaves, leading
    dim ``E``; the JAX package's scales, drawn from a ``torch.Generator``
    or an int seed); shard them by :func:`moe_mlp_specs`."""
    gen = rng if isinstance(rng, torch.Generator) \
        else torch.Generator().manual_seed(int(rng))
    e = num_experts

    def normal(*shape, std):
        t = torch.randn(*shape, generator=gen) * std
        return t.to(device=device, dtype=dtype)

    return {
        "router": normal(d_model, e, std=0.02),
        "wi": normal(e, d_model, d_hidden, std=(2.0 / d_model) ** 0.5),
        "bi": torch.zeros(e, d_hidden, dtype=dtype, device=device),
        "wo": normal(e, d_hidden, d_model, std=(2.0 / d_hidden) ** 0.5),
        "bo": torch.zeros(e, d_model, dtype=dtype, device=device),
    }


def moe_mlp_specs(axis_name: str = DEFAULT_AXIS_NAME) -> dict:
    """The router replicated, the expert-stacked weights sharded on their
    leading dim."""
    return {"router": P(), "wi": P(axis_name), "bi": P(axis_name),
            "wo": P(axis_name), "bo": P(axis_name)}


def make_moe_mlp(num_experts: int, mesh=None, axis_name: Optional[str] = None,
                 capacity_factor: float = 1.25,
                 activation: Optional[Callable] = None,
                 router_topk: int = 1):
    """Global face: ``fn(x, global_params) -> (y, aux)``, the tokens sharded
    over the mesh axis; differentiable end to end."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    return make_global_apply(
        partial(moe_mlp, axis_name=ax, num_experts=num_experts,
                capacity_factor=capacity_factor, activation=activation,
                router_topk=router_topk),
        mesh, (P(ax), moe_mlp_specs(ax)), (P(ax), P()), sum_grads=True)


__all__ = ["init_moe_mlp_params", "make_moe_mlp", "moe_mlp", "moe_mlp_specs"]
