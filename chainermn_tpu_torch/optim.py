"""The large-batch optimizers of the ImageNet example: LARS, LAMB, adaptive gradient clipping and the linear warmup.

Counterparts of the optax transforms that ``examples/imagenet/
train_imagenet.py`` chains (optax 0.2.6), as ``torch.optim`` optimizers and
optimizer wrappers that :func:`~chainermn_tpu_torch.optimizers
.create_multi_node_optimizer` wraps, so each sees the cross-rank mean
gradient:

* :class:`Lars` is ``optax.lars(lr, weight_decay, momentum=m)``:
  ``u = g + wd·p``, ``u ← u·trust`` (``trust = 0.001·‖p‖ / ‖u‖``, 1 where
  either norm is 0), ``u ← −lr·u``, then the momentum trace ``t = u +
  m·t`` is the update.  The trace follows the learning rate, unlike
  ``torch.optim.SGD``'s;
* :class:`Lamb` is ``optax.lamb(lr, weight_decay=wd)``: Adam's bias-corrected
  ``m̂ / (sqrt(v̂) + 1e-6)``, plus ``wd·p``, times the trust ratio ``‖p‖ /
  ‖u‖`` (1 where either norm is 0), times ``−lr``;
* :class:`AdaptiveGradClip` is ``optax.adaptive_grad_clip(clipping)``
  ahead of an optimizer: each unit's gradient is scaled to at most
  ``clipping·max(‖p‖_unit, 1e-3)``.  Units follow the JAX layout of each
  leaf: a leaf that squeezes to a vector (or a scalar) is one unit, a 2-D
  or 3-D leaf reduces its axis 0 and a 4-D leaf (0, 1, 2).  An
  ``nn.Linear`` weight is flax's (in, out) kernel transposed, so its units
  reduce dim 1 (:func:`linear_weights` names them);
* :class:`Scheduled` sets every group's learning rate to ``schedule(count)``
  before each step, ``count`` counted from 0 as optax counts it (the step
  reads the count before incrementing it), and :func:`linear_schedule` is
  ``optax.linear_schedule``: step 0 of a warmup from 0 runs at lr 0.

Every decay and trust ratio covers every parameter (optax's masks default
to all of them).

A parameter that is this rank's block of a leaf sharded over a data axis
(ZeRO-1 and FSDP, :mod:`chainermn_tpu_torch.parallel.hybrid`) gets the
norms of the WHOLE leaf, as JAX's GSPMD computes them: each sum of squares
that runs over the sharded dim is summed over the axis's ranks first.
:func:`shard_norms` names those parameters to an optimizer (and to the
ones it wraps).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn as nn


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: ``init`` at count 0, ``end`` from count
    ``transition_steps`` on, linear between (constant ``init`` when
    ``transition_steps <= 0``)."""
    def schedule(count):
        if transition_steps <= 0:
            return init_value
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _norm(x, dims=None, shard=None):
    """The L2 norm (over ``dims``, kept) as the square root of a sum of
    squares: torch's CPU ``vector_norm`` of a 2.4M-element leaf is off by
    ~4e-5, its ``sum`` by ~2e-8.  ``shard``, ``(mesh, dim)``: ``x`` is this
    rank's block along ``dim`` of a leaf sharded over ``mesh``, and a sum
    over ``dim`` is summed over the mesh's ranks."""
    sq = x.square().sum() if dims is None \
        else x.square().sum(dims, keepdim=True)
    if shard is not None and (dims is None or shard[1] in dims):
        from .ops import collective as col

        sq = col.psum(sq, shard[0])
    return sq.sqrt()


def shard_norms(optimizer, shards) -> None:
    """Tell ``optimizer`` and every optimizer it wraps that each parameter
    of ``shards`` (``{param: (mesh, dim)}``) is this rank's block along
    ``dim`` of a leaf sharded over ``mesh``: their layer-wise norms (LARS
    and LAMB's trust ratios, AGC's unit norms) then cover the whole leaf.
    Elementwise optimizers (SGD, Adam) ignore it."""
    by_id = {id(p): v for p, v in shards.items()}
    while optimizer is not None:
        optimizer._shards = by_id
        optimizer = getattr(optimizer, "optimizer", None)


def _shard_of(optimizer, p):
    return getattr(optimizer, "_shards", {}).get(id(p))


def _trust_ratio(p, u, coefficient, shard=None):
    pn, un = _norm(p, shard=shard), _norm(u, shard=shard)
    ratio = coefficient * pn / un
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


class Lars(torch.optim.Optimizer):
    """``optax.lars`` (``trust_coefficient`` 0.001, ``eps`` 0, no
    Nesterov): see the module docstring for the order of its steps."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad + group["weight_decay"] * p
                u = -group["lr"] * (u * _trust_ratio(
                    p, u, group["trust_coefficient"], _shard_of(self, p)))
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.mul_(group["momentum"]).add_(u)
                p.add_(trace)


class Lamb(torch.optim.Optimizer):
    """``optax.lamb`` (``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-6, ``eps_root``
    0): see the module docstring for the order of its steps."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if "count" not in state:
                    state.update(count=0, mu=torch.zeros_like(p),
                                 nu=torch.zeros_like(p))
                state["count"] += 1
                c = state["count"]
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g.square(), alpha=1 - b2)
                # optax's bias correction 1 - b**c in the moment's dtype:
                # 1 - 0.999 in fp32 is 9.9998713e-4, not 1e-3
                bc1, bc2 = (1 - torch.tensor(b, dtype=p.dtype) ** c
                            for b in (b1, b2))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                u = u + group["weight_decay"] * p
                p.add_(-group["lr"] * (u * _trust_ratio(
                    p, u, 1.0, _shard_of(self, p))))


class _Wrapper:
    """An optimizer wrapper with the face :class:`~chainermn_tpu_torch
    .optimizers.MultiNodeOptimizer` reads: ``param_groups``, ``step``,
    ``zero_grad``, ``state_dict`` / ``load_state_dict``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])


class Scheduled(_Wrapper):
    """``optimizer`` with every group's ``lr`` set to ``schedule(count)``
    before each step; ``count`` starts at 0 and counts the steps taken."""

    def __init__(self, optimizer, schedule: Callable[[int], float]):
        super().__init__(optimizer)
        self.schedule, self.count = schedule, 0

    def step(self):
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.count = state["count"]


def linear_weights(module: nn.Module) -> list:
    """The ``nn.Linear`` weights of ``module``: flax's (in, out) kernels
    held transposed, whose clipping units reduce dim 1."""
    return [m.weight for m in module.modules() if isinstance(m, nn.Linear)]


def unit_dims(shape, transposed: bool = False):
    """The dims that one clipping unit reduces (optax's ``unitwise_norm``
    of the JAX leaf), or None for the whole leaf."""
    if sum(n != 1 for n in shape) <= 1:      # squeezes to a vector or scalar
        return None
    if len(shape) in (2, 3):
        return (1,) if transposed and len(shape) == 2 else (0,)
    if len(shape) == 4:
        return (0, 1, 2)
    raise ValueError(f"adaptive_grad_clip takes leaves of 1-4 dims, got "
                     f"shape {tuple(shape)}")


class AdaptiveGradClip(_Wrapper):
    """``optax.adaptive_grad_clip(clipping)`` (eps 1e-3) on each ``p.grad``,
    then ``optimizer.step()``.  ``transposed`` lists the parameters held
    as the transpose of their JAX leaf (:func:`linear_weights`)."""

    def __init__(self, optimizer, clipping: float, eps: float = 1e-3,
                 transposed: Iterable[torch.Tensor] = ()):
        if clipping < 0:
            raise ValueError(f"clipping must be >= 0, got {clipping}")
        super().__init__(optimizer)
        self.clipping, self.eps = clipping, eps
        self._transposed = {id(p) for p in transposed}

    @torch.no_grad()
    def clip(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                shard = _shard_of(self, p)
                shape = list(p.shape)        # the whole leaf's
                if shard is not None:
                    shape[shard[1]] *= shard[0].size
                dims = unit_dims(shape, id(p) in self._transposed)
                g_norm = _norm(p.grad, dims, shard)
                max_norm = self.clipping * _norm(p, dims, shard).clamp_min(
                    self.eps)
                clipped = p.grad * (max_norm / g_norm.clamp_min(1e-6))
                p.grad = torch.where(g_norm < max_norm, p.grad, clipped)

    def step(self):
        self.clip()
        self.optimizer.step()
