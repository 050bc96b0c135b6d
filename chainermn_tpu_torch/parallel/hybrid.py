"""The training step at world 1: loss → backward → optimizer, in place.

Counterpart of ``chainermn_tpu/parallel/hybrid.py ::
make_hybrid_shard_map_step`` with a ``(1, 1)`` ``('data', 'model')``
mesh.  There is no mesh and no partition spec: the model axis has size 1
(the TP layers' collectives are identities) and so has the data axis,
whose loss mean stays a named call (:func:`pmean`) for the data-parallel
slice.

JAX's step is functional (``params, opt_state, batch → params, opt_state,
loss``).  This one is not: the optimizer is a ``torch.optim`` optimizer
built over the parameter leaves (:func:`param_leaves`), and each step
updates those tensors IN PLACE.  The optax recipes map as
``optax.sgd(lr)`` → ``torch.optim.SGD(leaves, lr)`` and ``optax.adam(lr)``
→ ``torch.optim.Adam(leaves, lr)`` (the same defaults: b1 0.9, b2 0.999,
eps 1e-8 added outside the square root).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ..convert import flatten


def pmean(x):
    """The data-axis mean of the loss.  Identity at world 1."""
    return x


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tensors of a nested params dict, in a fixed order."""
    return list(flatten(params).values())


def make_hybrid_shard_map_step(loss_fn: Callable, optimizer, params):
    """``step(params, batch) -> loss``: ``loss_fn(params, batch)`` under
    autograd, ``backward``, one ``optimizer.step()``, then the gradients are
    dropped (``zero_grad(set_to_none=True)``) so they do not outlive the
    step.  The leaves of ``params`` are marked as requiring
    gradients here and updated in place by the optimizer, which must have
    been built over them.  The returned loss is detached."""
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if any(id(leaf) not in owned for leaf in leaves):
        raise ValueError("the optimizer must be built over param_leaves(params)")

    def step(params, batch):
        loss = pmean(loss_fn(params, batch))
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step
