"""Synchronize persistent (non-gradient) model state across ranks.

Counterpart of ``chainermn_tpu/extensions/allreduce_persistent.py``
(reference: ``chainermn/extensions/allreduce_persistent.py ::
AllreducePersistent``): a trainer extension that means a model's
persistent values (BatchNorm running statistics, counters) across ranks,
so evaluation agrees on every rank.  The JAX package means a rank-major
stacked pytree; here each rank means its own tensors through the
communicator: a dict, list or tuple of tensors, or a module's floating
buffers (meaned in place).
"""

from __future__ import annotations

from typing import Any

import torch

from ..communicators.base import CommunicatorBase


def allreduce_persistent(tree: Any, comm: CommunicatorBase) -> Any:
    """The cross-rank mean of every tensor of ``tree`` (a dict, list or
    tuple of tensors, or a module, whose floating buffers are meaned in
    place and which is returned)."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for b in tree.buffers():
                if b.is_floating_point():
                    b.copy_(comm.allreduce(b, op="mean"))
        return tree
    if isinstance(tree, dict):
        return {k: allreduce_persistent(v, comm) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(allreduce_persistent(v, comm) for v in tree)
    return comm.allreduce(tree, op="mean")


class AllreducePersistent:
    """Trainer extension: mean the persistent state across ranks.

    ``state_getter`` / ``state_setter`` pull and push it on the trainer
    (default: the ``trainer.persistent_state`` attribute), as in the JAX
    package."""

    def __init__(self, comm: CommunicatorBase,
                 state_getter=None, state_setter=None):
        self.comm = comm
        self._get = state_getter or (
            lambda t: getattr(t, "persistent_state", None))
        self._set = state_setter or (
            lambda t, v: setattr(t, "persistent_state", v))

    def __call__(self, trainer) -> None:
        tree = self._get(trainer)
        if tree is not None:
            self._set(trainer, allreduce_persistent(tree, self.comm))
