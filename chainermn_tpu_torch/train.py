"""Data-parallel training steps over ``torch.distributed``.

Counterpart of ``chainermn_tpu/train.py`` (``make_train_step``,
``make_flax_train_step``, ``replicate``, ``shard_batch``,
``shard_batch_local``).  JAX's step is one SPMD program over a mesh that
is handed the GLOBAL batch; here each rank is a process that runs its
local shard eagerly, and the step updates the module's tensors in place:

* the loss is the mean over the LOCAL rows; ``backward`` gives local
  gradients; the gradient is meaned across ranks exactly ONCE, by the
  optimizer wrapper (:func:`~chainermn_tpu_torch.optimizers
  .create_multi_node_optimizer`), or by the step itself before a plain
  ``torch.optim`` step (JAX gets the same mean from differentiating the
  pmean'd loss);
* the returned loss (and metrics) are the cross-rank means;
* ``make_flax_train_step`` then means the BatchNorm running statistics
  across ranks (JAX's ``pmean`` of ``batch_stats`` after the update).

``shard_batch`` takes the global batch every process holds and gives
rank ``r`` rows ``[r·B/P, (r+1)·B/P)`` (JAX's rank-major sharding) on its
device; ``shard_batch_local`` moves rows a process loaded itself.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .optimizers import MultiNodeOptimizer, compressed_mean, gradient_average
from .topology import DEFAULT_AXIS_NAME, make_mesh


def _pmean(tensors, mesh):
    return compressed_mean([t.detach().float() for t in tensors], mesh)


def _mean_metrics(loss, metrics, mesh):
    names = sorted(metrics or {})
    values = _pmean([loss] + [torch.as_tensor(metrics[k], device=loss.device)
                              for k in names], mesh)
    return values[0], {k: v for k, v in zip(names, values[1:])}


def _step_once(loss_of, optimizer, mesh, allreduce_grad_dtype):
    loss, metrics = loss_of()
    loss.backward()
    if not isinstance(optimizer, MultiNodeOptimizer):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        gradient_average(params, mesh, allreduce_grad_dtype)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return _mean_metrics(loss.detach(), metrics, mesh)


def make_train_step(loss_fn: Callable, optimizer, mesh=None,
                    axis_name: str = DEFAULT_AXIS_NAME, has_aux: bool = False,
                    allreduce_grad_dtype=None):
    """``step(module, batch) -> loss`` (``(loss, aux)`` with ``has_aux``):
    ``loss_fn(module, local_batch)`` is the mean loss over this rank's rows
    (and an aux dict of scalars), ``optimizer`` was built over the module's
    parameters."""
    mesh = mesh or make_mesh(axis_name)

    def step(module, batch):
        def loss_of():
            out = loss_fn(module, batch)
            return out if has_aux else (out, {})

        module.train()
        loss, aux = _step_once(loss_of, optimizer, mesh, allreduce_grad_dtype)
        return (loss, aux) if has_aux else loss

    return step


def make_flax_train_step(model, loss_and_metrics: Callable, optimizer,
                         mesh=None, axis_name: str = DEFAULT_AXIS_NAME,
                         allreduce_grad_dtype=None,
                         preprocess: Optional[Callable] = None):
    """``step(model, batch) -> (loss, metrics)`` for a module with BatchNorm
    running statistics: ``loss_and_metrics(logits, batch) -> (loss,
    metrics)`` over this rank's rows; ``batch[0]`` goes into the model in
    training mode; ``preprocess(batch)`` runs first, on the device.  After
    the update the floating buffers (the running statistics) are meaned
    across ranks."""
    mesh = mesh or make_mesh(axis_name)
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if any(id(p) not in owned for p in model.parameters()):
        raise ValueError("the optimizer must be built over model.parameters()")

    def step(module, batch):
        if module is not model:
            raise ValueError("the step was built for another module")
        if preprocess is not None:
            batch = preprocess(batch)
        module.train()

        def loss_of():
            return loss_and_metrics(module(batch[0]), batch)

        loss, metrics = _step_once(loss_of, optimizer, mesh,
                                   allreduce_grad_dtype)
        stats = [b for b in module.buffers() if b.is_floating_point()]
        with torch.no_grad():
            for b, m in zip(stats, _pmean(stats, mesh)):
                b.copy_(m)
        return loss, metrics

    return step


def replicate(module, communicator):
    """Rank 0's parameters and buffers on every rank (in place)."""
    return communicator.broadcast_data(module)


def _to_device(x, device):
    """A host array onto ``device`` as a copy: through pinned memory and a
    non-blocking copy on the card, so the caller may reuse its buffer."""
    t = torch.as_tensor(np.asarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def shard_batch_local(local_batch, device):
    """This process's rows (a tuple of host arrays) on its device."""
    return tuple(_to_device(b, device) for b in local_batch)


def shard_batch(batch, device, mesh=None, axis_name: str = DEFAULT_AXIS_NAME):
    """Rank ``r``'s rows ``[r·B/P, (r+1)·B/P)`` of the global host batch
    every process holds, on ``device``."""
    mesh = mesh or make_mesh(axis_name)
    rank = dist.get_rank(mesh.group)
    rows = len(batch[0])
    if rows % mesh.size:
        raise ValueError(f"global batch {rows} is not divisible by the "
                         f"world size {mesh.size}")
    per = rows // mesh.size
    return shard_batch_local(
        tuple(np.asarray(b)[rank * per:(rank + 1) * per] for b in batch),
        device)
