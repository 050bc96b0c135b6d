"""Multi-node optimizer wrappers over ``torch.optim``.

Counterpart of ``chainermn_tpu/optimizers.py`` (reference:
``chainermn/optimizers.py``):

* :func:`create_multi_node_optimizer` wraps a ``torch.optim`` optimizer so
  that its ``step`` first means the gradients across ranks (one
  all-reduce of one flat bucket, optionally ``bfloat16`` or ``float16``
  on the wire) and then applies the wrapped optimizer;
* ``double_buffering=True`` applies the PREVIOUS step's mean and keeps
  this step's for the next (1-step staleness; the first step applies the
  zero-filled buffer, ``zero_fill``).

optax recipes map onto ``torch.optim``: ``optax.chain(
add_decayed_weights(wd), sgd(lr, momentum))`` is ``torch.optim.SGD(params,
lr, momentum, weight_decay=wd)`` (the decay is added to the mean gradient,
then the momentum trace ``g + momentum·trace``, then ``−lr`` times it).
``optax.lars``, ``optax.lamb``, ``optax.adaptive_grad_clip`` and the
linear warmup have no ``torch.optim`` twin: :mod:`chainermn_tpu_torch.optim`
has them.

The int8 quantized ring and error feedback are not ported (ROADMAP.md,
queue A item 9).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.distributed as dist

from .health import guarded

_INT8 = ("the int8 quantized ring and error feedback are not ported yet: "
         "see ROADMAP.md, queue A item 9")
_WIRE = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16, torch.float32: torch.float32,
         torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}


def _wire_dtype(allreduce_grad_dtype):
    if str(allreduce_grad_dtype).replace("torch.", "") in ("int8", "uint8"):
        raise NotImplementedError(_INT8)
    if allreduce_grad_dtype not in _WIRE:
        raise ValueError(f"allreduce_grad_dtype must be None, 'float32', "
                         f"'bfloat16' or 'float16' (int8: see ROADMAP.md, "
                         f"queue A item 9), got {allreduce_grad_dtype!r}")
    return _WIRE[allreduce_grad_dtype]


def _bucket(grads, dtype=torch.float32):
    """The gradient tensors flattened into ONE ``dtype`` vector, and the
    function that splits a vector back into tensors of the original shapes
    and dtypes: one wire collective per step instead of one per leaf."""
    shapes = [(g.shape, g.dtype, g.numel()) for g in grads]
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])

    def unbucket(vec):
        out, off = [], 0
        for shape, dt, n in shapes:
            out.append(vec[off:off + n].reshape(shape).to(dt))
            off += n
        return out

    return flat, unbucket


def _resolve_mesh(communicator):
    """The 1-D mesh a communicator (or a mesh itself) reduces over: the
    counterpart of JAX's ``_resolve_axis``."""
    return getattr(communicator, "mesh", communicator)


@guarded("compressed_mean")
def compressed_mean(grads: List[torch.Tensor], communicator,
                    allreduce_grad_dtype=None) -> List[torch.Tensor]:
    """The cross-rank mean of ``grads`` (a list of tensors) over a
    communicator's (or a mesh's) process group, each returned in its own
    dtype.  The bucket goes over the wire in fp32 or, with
    ``allreduce_grad_dtype="bfloat16"`` or ``"float16"`` (ChainerMN's own
    compression), in that dtype: each gradient rounded to it, summed in it,
    divided by the size in it and cast back, as JAX's ``pmean`` of
    ``g.astype(wire)`` is."""
    wire = _wire_dtype(allreduce_grad_dtype) or torch.float32
    if not grads:
        return []
    mesh = _resolve_mesh(communicator)
    flat, unbucket = _bucket(grads, wire)
    dist.all_reduce(flat, group=mesh.group)
    return unbucket(flat.div_(mesh.size))


def _grads_of(params):
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def gradient_average(params, communicator, allreduce_grad_dtype=None):
    """Replace every ``p.grad`` of ``params`` with its cross-rank mean over
    a communicator's (or a mesh's) group (reference:
    ``communicator.multi_node_mean_grad(model)``)."""
    params = list(params)
    for p, g in zip(params, compressed_mean(_grads_of(params), communicator,
                                            allreduce_grad_dtype)):
        p.grad = g


class DoubleBufferState(NamedTuple):
    """The mean gradients of the previous step, applied at this one."""

    stale_grads: List[torch.Tensor]


class MultiNodeOptimizer:
    """``step()``: the one cross-rank gradient mean, then the wrapped
    optimizer's step (on the previous step's mean when double-buffered).
    ``zero_grad`` and ``param_groups`` pass through."""

    def __init__(self, actual_optimizer, communicator,
                 double_buffering=False, allreduce_grad_dtype=None):
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self.double_buffering = double_buffering
        _wire_dtype(allreduce_grad_dtype)
        self.params = [p for group in actual_optimizer.param_groups
                       for p in group["params"]]
        self.state = (DoubleBufferState([torch.zeros_like(p)
                                         for p in self.params])
                      if double_buffering else None)

    @property
    def param_groups(self):
        return self.actual_optimizer.param_groups

    def step(self):
        fresh = compressed_mean(_grads_of(self.params), self.communicator,
                                self.allreduce_grad_dtype)
        if self.double_buffering:
            apply, self.state = self.state.stale_grads, DoubleBufferState(fresh)
        else:
            apply = fresh
        for p, g in zip(self.params, apply):
            p.grad = g
        self.actual_optimizer.step()

    def zero_grad(self, set_to_none: bool = True):
        self.actual_optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        """The wrapped optimizer's state and, double-buffered, the mean
        gradients waiting for the next step."""
        out = {"optimizer": self.actual_optimizer.state_dict()}
        if self.double_buffering:
            out["stale_grads"] = [g.detach().clone()
                                  for g in self.state.stale_grads]
        return out

    def load_state_dict(self, state: dict) -> None:
        self.actual_optimizer.load_state_dict(state["optimizer"])
        if self.double_buffering:
            self.state = DoubleBufferState(
                [torch.as_tensor(g).to(p.device, p.dtype).clone()
                 for g, p in zip(state["stale_grads"], self.params)])


def create_multi_node_optimizer(actual_optimizer, communicator,
                                double_buffering: bool = False,
                                zero_fill: bool = True,
                                allreduce_grad_dtype=None,
                                error_feedback: bool = False
                                ) -> MultiNodeOptimizer:
    """Wrap ``actual_optimizer`` (a ``torch.optim`` optimizer built over
    the model's parameters) with the cross-rank gradient mean (reference:
    ``create_multi_node_optimizer``)."""
    if error_feedback:
        raise NotImplementedError(_INT8)
    if double_buffering and not zero_fill:
        raise NotImplementedError(
            "double_buffering requires zero_fill=True (the reference's "
            "gradient buffers start zeroed)")
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering, allreduce_grad_dtype)
