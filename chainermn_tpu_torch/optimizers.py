"""Multi-node optimizer wrappers over ``torch.optim``.

Counterpart of ``chainermn_tpu/optimizers.py`` (reference:
``chainermn/optimizers.py``):

* :func:`create_multi_node_optimizer` wraps a ``torch.optim`` optimizer so
  that its ``step`` first means the gradients across ranks (one
  all-reduce of one flat bucket, optionally ``bfloat16`` or ``float16``
  on the wire) and then applies the wrapped optimizer;
* ``allreduce_grad_dtype="int8"`` sends the bucket through the
  block-scaled int8 ring (:func:`~chainermn_tpu_torch.ops.collective
  .quantized_ring_pmean`: ``quant_block`` elements a scale,
  ``quant_pipeline`` sub-chunks a hop), and ``error_feedback=True`` keeps
  this rank's quantization residual (:class:`ErrorFeedbackState`) and
  adds it to the next step's bucket (EF-SGD);
* ``double_buffering=True`` applies the PREVIOUS step's mean and keeps
  this step's for the next (1-step staleness; the first step applies the
  zero-filled buffer, ``zero_fill``), with the int8 wire and its residual
  too;
* :func:`hierarchical_gradient_average` is the two-tier mean over a
  ``('slice', 'chip')`` mesh, as a ``grad_reduce`` of the train steps.

optax recipes map onto ``torch.optim``: ``optax.chain(
add_decayed_weights(wd), sgd(lr, momentum))`` is ``torch.optim.SGD(params,
lr, momentum, weight_decay=wd)`` (the decay is added to the mean gradient,
then the momentum trace ``g + momentum·trace``, then ``−lr`` times it).
``optax.lars``, ``optax.lamb``, ``optax.adaptive_grad_clip`` and the
linear warmup have no ``torch.optim`` twin: :mod:`chainermn_tpu_torch.optim`
has them.

JAX's residual state is one ``(world, n_total)`` leaf sharded over the
data axis, row ``r`` rank ``r``'s; here each rank is a process that holds
its own ``(1, n_total)`` row.  :func:`error_feedback_layout` names the rows
for a checkpoint's manifest (sharded on axis 0, so a saved generation
holds JAX's whole leaf), and a block of ``k`` rows given to
``load_state_dict`` (an elastic resume on ``1/k`` of the world) folds into
one (:func:`fold_error_feedback`).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import _tree
from .health import guarded
from .ops.collective import (DEFAULT_QUANT_BLOCK, _dequant_add, _dtype,
                             _ring_layout, block_quantize,
                             hierarchical_pmean, pmean, quantized_ring_pmean)
from .topology import DEFAULT_AXIS_NAME, Mesh, bound_axis

_FLOAT_WIRES = (torch.float32, torch.bfloat16, torch.float16)


def _is_int(dt) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def _wire_dtype(allreduce_grad_dtype):
    """None (fp32), a float wire dtype, or an integer one (the ring)."""
    if allreduce_grad_dtype is None:
        return None
    try:
        wire = _dtype(allreduce_grad_dtype)
    except TypeError:
        wire = None
    if wire in _FLOAT_WIRES or (wire is not None and _is_int(wire)):
        return wire
    raise ValueError(f"allreduce_grad_dtype must be None, 'float32', "
                     f"'bfloat16', 'float16' or an integer type ('int8'), "
                     f"got {allreduce_grad_dtype!r}")


class ErrorFeedbackState(NamedTuple):
    """This rank's quantization residual of the int8 gradient bucket:
    ``residuals`` is its ``(1, n_total)`` fp32 row (JAX: the rank's row of
    a ``(world, n_total)`` leaf sharded over the data axis).  EF-SGD:
    ``v = g + e``, send ``Q(v)``, keep ``e' = v − Dq(Q(v))``."""

    residuals: Any


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


def _int_wire_mean(grads, mesh, wire, quant_block, quant_pipeline,
                   residuals):
    """The int8 path of :func:`compressed_mean`: one flat bucket through
    the ring, with the residual row folded in and renewed when given."""
    p = mesh.size
    flat, unbucket = _bucket(grads)
    if residuals is None:
        if p == 1:
            return grads
        return unbucket(quantized_ring_pmean(flat, mesh, wire, quant_block,
                                             quant_pipeline))
    if p > 1 and residuals.shape[0] != 1:
        raise ValueError(
            f"error-feedback residual block has leading dim "
            f"{residuals.shape[0]} (expected 1): each rank holds its own "
            f"(1, n) row of the residual")
    if residuals.shape[-1] != flat.shape[0]:
        raise ValueError(
            f"error-feedback residual holds {residuals.shape[-1]} "
            f"elements but the gradient bucket holds {flat.shape[0]} "
            "— the optimizer was initialized against different params")
    if p == 1:
        return grads, residuals
    v = flat + residuals[0]
    mean = unbucket(quantized_ring_pmean(v, mesh, wire, quant_block,
                                         quant_pipeline))
    # e' = v - Dq(Q(v)) at the block the wire uses: the ring clamps the
    # block to the per-rank chunk (_ring_layout), and a coarser residual
    # block would re-inject mass the finer wire already delivered
    _, eff_block, _, _ = _ring_layout(int(v.shape[0]), p, quant_block,
                                      quant_pipeline)
    # rounded once, as XLA fuses JAX's v - q·s into one multiply-add
    q, scales = block_quantize(v, wire, eff_block)
    vb = torch.nn.functional.pad(v, (0, q.numel() - v.numel())).view_as(q)
    new_res = _dequant_add(q, -scales, vb).reshape(-1)[:v.numel()]
    return mean, new_res[None]


@guarded("compressed_mean")
def compressed_mean(grads: List[torch.Tensor], communicator,
                    allreduce_grad_dtype=None,
                    quant_block: int = DEFAULT_QUANT_BLOCK,
                    quant_pipeline: int = 1, residuals=None):
    """The cross-rank mean of ``grads`` (a list of tensors) over a
    communicator's (or a mesh's) process group, each returned in its own
    dtype.  The bucket goes over the wire in fp32 or, with
    ``allreduce_grad_dtype="bfloat16"`` or ``"float16"`` (ChainerMN's own
    compression), in that dtype: each gradient rounded to it, summed in it,
    divided by the size in it and cast back, as JAX's ``pmean`` of
    ``g.astype(wire)`` is.

    An integer ``allreduce_grad_dtype`` (``"int8"``) sends the fp32 bucket
    through :func:`~chainermn_tpu_torch.ops.collective
    .quantized_ring_pmean` (``quant_block``, ``quant_pipeline``).
    ``residuals``, this rank's ``(1, n_total)`` row of an
    :class:`ErrorFeedbackState`, switches on error feedback: ``v = g + e``
    goes on the wire and the return is ``(means, new_residuals)`` with
    ``e' = v − Dq(Q(v))``."""
    wire = _wire_dtype(allreduce_grad_dtype)
    if residuals is not None and (wire is None or not _is_int(wire)):
        raise ValueError("error feedback requires an integer wire dtype, "
                         f"got allreduce_grad_dtype={allreduce_grad_dtype!r}")
    mesh = _resolve_mesh(communicator)
    if wire is not None and _is_int(wire):
        if not grads:
            return [] if residuals is None else ([], residuals)
        return _int_wire_mean(list(grads), mesh, wire, quant_block,
                              quant_pipeline, residuals)
    if not grads:
        return []
    flat, unbucket = _bucket(grads, wire or torch.float32)
    dist.all_reduce(flat, group=mesh.group)
    return unbucket(flat.div_(mesh.size))


def _grads_of(params):
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def _resolve_world(communicator, world: Optional[int]) -> int:
    """The world size the residual rows belong to: ``world`` if given,
    else the communicator's (or mesh's) size; neither raises."""
    if world is not None:
        return int(world)
    size = getattr(communicator, "size", None)
    if size is None:
        raise ValueError(
            "error_feedback=True needs the world size to allocate the "
            "per-rank residual rows: pass a real communicator (xla/naive) "
            "or world=<axis size> explicitly")
    return int(size)


def _check_ef(error_feedback, allreduce_grad_dtype, communicator, world):
    if not error_feedback:
        return
    wire = _wire_dtype(allreduce_grad_dtype)
    if wire is None or not _is_int(wire):
        raise ValueError("error_feedback=True requires an integer "
                         f"allreduce_grad_dtype, got {allreduce_grad_dtype!r}")
    _resolve_world(communicator, world)


def _ef_init(params) -> ErrorFeedbackState:
    """This rank's zero residual row, ``(1, n_total)`` fp32 over the
    bucketed gradient size on the parameters' device (``zero_fill``: the
    first step's wire carries the raw gradients)."""
    params = list(params)
    n_total = sum(int(p.numel()) for p in params)
    dev = params[0].device if params else None
    return ErrorFeedbackState(torch.zeros(1, n_total, dtype=torch.float32,
                                          device=dev))


def gradient_average(params, communicator, allreduce_grad_dtype=None,
                     error_feedback: bool = False,
                     quant_block: int = DEFAULT_QUANT_BLOCK,
                     quant_pipeline: int = 1, world: Optional[int] = None,
                     state: Optional[ErrorFeedbackState] = None):
    """Replace every ``p.grad`` of ``params`` with its cross-rank mean over
    a communicator's (or a mesh's) group (reference:
    ``communicator.multi_node_mean_grad(model)``).  With
    ``error_feedback`` (an integer wire only) ``state`` is this rank's
    :class:`ErrorFeedbackState` (None: zeros) and the new one is
    returned; otherwise None is."""
    _check_ef(error_feedback, allreduce_grad_dtype, communicator, world)
    params = list(params)
    grads = _grads_of(params)
    new_state = None
    if error_feedback:
        res = (state or _ef_init(params)).residuals
        grads, res = compressed_mean(grads, communicator,
                                     allreduce_grad_dtype, quant_block,
                                     quant_pipeline, residuals=res)
        new_state = ErrorFeedbackState(res)
    else:
        grads = compressed_mean(grads, communicator, allreduce_grad_dtype,
                                quant_block, quant_pipeline)
    for p, g in zip(params, grads):
        p.grad = g
    return new_state


def _axis(name):
    return name if isinstance(name, Mesh) else bound_axis(name)


def hierarchical_gradient_average(chip_axis="chip", slice_axis="slice",
                                  dcn_dtype=None):
    """``reduce(grads) -> grads``: the two-tier mean over a multislice
    ``('slice', 'chip')`` mesh (:func:`~chainermn_tpu_torch.ops.collective
    .hierarchical_pmean`), for ``make_train_step(..., grad_reduce=...)``.
    With only ``chip_axis`` bound (``with mesh:``, or a
    :class:`~chainermn_tpu_torch.topology.Mesh`) it is the mean over it;
    with only ``slice_axis``, the mean over it with ``dcn_dtype`` on the
    wire; with neither, the gradients unchanged."""
    def reduce(grads):
        grads = list(grads)
        chip, slc = _axis(chip_axis), _axis(slice_axis)
        if chip is not None and slc is not None:
            return hierarchical_pmean(grads, chip, slc, dcn_dtype)
        if chip is not None:
            return pmean(grads, chip)
        if slc is not None:
            return compressed_mean(grads, slc, dcn_dtype)
        return grads

    return reduce


class DoubleBufferState(NamedTuple):
    """The mean gradients of the previous step, applied at this one, and
    in the int8 + error-feedback mode this rank's residual (``()``
    otherwise)."""

    stale_grads: List[torch.Tensor]
    ef: Any = ()


class MultiNodeOptimizer:
    """``step()``: the one cross-rank gradient mean, then the wrapped
    optimizer's step (on the previous step's mean when double-buffered).
    ``zero_grad`` and ``param_groups`` pass through.  ``state`` is the
    wrapper's own (JAX's transform state): None, this rank's
    :class:`ErrorFeedbackState`, or a :class:`DoubleBufferState`."""

    def __init__(self, actual_optimizer, communicator,
                 double_buffering=False, allreduce_grad_dtype=None,
                 error_feedback=False,
                 quant_block: int = DEFAULT_QUANT_BLOCK,
                 quant_pipeline: int = 1):
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self.double_buffering = double_buffering
        self.error_feedback = error_feedback
        self.quant_block, self.quant_pipeline = quant_block, quant_pipeline
        _wire_dtype(allreduce_grad_dtype)
        self.params = [p for group in actual_optimizer.param_groups
                       for p in group["params"]]
        ef = _ef_init(self.params) if error_feedback else None
        if double_buffering:
            self.state = DoubleBufferState(
                [torch.zeros_like(p) for p in self.params],
                ef if ef is not None else ())
        else:
            self.state = ef

    @property
    def param_groups(self):
        return self.actual_optimizer.param_groups

    @property
    def ef(self) -> Optional[ErrorFeedbackState]:
        """This rank's residual state, or None without error feedback."""
        if not self.error_feedback:
            return None
        return self.state.ef if self.double_buffering else self.state

    def step(self):
        grads = _grads_of(self.params)
        kw = dict(quant_block=self.quant_block,
                  quant_pipeline=self.quant_pipeline)
        ef = self.ef
        if ef is not None:
            fresh, res = compressed_mean(grads, self.communicator,
                                         self.allreduce_grad_dtype,
                                         residuals=ef.residuals, **kw)
            ef = ErrorFeedbackState(res)
        else:
            fresh = compressed_mean(grads, self.communicator,
                                    self.allreduce_grad_dtype, **kw)
        if self.double_buffering:
            apply = self.state.stale_grads
            self.state = DoubleBufferState(fresh, ef if ef is not None
                                           else ())
        else:
            apply, self.state = fresh, ef
        for p, g in zip(self.params, apply):
            p.grad = g
        self.actual_optimizer.step()

    def zero_grad(self, set_to_none: bool = True):
        self.actual_optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        """The wrapped optimizer's state and, double-buffered, the mean
        gradients waiting for the next step; with error feedback, ``"ef"``:
        this rank's :class:`ErrorFeedbackState` (its manifest layout is
        :func:`error_feedback_layout`)."""
        out = {"optimizer": self.actual_optimizer.state_dict()}
        if self.double_buffering:
            out["stale_grads"] = [g.detach().clone()
                                  for g in self.state.stale_grads]
        if self.ef is not None:
            out["ef"] = ErrorFeedbackState(
                self.ef.residuals.detach().clone())
        return out

    def load_state_dict(self, state: dict) -> None:
        """The inverse of :meth:`state_dict`.  A residual block of ``k``
        rows (an elastic resume of a ``k`` times larger world: this rank
        inherits ``k`` ranks' rows) folds into one
        (:func:`fold_error_feedback`)."""
        self.actual_optimizer.load_state_dict(state["optimizer"])
        ef = None
        if self.error_feedback:
            res = state["ef"].residuals
            if res.shape[0] != 1:
                res = fold_error_feedback(
                    res.cpu().numpy() if isinstance(res, torch.Tensor)
                    else res, 1)
            dev = self.params[0].device
            ef = ErrorFeedbackState(torch.as_tensor(res).to(
                dev, torch.float32).clone())
        if self.double_buffering:
            stale = [torch.as_tensor(g).to(p.device, p.dtype).clone()
                     for g, p in zip(state["stale_grads"], self.params)]
            self.state = DoubleBufferState(stale, ef if ef is not None
                                           else ())
        else:
            self.state = ef


def create_multi_node_optimizer(actual_optimizer, communicator,
                                double_buffering: bool = False,
                                zero_fill: bool = True,
                                allreduce_grad_dtype=None,
                                error_feedback: bool = False,
                                quant_block: int = DEFAULT_QUANT_BLOCK,
                                quant_pipeline: int = 1,
                                world: Optional[int] = None
                                ) -> MultiNodeOptimizer:
    """Wrap ``actual_optimizer`` (a ``torch.optim`` optimizer built over
    the model's parameters) with the cross-rank gradient mean (reference:
    ``create_multi_node_optimizer``).  ``allreduce_grad_dtype="int8"``
    runs the block-scaled ring over one bucket (``quant_block`` elements a
    scale, ``quant_pipeline`` sub-chunks a hop); ``error_feedback=True``
    adds this rank's residual (an integer wire only; ``world``, or the
    communicator's size, names the world its row belongs to).  With
    ``double_buffering`` too, the ring of step ``k`` is applied at step
    ``k + 1`` and the residual advances every step."""
    _check_ef(error_feedback, allreduce_grad_dtype, communicator, world)
    if double_buffering and not zero_fill:
        raise NotImplementedError(
            "double_buffering requires zero_fill=True (the reference's "
            "gradient buffers start zeroed)")
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering, allreduce_grad_dtype,
                              error_feedback, quant_block, quant_pipeline)


# ---------------------------------------------------------------------------
# error-feedback state plumbing: specs, checkpoint layout, elastic fold
# ---------------------------------------------------------------------------

def _is_ef(node) -> bool:
    return isinstance(node, ErrorFeedbackState)


def opt_state_partition_specs(opt_state, axis_name: str = DEFAULT_AXIS_NAME):
    """A spec tree like ``opt_state``: each :class:`ErrorFeedbackState`'s
    residual leaves ``P(axis_name)`` (its rows partition by rank), every
    other leaf ``P()``."""
    from .parallel._factory import P

    leaves, treedef = _tree.flatten(opt_state, is_leaf=_is_ef)
    return treedef.unflatten([
        ErrorFeedbackState(*(P(axis_name) for _ in leaf)) if _is_ef(leaf)
        else P() for leaf in leaves])


def error_feedback_layout(opt_state, prefix: str = "") -> dict:
    """The v2 manifest ``layout`` entries of the residual leaves in
    ``opt_state`` (e.g. a :class:`MultiNodeOptimizer`'s ``state_dict()``):
    leaf path → ``["sharded", 0]``, for
    ``create_multi_node_checkpointer(layout=...)``; ``prefix`` is the
    state's own path in the saved tree."""
    out = {}
    for path, leaf in _tree.flatten_with_path(opt_state, is_leaf=_is_ef)[0]:
        if _is_ef(leaf):
            for sub, _ in _tree.flatten_with_path(leaf)[0]:
                out[prefix + path + sub] = ["sharded", 0]
    return out


def fold_error_feedback(residuals, new_world: int):
    """Re-partition residual rows ``(old_world, n)`` for ``new_world``,
    keeping the applied correction ``(1/p)·Σ_r e_r``: a shrink (``new |
    old``) sums each new rank's inherited rows times ``new/old``; a growth
    (``old | new``) repeats rows; other changes raise."""
    res = np.asarray(residuals)
    old = res.shape[0]
    new_world = int(new_world)
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1, got {new_world}")
    if old == new_world:
        return res
    if old % new_world == 0:
        fold = old // new_world
        return (res.reshape(new_world, fold, -1).sum(axis=1)
                * (new_world / old)).astype(res.dtype)
    if new_world % old == 0:
        return np.repeat(res, new_world // old, axis=0)
    raise ValueError(
        f"cannot fold EF residuals {old} -> {new_world}: world sizes "
        "must divide one another (shrink sums inherited rows, growth "
        "repeats them)")
