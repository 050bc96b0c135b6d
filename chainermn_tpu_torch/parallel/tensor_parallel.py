"""Intra-layer tensor parallelism: column/row-parallel dense, the vocab-parallel embedding, the TP MLP and its sequence-parallel form.

Counterpart of ``chainermn_tpu/parallel/tensor_parallel.py``.  Every
function takes ``axis_name``: an axis of the N-D mesh bound by ``with
mesh:`` (``topology.make_nd_mesh``), a 1-D ``topology.Mesh``, or None (no
model axis: the one-card path, every collective skipped, as at axis size
1).  Each rank holds its shards, as JAX's functions do inside
``shard_map``.

JAX gets each gradient from autodiff of one SPMD program, where the model
axis' collectives transpose by their varying-axis types.  Here each rank
runs its own autograd, and the layers place Megatron's pair of functions
so that every rank's backward gives JAX's gradient:

* :func:`copy_to_model` (Megatron's ``f``): identity forward, the
  cotangent summed over the model axis backward; at the input of every
  column-parallel product, whose replicated input feeds a different shard
  on each rank;
* :func:`reduce_from_model` (``g``): the sum over the model axis forward,
  identity backward; at each row-parallel output, the embedding's merge and
  the loss's sums, whose replicated result every rank backpropagates.

The gradient of a replicated leaf (a LayerNorm, ``bo``) is then the same
on every model rank, and a sharded leaf's is its slice of JAX's.

Rounding order follows JAX, which matters for bf16:
``column_parallel_dense`` rounds the fp32-accumulated product to x's dtype
and then adds the bias; ``row_parallel_dense`` sums the fp32 partials over
the model axis, adds the bias in fp32 and rounds last.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops import collective as col
from ..topology import DEFAULT_AXIS_NAME
from ._factory import P, make_global_apply, model_axis, resolve_mesh_axis


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return col.psum(g.contiguous(), ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return col.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dim; backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return col.all_gather(x, axis, axis=x.dim() - 1, tiled=True)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.axis.size
        return g.narrow(-1, col.axis_index(ctx.axis) * n, n).contiguous(), None


class _SplitToModel(torch.autograd.Function):
    """This rank's block of the last dim; backward gathers the blocks."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        n = x.shape[-1] // axis.size
        return x.narrow(-1, col.axis_index(axis) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return col.all_gather(g.contiguous(), ctx.axis, axis=g.dim() - 1,
                              tiled=True), None


def copy_to_model(x, axis_name):
    """Identity forward; backward sums the cotangent over the model axis."""
    axis = model_axis(axis_name)
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x, axis_name):
    """The sum over the model axis forward; identity backward."""
    axis = model_axis(axis_name)
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def pmax(x, axis_name):
    """The max over the model axis (not differentiable)."""
    axis = model_axis(axis_name)
    return x if axis is None else col.pmax(x, axis)


def pmin(x, axis_name):
    """The min over the model axis (not differentiable)."""
    axis = model_axis(axis_name)
    return x if axis is None else col.pmin(x, axis)


def axis_index(axis_name) -> int:
    """This rank's index along the model axis (0 without one)."""
    axis = model_axis(axis_name)
    return 0 if axis is None else col.axis_index(axis)


def axis_size(axis_name) -> int:
    axis = model_axis(axis_name)
    return 1 if axis is None else axis.size


def matmul_f32(x, w):
    """``x @ w`` accumulated and returned in fp32 (JAX's
    ``preferred_element_type=float32``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float())


def column_parallel_dense(x, kernel, bias=None, *, axis_name=None,
                          gather_output: bool = False):
    """``x @ kernel + bias`` with ``kernel (D_in, D_out/P)`` sharded on its
    output dim: the product rounded to x's dtype, then the local bias
    ``(D_out/P,)`` added.  ``x`` is replicated; ``gather_output``
    all-gathers the ``(..., D_out)`` features."""
    y = torch.matmul(copy_to_model(x, axis_name), kernel)
    if bias is not None:
        y = y + bias
    axis = model_axis(axis_name)
    if gather_output and axis is not None:
        y = _GatherFromModel.apply(y, axis)
    return y


def row_parallel_dense(x, kernel, bias=None, *, axis_name=None,
                       input_is_parallel: bool = True):
    """``psum(x_local @ kernel_local) + bias`` with ``kernel (D_in/P,
    D_out)`` sharded on its input dim; the sum and the (replicated) bias in
    fp32, rounded to x's dtype last.  With ``input_is_parallel=False``
    ``x`` is replicated ``(..., D_in)`` and each rank takes its block."""
    axis = model_axis(axis_name)
    if not input_is_parallel and axis is not None:
        x = _SplitToModel.apply(x, axis)
    y = reduce_from_model(matmul_f32(x, kernel), axis_name)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def vocab_parallel_embedding(ids, table, *, axis_name=None):
    """Embedding lookup with ``table (V/P, D)`` this rank's vocabulary
    shard, which starts at ``axis_index · V/P``: ids outside it give zero
    rows, and one sum over the model axis merges the shards."""
    vocab_per = table.shape[0]
    local = ids - axis_index(axis_name) * vocab_per
    in_range = (local >= 0) & (local < vocab_per)
    rows = table[local.clamp(0, vocab_per - 1).long()]
    rows = torch.where(in_range[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows, axis_name)


def tp_mlp(x, params, *, axis_name=None,
           activation: Optional[Callable] = None):
    """Column → activation (gelu, tanh approximation, as ``jax.nn.gelu``)
    → row: one sum over the model axis.  ``params``: ``wi (D, F/P)``,
    ``bi (F/P,)``, ``wo (F/P, D)``, replicated ``bo (D,)``."""
    act = activation or (lambda h: F.gelu(h, approximate="tanh"))
    h = column_parallel_dense(x, params["wi"], params["bi"],
                              axis_name=axis_name)
    return row_parallel_dense(act(h), params["wo"], params["bo"],
                              axis_name=axis_name)


def gather_seq_matmul(x, w, bias=None, *, axis_name):
    """Megatron-SP entry: ``x (B, S/P, D)`` sequence-sharded → ``(B, S,
    F_loc)`` through :func:`collective_matmul.all_gather_matmul` (the
    sequence gather rides the ring beside the product).  ``w`` is the
    column shard ``(D, F/P)``."""
    from .collective_matmul import all_gather_matmul

    b, s_loc, d = x.shape
    p = axis_size(axis_name)
    y = all_gather_matmul(x.reshape(b * s_loc, d), w, axis_name=axis_name)
    y = y.reshape(p, b, s_loc, -1).transpose(0, 1).reshape(
        b, p * s_loc, -1).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def matmul_scatter_seq(x, w, bias=None, *, axis_name):
    """Megatron-SP exit: ``x (B, S, F/P)`` → ``(B, S/P, D)``
    sequence-sharded through :func:`collective_matmul.matmul_reduce_scatter`
    (replaces the row-parallel sum and keeps this rank's rows); the
    replicated ``bias (D,)`` is added after the reduction (its gradient
    summed over the model axis, since each rank holds other rows)."""
    from .collective_matmul import matmul_reduce_scatter

    b, s, f = x.shape
    p = axis_size(axis_name)
    if s % p:
        raise ValueError(f"sequence {s} not divisible by axis size {p}")
    s_loc = s // p
    x2 = x.reshape(b, p, s_loc, f).transpose(0, 1).reshape(p * b * s_loc, f)
    y = matmul_reduce_scatter(x2, w, axis_name=axis_name)
    y = y.reshape(b, s_loc, -1).to(x.dtype)
    if bias is not None:
        # each rank adds it to its own rows: its gradient sums over them
        y = y + copy_to_model(bias, axis_name)
    return y


def tp_mlp_sp(x, params, *, axis_name,
              activation: Optional[Callable] = None):
    """Megatron-SP MLP over sequence-sharded ``x (B, S/P, D)``: the
    :func:`tp_mlp` params, an all-gather-matmul entry and a
    matmul-reduce-scatter exit."""
    act = activation or (lambda h: F.gelu(h, approximate="tanh"))
    h = gather_seq_matmul(x, params["wi"], params["bi"], axis_name=axis_name)
    return matmul_scatter_seq(act(h), params["wo"], params["bo"],
                              axis_name=axis_name)


def init_tp_mlp_params(rng, d_model: int, d_hidden: int,
                       dtype=torch.float32, device="cpu") -> dict:
    """GLOBAL params for :func:`tp_mlp` (He-normal weights, zero biases);
    ``rng`` is a ``torch.Generator`` or an int seed.  Shard them with
    :func:`tp_mlp_specs` (``hybrid.shard_pytree``)."""
    gen = rng if isinstance(rng, torch.Generator) \
        else torch.Generator().manual_seed(int(rng))

    def normal(n_in, n_out):
        w = torch.randn(n_in, n_out, generator=gen) * (2.0 / n_in) ** 0.5
        return w.to(device=device, dtype=dtype)

    return {"wi": normal(d_model, d_hidden),
            "bi": torch.zeros(d_hidden, dtype=dtype, device=device),
            "wo": normal(d_hidden, d_model),
            "bo": torch.zeros(d_model, dtype=dtype, device=device)}


def tp_mlp_specs(axis_name: str = DEFAULT_AXIS_NAME) -> dict:
    """The specs mapping :func:`init_tp_mlp_params`' globals onto the
    shards :func:`tp_mlp` takes."""
    return {"wi": P(None, axis_name), "bi": P(axis_name),
            "wo": P(axis_name, None), "bo": P()}


def make_tensor_parallel_mlp(mesh=None, axis_name: Optional[str] = None,
                             activation: Optional[Callable] = None):
    """Global face: ``fn(x, global_params) -> y`` over global tensors, the
    params sharded by :func:`tp_mlp_specs` and ``x`` replicated;
    differentiable end to end."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    return make_global_apply(
        lambda x, p: tp_mlp(x, p, axis_name=ax, activation=activation),
        mesh, (P(), tp_mlp_specs(ax)), P())
