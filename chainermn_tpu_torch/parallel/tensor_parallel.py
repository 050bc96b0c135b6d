"""Column/row-parallel dense, vocab-parallel embedding and the TP MLP, at world 1.

Counterpart of ``chainermn_tpu/parallel/tensor_parallel.py``.  This slice
runs on one card, so every weight is whole and every collective is the
identity; each all-reduce site stays a named call (:func:`psum`) so the
tensor-parallel slice knows where NCCL goes.

Rounding order follows JAX, which matters for bf16:
``column_parallel_dense`` rounds the fp32-accumulated product to x's dtype
and then adds the bias; ``row_parallel_dense`` adds the bias to the fp32
product and rounds after.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psum(x):
    """The model-axis all-reduce.  Identity at world 1."""
    return x


def pmax(x):
    """The model-axis max (the vocab-parallel loss's stable shift).
    Identity at world 1."""
    return x


def matmul_f32(x, w):
    """``x @ w`` accumulated and returned in fp32 (JAX's
    ``preferred_element_type=float32``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float())


def column_parallel_dense(x, kernel, bias=None):
    """``x @ kernel + bias``: the product rounded to x's dtype, then the
    bias added in that dtype."""
    y = torch.matmul(x, kernel)
    if bias is not None:
        y = y + bias
    return y


def row_parallel_dense(x, kernel, bias=None):
    """``psum(x @ kernel) + bias`` with the sum and bias in fp32, rounded
    to x's dtype last."""
    y = psum(matmul_f32(x, kernel))
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def vocab_parallel_embedding(ids, table):
    """Embedding lookup; ids outside the table give zero rows, and one
    psum merges the (single) shard."""
    vocab = table.shape[0]
    in_range = (ids >= 0) & (ids < vocab)
    rows = table[ids.clamp(0, vocab - 1).long()]
    rows = torch.where(in_range[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
    return psum(rows)


def tp_mlp(x, params):
    """Column → gelu (tanh approximation, as ``jax.nn.gelu``) → row."""
    h = column_parallel_dense(x, params["wi"], params["bi"])
    h = F.gelu(h, approximate="tanh")
    return row_parallel_dense(h, params["wo"], params["bo"])
