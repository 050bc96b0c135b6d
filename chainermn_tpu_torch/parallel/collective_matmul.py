"""Collective matmul: the tensor-parallel collectives overlapped with the matmuls they feed.

Counterpart of ``chainermn_tpu/parallel/collective_matmul.py``:

* :func:`all_gather_matmul` — ``all_gather(x) @ w`` for row-sharded ``x``:
  a ring rotates the activation chunks, and each step multiplies the chunk
  in hand while the next one is in flight (the Megatron-SP entry of a
  column-parallel layer);
* :func:`matmul_reduce_scatter` — ``reduce_scatter(x @ w)`` for
  contraction-sharded ``x`` / ``w``: the partial products of each output
  chunk ride the ring in an fp32 accumulator, each hop in flight while the
  next chunk's product runs (the Megatron-SP exit of a row-parallel
  layer).

Each hop is one ``batch_isend_irecv`` (rank ``i`` to ``i + 1``), posted
before that step's product so the transfer and the product can overlap on
the card; a gloo group stages a card tensor through host memory.  The
product is ``torch.matmul``, as JAX computes it outside any Pallas kernel.
Both are differentiable, and the backward of each is the other's ring:
``d(all_gather_matmul)/dx`` is a ``matmul_reduce_scatter`` of the
cotangent with ``wᵀ`` and vice versa.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..observability.comm import collective as _acc
from ..ops import collective as col
from ._factory import P, make_global_apply, model_axis, resolve_mesh_axis


def _post_shift(x, axis, offset: int = 1):
    """Post one ring hop, this rank's ``x`` to rank ``i + offset``; returns
    ``wait() -> the block from rank i - offset``.  The hop is booked in the
    comm ledger as one ``ppermute`` as it is posted."""
    return _acc("ppermute", axis, x, lambda: _post_shift_now(x, axis, offset))


def _post_shift_now(x, axis, offset):
    staged = col.host_staged(axis, x)
    send = x.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    me, p = col.axis_index(axis), axis.size
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, col._peer(axis, (me + offset) % p),
                   axis.group),
        dist.P2POp(dist.irecv, recv, col._peer(axis, (me - offset) % p),
                   axis.group)])

    bufs = (send, recv)             # both stay alive until the hop ends

    def wait():
        for work in works:
            work.wait()
        got = bufs[1]
        return got.to(x.device) if staged else got

    return wait


def _ag_matmul(x, w, axis):
    """``(all_gather(x) @ w, all_gather(x))`` over the ring."""
    p, idx = axis.size, col.axis_index(axis)
    s_loc = x.shape[0]
    out = x.new_empty((p, s_loc, w.shape[1]),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    full = x.new_empty((p,) + tuple(x.shape))
    chunk = x
    for k in range(p):
        # the hop first: the next chunk's transfer does not wait on this
        # step's product
        wait = _post_shift(chunk, axis) if k + 1 < p else None
        row = (idx - k) % p          # the chunk in hand came from rank idx-k
        full[row] = chunk
        out[row] = torch.matmul(chunk, w)
        if wait is not None:
            chunk = wait()
    return out.reshape(p * s_loc, -1), full.reshape(p * s_loc, -1)


def _mm_rs(x, w, axis):
    """``reduce_scatter(x @ w)`` over the ring, summed in fp32 (or wider)."""
    p, idx = axis.size, col.axis_index(axis)
    s = x.shape[0]
    if s % p:
        raise ValueError(f"leading dim {s} not divisible by axis size {p}")
    s_loc = s // p
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    acc_dtype = torch.promote_types(torch.float32, out_dtype)
    acc, wait = None, None
    for k in range(p):
        # the accumulator of chunk j travels j+1 → j+2 → … → j; this
        # step's product runs while the previous hop is in flight
        j = (idx - 1 - k) % p
        part = torch.matmul(x[j * s_loc:(j + 1) * s_loc], w).to(acc_dtype)
        acc = part if wait is None else wait() + part
        wait = _post_shift(acc, axis) if k + 1 < p else None
    return acc.to(out_dtype)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis):
        y, full = _ag_matmul(x, w, axis)
        ctx.axis = axis
        ctx.save_for_backward(full, w)
        return y

    @staticmethod
    def backward(ctx, gy):
        full, w = ctx.saved_tensors
        gy = gy.contiguous()
        return (_mm_rs(gy, w.t(), ctx.axis),
                torch.matmul(full.t(), gy).to(w.dtype), None)


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.axis = axis
        ctx.save_for_backward(x, w)
        return _mm_rs(x, w, axis)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gy_full = _ag_matmul(gy.contiguous(), w.t(), ctx.axis)
        return gx, torch.matmul(x.t(), gy_full).to(w.dtype), None


def all_gather_matmul(x_local, w_local, *, axis_name):
    """``all_gather(x) @ w`` over the ring: ``x_local (S_loc, D)`` this
    rank's rows, ``w_local (D, F_loc)``; returns ``(P·S_loc, F_loc)``, the
    rows in rank order."""
    axis = model_axis(axis_name)
    if axis is None:
        return torch.matmul(x_local, w_local)
    return _AllGatherMatmul.apply(x_local, w_local, axis)


def matmul_reduce_scatter(x_local, w_local, *, axis_name):
    """``reduce_scatter(x @ w)`` over the ring: ``x_local (S, D_loc)`` and
    ``w_local (D_loc, F)`` hold this rank's share of the contraction;
    returns this rank's ``(S/P, F)`` rows of the sum."""
    axis = model_axis(axis_name)
    if axis is None:
        return torch.matmul(x_local, w_local)
    return _MatmulReduceScatter.apply(x_local, w_local, axis)


def make_all_gather_matmul(mesh=None, axis_name=None):
    """Global face: ``fn(x, w) -> y``; ``x`` row-sharded, ``w``
    column-sharded, ``y`` column-sharded (all rows)."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    return make_global_apply(
        lambda x, w: all_gather_matmul(x, w, axis_name=ax),
        mesh, (P(ax), P(None, ax)), P(None, ax))


def make_matmul_reduce_scatter(mesh=None, axis_name=None):
    """Global face: ``fn(x, w) -> y``; ``x`` sharded on its second
    (contraction) dim, ``w`` on its first, ``y`` row-sharded."""
    mesh, ax = resolve_mesh_axis(mesh, axis_name)
    return make_global_apply(
        lambda x, w: matmul_reduce_scatter(x, w, axis_name=ax),
        mesh, (P(None, ax), P(ax)), P(ax))
