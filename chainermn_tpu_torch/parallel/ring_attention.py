"""Ring attention: exact attention over sequence shards, K/V rotating around the ring.

Counterpart of ``chainermn_tpu/parallel/ring_attention.py``.  Each rank
holds a sequence shard of Q/K/V; the K/V blocks rotate one hop a step
(rank ``i`` to ``i + 1``, one ``batch_isend_irecv`` posted before the
step's attention so the transfer and the compute can overlap) while
each rank folds the visiting block into its output by the log-sum-exp
merge, in fp32 with the finite ``NEG_INF = -1e30``, so an empty
accumulator or a skipped block adds an exact zero.

Each block is one attention call that returns ``(out, lse)``:
``attn_impl="flash"`` is the flash forward kernel (``csrc/flash_fwd.cu``
on a CUDA tensor, its plain version on a CPU tensor); ``"xla"`` is the
materialising plain version (the block's ``(B, H, Sq, Sk)`` scores, K/V
expanded to the q heads under GQA).  Under ``causal`` rank ``my`` takes
the block from rank ``src`` whole when ``src < my``, causal on the
diagonal (``src == my``) and not at all when ``src > my``.

JAX differentiates the ring as one ``lax.scan``.  Here the ring is one
``torch.autograd.Function`` whose backward runs the merge's backward
(each block's cotangents of ``out`` and of ``lse``), each block's
backward with that LSE cotangent (``csrc/flash_bwd.cu``'s ``dlse`` term
on a CUDA tensor), and the reverse ring that carries each K/V block's
gradient back to its owner, one hop a step.  Every rank makes the same
hops in the same order, whatever blocks it skipped.  The backward
follows the local-loss convention of ``functions/``: a rank's gradient
of its K/V shard sums every rank's use of it.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ..ops.flash_attention import (flash_attention_bwd,
                                   flash_attention_bwd_plain,
                                   flash_attention_fwd, flash_attention_plain,
                                   resolve_attn_impl)
from ..ops import collective as col
from ._factory import NEG_INF, make_sp_attention, model_axis
from .collective_matmul import _post_shift

# attn_impl -> (block forward, block backward)
_BLOCKS = {
    "flash": (flash_attention_fwd, flash_attention_bwd),
    "xla": (flash_attention_plain, flash_attention_bwd_plain),
}


def _merge(o, lse, out_t, lse_t):
    """Fold one block's ``(out_t, lse_t)`` into the fp32 accumulators
    ``o (B, Sq, H, D)`` and ``lse (B, H, Sq)``."""
    lse_new = torch.logaddexp(lse, lse_t)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_t - lse_new).transpose(1, 2)[..., None]
    return o * w_old + out_t.float() * w_new, lse_new


def _kind(src, my, causal):
    """``"full"``, ``"diag"`` or ``"skip"``: what rank ``my`` does with the
    block of rank ``src``."""
    if not causal or src < my:
        return "full"
    return "diag" if src == my else "skip"


def _fold(q, outs, lses):
    """The merged fp32 output of the blocks, in ring order."""
    b, s, h, d = q.shape
    o = q.new_zeros((b, s, h, d), dtype=torch.float32)
    lse = q.new_full((b, h, s), NEG_INF, dtype=torch.float32)
    for out_t, lse_t in zip(outs, lses):
        o, lse = _merge(o, lse, out_t, lse_t)
    return o


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, impl):
        fwd, _ = _BLOCKS[impl]
        p = 1 if axis is None else axis.size
        my = 0 if axis is None else col.axis_index(axis)
        blocks, outs, lses = [], [], []
        kv = torch.stack((k, v))
        for t in range(p):
            # the hop first: the next block's transfer does not wait on
            # this block's attention
            wait = _post_shift(kv, axis) if t + 1 < p else None
            kind = _kind((my - t) % p, my, causal)
            if kind != "skip":
                out_t, lse_t = fwd(q, kv[0], kv[1], kind == "diag")
                outs.append(out_t)
                lses.append(lse_t)
            blocks.append((kv, kind))
            if wait is not None:
                kv = wait()
        ctx.axis, ctx.impl, ctx.blocks = axis, impl, blocks
        ctx.outs, ctx.lses = outs, lses
        ctx.save_for_backward(q)
        return _fold(q, outs, lses).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        (q,) = ctx.saved_tensors
        _, bwd = _BLOCKS[ctx.impl]
        axis, blocks = ctx.axis, ctx.blocks
        outs = [o.detach().requires_grad_() for o in ctx.outs]
        lses = [x.detach().requires_grad_() for x in ctx.lses]
        ctx.blocks = ctx.outs = ctx.lses = None
        # the merge's backward: each block's cotangents of out and of lse
        with torch.enable_grad():
            y = _fold(q.detach(), outs, lses).to(q.dtype)
            grads = torch.autograd.grad(y, outs + lses, dout)
        n = len(outs)
        douts, dlses = grads[:n], grads[n:]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc, wait = None, None
        for t in reversed(range(len(blocks))):
            kv, kind = blocks[t]
            if kind == "skip":
                local = torch.zeros_like(kv)
            else:
                n -= 1              # the blocks run, in ring order
                dq_t, dk_t, dv_t = bwd(q, kv[0], kv[1], outs[n].detach(),
                                       lses[n].detach(),
                                       douts[n].contiguous(),
                                       kind == "diag", dlses[n])
                dq += dq_t.float()
                local = torch.stack((dk_t, dv_t))
            # the gradient of the block in hand: this rank's part plus the
            # later steps' parts, which came back one hop a step
            acc = local if wait is None else wait() + local
            wait = _post_shift(acc, axis, offset=-1) if t else None
        return dq.to(q.dtype), acc[0], acc[1], None, None, None


def ring_attention(q, k, v, axis_name, causal: bool = False,
                   attn_impl: str = "auto"):
    """Exact multi-head attention over a sequence-sharded axis.

    ``q (B, S_local, H, D)``, ``k, v (B, S_local, H_kv, D)``: this rank's
    shards; the global sequence is ``S_local * axis_size`` in rank order
    along ``axis_name``.  Returns this rank's output shard, q's shape and
    dtype.  ``attn_impl``: ``"flash"`` (the flash kernels on a CUDA
    tensor), ``"xla"`` (materialised scores) or ``"auto"`` (flash on a
    CUDA device once the LOCAL block fills the kernel's tiles,
    ``ops.flash_attention.resolve_attn_impl``)."""
    impl = resolve_attn_impl(attn_impl, q.shape[1], q.shape[-1], q.device)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       model_axis(axis_name), causal, impl)


def make_ring_attention(mesh=None, axis_name: Optional[str] = None,
                        causal: bool = False, attn_impl: str = "auto"):
    """Global face over GLOBAL sequence-sharded tensors (see
    ``_factory.make_sp_attention``)."""
    return make_sp_attention(partial(ring_attention, attn_impl=attn_impl), mesh,
                             axis_name, causal)


__all__ = ["make_ring_attention", "ring_attention"]
