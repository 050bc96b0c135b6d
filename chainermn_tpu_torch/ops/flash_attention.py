"""Flash attention, forward and backward: hand-written Hopper kernels and their plain versions.

Counterpart of ``chainermn_tpu/ops/flash_attention.py :: flash_attention``
with its custom VJP.  Layout ``(B, S, H, D)`` as in JAX; ``k``/``v`` may
carry ``H_kv`` heads with ``H % H_kv == 0`` (GQA: ``H / H_kv`` consecutive
q heads share one KV head).

:func:`flash_attention` is a ``torch.autograd.Function``.  On a CUDA tensor
its forward is ``csrc/flash_fwd.cu`` (bf16: TMA + ``wgmma`` over 128-row
q tiles; fp32: CUDA cores) and its backward ``csrc/flash_bwd.cu`` (a
``delta`` pass, then dk/dv and dq; bf16: TMA + ``wgmma``);
on a CPU tensor they are :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain`.  Both plain versions materialise the
``(B, H, S, S)`` scores and apply the JAX kernels' rules in one tile:

* forward: finite ``-1e30`` sentinel, ``p`` zeroed where masked, ``l``
  floored at ``1e-37``, ``p`` rounded to ``v``'s dtype before the PV
  product (fp32 accumulation);
* backward (``_bwd_blockwise``'s math): ``p = exp(s − lse)``, ``p`` rounded
  to ``do``'s dtype before ``dv``; ``ds = p·(dp − delta)·scale`` rounded to
  ``q``'s dtype before ``dk`` and to ``k``'s before ``dq``; GQA grads folded
  over the head group in fp32.  ``delta = rowsum(do·out) − dlse``, where
  ``dlse`` is the cotangent of the LSE output (``return_lse=True``).
"""

from __future__ import annotations

import torch

from . import _build
from ._dispatch import dispatch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)


def resolve_attn_impl(attn_impl: str, seq_len: int, head_dim: int,
                      device) -> str:
    """Resolve ``'auto'``: ``'flash'`` on a CUDA device for ``seq_len >=
    128`` and a head_dim the kernels take, ``'xla'`` (the materialising
    path) otherwise.  An explicit ``'flash'`` on a CUDA device with a
    head_dim the kernels do not take raises; explicit names otherwise pass
    through."""
    cuda = torch.device(device).type == "cuda"
    if attn_impl == "auto":
        return ("flash" if cuda and seq_len >= 128
                and head_dim in KERNEL_HEAD_DIMS else "xla")
    if attn_impl not in ("flash", "xla"):
        raise ValueError(
            f"attn_impl must be 'auto', 'xla' or 'flash', got {attn_impl!r}")
    if attn_impl == "flash" and cuda and head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attn_impl='flash' on {device}: the kernels take "
                         f"head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    return attn_impl


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants (B, S, H, D) arrays, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(
            f"q heads {h} not a multiple of kv heads {h_kv} (GQA contract)")
    if v.shape != k.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    return h // h_kv


def _causal_mask(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def flash_attention_plain(q, k, v, causal: bool = False):
    """Plain PyTorch attention with the kernel's semantics: returns
    ``(out (B, S, H, D) in q's dtype, lse (B, H, S) fp32)``."""
    group = _check(q, k, v)
    s, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    qf = q.float().transpose(1, 2)                          # (B, H, S, D)
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = None
    if causal:
        mask = _causal_mask(s, q.device)
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.matmul(p.to(v.dtype).float(), vh.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def _delta(out, do, dlse):
    """``rowsum(do·out) − dlse`` as ``(B, H, S)`` fp32 (JAX computes it
    outside its kernel too)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = False,
                              dlse=None):
    """Plain PyTorch backward with the fused kernel's rounding: returns
    ``(dq, dk, dv)`` in the dtypes of ``q, k, v``."""
    group = _check(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    delta = _delta(out, do, dlse)                          # (B, H, S)
    qh, doh = q.transpose(1, 2), do.transpose(1, 2)        # (B, H, S, D)
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)
    sc = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.exp(sc - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(s, q.device), 0.0)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doh.float())
    dp = torch.matmul(doh.float(), vh.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), kh.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh.float())

    def fold(x):                                     # (B, H, S, D) fp32
        return x.reshape(b, h // group, group, s, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            fold(dk).to(k.dtype).contiguous(),
            fold(dv).to(v.dtype).contiguous())


def _check_cuda(what, *ts):
    q = ts[0]
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the {what} kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"the {what} kernel takes q/k/v (and do) of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"the {what} kernel needs contiguous inputs")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v (and do) must be on one device")
    return _build.dtype_code(q.dtype)


def _flash_fwd_cuda(q, k, v, causal: bool, group: int):
    b, s, h, d = q.shape
    code = _check_cuda("flash", q, k, v)
    if code == 1:                     # bf16: TMA reads q, k and v
        q, k, v = (_build.tma_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd")
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, s, h, group, d,
                        code, int(bool(causal)),
                        1.0 / (d ** 0.5), _build.stream_handle(q))
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


@dispatch("flash_attention_bwd")
def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        dlse=None):
    """``(dq, dk, dv)``: the CUDA kernel (``csrc/flash_bwd.cu``) for CUDA
    tensors, :func:`flash_attention_bwd_plain` for CPU tensors."""
    group = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, dlse)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, got "
                         f"{q.device}")
    b, s, h, d = q.shape
    out, do = out.contiguous(), do.contiguous()
    code = _check_cuda("flash backward", q, k, v, out, do)
    # the kernels read q, k, v, out and do by TMA or in 16-byte loads
    q, k, v, out, do = (_build.tma_operand(x) for x in (q, k, v, out, do))
    lse = lse.float().contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    # rowsum(do·out) − dlse: the source's first launch writes it
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    lib = _build.library("flash_bwd")
    err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        None if dlse is None else dlse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), b, s, h, group, d, code,
                        int(bool(causal)), 1.0 / (d ** 0.5),
                        _build.stream_handle(q))
    _build.check(err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = False):
    """``(out, lse)`` without autograd: the CUDA kernel
    (``csrc/flash_fwd.cu``) for CUDA tensors, :func:`flash_attention_plain`
    for CPU tensors.  For callers that run their own backward through
    :func:`flash_attention_bwd` (the ring of ``parallel.ring_attention``)."""
    group = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _flash_fwd_cuda(q, k, v, causal, group)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (or plain version) with the fused backward as its
    gradient; ``lse`` is a differentiable output."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         dlse)
        return dq, dk, dv, None


@dispatch("flash_attention")
def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention over ``(B, S, H, D)``, differentiable: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors.  Returns ``out`` in
    q's dtype, plus ``lse (B, H, S)`` fp32 when ``return_lse``."""
    out, lse = _FlashAttention.apply(q, k, v, causal)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
