"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Counterpart of ``chainermn_tpu/ops/flash_attention.py :: flash_attention``
(forward only; the fused backward comes with the training slice).  Layout
``(B, S, H, D)`` as in JAX; ``k``/``v`` may carry ``H_kv`` heads with
``H % H_kv == 0`` (GQA: ``H / H_kv`` consecutive q heads share one KV head).

:func:`flash_attention` runs the CUDA kernel (``csrc/flash_fwd.cu``) on a
CUDA tensor and :func:`flash_attention_plain` on a CPU tensor.  The plain
version materialises the ``(B, H, S, S)`` scores and applies the JAX
kernel's masking rules in one tile: finite ``-1e30`` sentinel, ``p``
zeroed where masked, ``l`` floored at ``1e-37``, ``p`` rounded to ``v``'s
dtype before the PV product (fp32 accumulation).
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)


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
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.matmul(p.to(v.dtype).float(), vh.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def _flash_fwd_cuda(q, k, v, causal: bool, group: int):
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash kernel takes q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    code = _build.dtype_code(q.dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel needs contiguous q, k and v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
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


def flash_attention(q, k, v, causal: bool = False, return_lse: bool = False):
    """Attention forward over ``(B, S, H, D)``: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  Returns ``out`` in q's
    dtype, plus ``lse (B, H, S)`` fp32 when ``return_lse``."""
    group = _check(q, k, v)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal)
    elif q.is_cuda:
        out, lse = _flash_fwd_cuda(q, k, v, causal, group)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
