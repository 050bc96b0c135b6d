"""Decode-tick attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``chainermn_tpu/ops/decode_attention.py :: decode_attend``.
``q (B, H·hd)`` against the flat caches ``kc/vc (B, S, H·hd)``; row ``b``
attends positions ``[0, pos[b]]`` (a ``pos[b] >= S - 1`` makes the whole
row valid, as the JAX mask does).  All math is fp32 with no rounding of the
probabilities; the output is in q's dtype.

``pos`` is a Python int (broadcast to every row, the closed-batch
``lm_generate`` semantics) or an int32 tensor ``(B,)`` on q's device (the
serving tick, every slot at its own length — the per-row einsum attention
of ``chainermn_tpu/parallel/decode.py``, which computes the same function).
Positions must be >= 0.

:func:`decode_attend` runs ``csrc/decode_attention.cu`` on a CUDA tensor
and :func:`decode_attend_plain` (einsum, mask, softmax in fp32) on a CPU
tensor.  GQA decode (``decode_attend_gqa``, the beam kernel) is a later
slice.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)


def _check(q, kc, vc, n_heads: int, head_dim: int):
    if kc.dim() != 3 or vc.shape != kc.shape:
        raise ValueError(f"decode_attend wants flat (B, S, H·hd) caches, got "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    b, _, d = kc.shape
    if d != n_heads * head_dim or tuple(q.shape) != (b, d):
        raise ValueError(f"q {tuple(q.shape)} / caches {tuple(kc.shape)} do "
                         f"not match n_heads={n_heads} x head_dim={head_dim}")


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 0:
            return pos.to(device=device, dtype=torch.int64).expand(b)
        if tuple(pos.shape) != (b,):
            raise ValueError(f"per-row pos {tuple(pos.shape)} != ({b},)")
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def decode_attend_plain(q, kc, vc, pos, n_heads: int, head_dim: int):
    """Einsum + per-row mask + softmax, all in fp32."""
    _check(q, kc, vc, n_heads, head_dim)
    b, s, d = kc.shape
    p_vec = _pos_vector(pos, b, kc.device)
    q3 = q.float().view(b, n_heads, head_dim)
    k4 = kc.float().view(b, s, n_heads, head_dim)
    v4 = vc.float().view(b, s, n_heads, head_dim)
    scores = torch.einsum("bhd,bshd->bhs", q3, k4) * (1.0 / (head_dim ** 0.5))
    valid = (torch.arange(s, device=kc.device)[None, :] <= p_vec[:, None])
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bshd->bhd", p, v4)
    return ctx.reshape(b, d).to(q.dtype)


def _decode_attend_cuda(q, kc, vc, pos, n_heads: int, head_dim: int):
    b, s, d = kc.shape
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise ValueError(f"the decode kernel takes q and caches of one dtype, "
                         f"got {q.dtype}, {kc.dtype}, {vc.dtype}")
    code = _build.dtype_code(q.dtype)
    if not (q.is_contiguous() and kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("the decode kernel needs contiguous q and caches")
    if not (q.device == kc.device == vc.device):
        raise ValueError("q and the caches must be on one device")
    pos_ptr, pos_scalar = _build.pos_argument(pos, b, kc.device)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    err = lib.decode_attend(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                            out.data_ptr(), pos_ptr, pos_scalar, b, s,
                            n_heads, head_dim, code,
                            1.0 / (head_dim ** 0.5), _build.stream_handle(q))
    _build.check(err, "decode_attend")
    decode_attend.launches += 1
    return out


def decode_attend(q, kc, vc, pos, n_heads: int, head_dim: int):
    """One decode tick's attention: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns ``ctx (B, H·hd)``."""
    _check(q, kc, vc, n_heads, head_dim)
    if kc.device.type == "cpu":
        return decode_attend_plain(q, kc, vc, pos, n_heads, head_dim)
    if kc.is_cuda:
        return _decode_attend_cuda(q, kc, vc, pos, n_heads, head_dim)
    raise ValueError(f"decode_attend runs on cuda or cpu, got {kc.device}")


decode_attend.launches = 0
