"""In-place KV-cache append: a hand-written Hopper kernel and its plain version.

Counterpart of ``chainermn_tpu/ops/kv_cache.py :: cache_append``.  Writes
``k_new/v_new (B, rows, W)`` into ``kc/vc (B, S, W)`` at ``pos`` along
axis 1, where ``pos`` is a Python int or an int32 tensor ``(B,)`` (one
position per row, the serving pool's contract).  The start is clamped to
``[0, S - rows]`` exactly as ``dynamic_update_slice`` clamps (the JAX
vector path is ``vmap(dynamic_update_slice_in_dim)``): a free slot's
position drifts past the cache's end, and the clamp keeps its write inside
its own row.

The JAX function is functional and returns new arrays; this one updates
``kc``/``vc`` IN PLACE and returns them.  :func:`cache_append` runs
``csrc/kv_cache.cu`` on a CUDA tensor and :func:`cache_append_plain`
(indexed assignment with the clamp) on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build


def _check(kc, vc, k_new, v_new, axis: int):
    if axis != 1 or kc.dim() != 3:
        raise NotImplementedError(
            f"cache_append writes along axis 1 of (B, S, W) caches, got axis "
            f"{axis} of {tuple(kc.shape)}")
    b, s, w = kc.shape
    rows = k_new.shape[1]
    if vc.shape != kc.shape or k_new.shape != v_new.shape \
            or tuple(k_new.shape) != (b, rows, w) or not 1 <= rows <= s:
        raise ValueError(f"caches {tuple(kc.shape)}/{tuple(vc.shape)} and new "
                         f"rows {tuple(k_new.shape)}/{tuple(v_new.shape)} do "
                         f"not match")
    return rows


def cache_append_plain(kc, vc, k_new, v_new, pos, axis: int = 1):
    """Indexed assignment at the clamped per-row start, in place."""
    rows = _check(kc, vc, k_new, v_new, axis)
    b, s, _ = kc.shape
    if isinstance(pos, torch.Tensor):
        start = pos.to(device=kc.device, dtype=torch.int64).expand(b)
    else:
        start = torch.full((b,), int(pos), dtype=torch.int64, device=kc.device)
    start = start.clamp(0, s - rows)
    idx = start[:, None] + torch.arange(rows, device=kc.device)[None, :]
    bi = torch.arange(b, device=kc.device)[:, None]
    kc[bi, idx] = k_new.to(kc.dtype)
    vc[bi, idx] = v_new.to(vc.dtype)
    return kc, vc


def _cache_append_cuda(kc, vc, k_new, v_new, pos, rows: int):
    b, s, w = kc.shape
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("the append kernel writes contiguous caches")
    if vc.dtype != kc.dtype:
        raise ValueError(f"k and v caches differ in dtype: {kc.dtype}, "
                         f"{vc.dtype}")
    if not (kc.device == vc.device == k_new.device == v_new.device):
        raise ValueError("caches and new rows must be on one device")
    kn = k_new.to(kc.dtype).contiguous()
    vn = v_new.to(vc.dtype).contiguous()
    pos_ptr, pos_scalar = _build.pos_argument(pos, b, kc.device)
    lib = _build.library("kv_cache")
    err = lib.cache_append(kc.data_ptr(), vc.data_ptr(), kn.data_ptr(),
                           vn.data_ptr(), pos_ptr, pos_scalar, b, s, rows,
                           w * kc.element_size(), _build.stream_handle(kc))
    _build.check(err, "cache_append")
    cache_append.launches += 1
    return kc, vc


def cache_append(kc, vc, k_new, v_new, pos, axis: int = 1,
                 pos_aligned: bool = False):
    """Write the new rows at ``pos`` (clamped) in place; returns
    ``(kc, vc)``.  The CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor.  ``pos_aligned`` is JAX's promise that ``pos`` is a
    multiple of the row count; the kernel writes any clamped position, so
    it changes nothing here."""
    rows = _check(kc, vc, k_new, v_new, axis)
    if kc.device.type == "cpu":
        return cache_append_plain(kc, vc, k_new, v_new, pos, axis)
    if kc.is_cuda:
        return _cache_append_cuda(kc, vc, k_new, v_new, pos, rows)
    raise ValueError(f"cache_append runs on cuda or cpu, got {kc.device}")


cache_append.launches = 0
