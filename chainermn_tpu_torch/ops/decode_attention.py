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
tensor.  :func:`decode_append_attend` is the decode tick's pair
``cache_append`` then ``decode_attend`` in one launch of the same kernel
(the new K/V row written at the clamped ``pos`` and attended there);
:func:`decode_append_attend_plain` is that pair of plain versions.  In
bf16 the kernel splits each row's ``[0, pos]`` over
``decode_split_plan``'s blocks on the device (:func:`decode_split_range`),
a block taking the lanes of one group of heads (:func:`decode_groups`),
and the last block of a row's group merges the splits, through a
workspace and counters the wrapper keeps per (device, B, splits, heads,
D).

The beam kernel (``chainermn_tpu/ops/decode_attention.py ::
_beam_kernel``) is :func:`beam_attend_parts`: ``R`` query rows per cache
row (the beams of one prompt, or the ``g`` query heads that share a KV
head) over one cache segment, returned unnormalised as ``(acc, m, l)``
for :func:`merge_attend_parts`, the flash combine.  It runs
``csrc/beam_attention.cu`` on a CUDA tensor (the segment split along S
by :func:`beam_split_plan`, the splits merged in a second launch) and
:func:`beam_attend_parts_plain` on a CPU tensor.  :func:`decode_attend_gqa`
is GQA decode through it.
"""

from __future__ import annotations

import torch

from . import _build
from .kv_cache import cache_append_plain

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
DECODE_MAX_SPLITS = 64       # splits a row, at most (the merge reads each)
DECODE_TILE_BYTES = 16384    # K bytes of one tile of the ring (V alike)
DECODE_GROUP_WIDTH = 2048    # lanes a block takes, at most (a thread 8 lanes)


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


def decode_groups(n_heads: int, head_dim: int) -> int:
    """Head groups of the bf16 kernel: the fewest that split the heads
    evenly into groups of at most ``DECODE_GROUP_WIDTH`` lanes (one up to
    D 2048; 32 heads of 128: two).  A block reads its group's lanes."""
    return next(g for g in range(1, n_heads + 1) if n_heads % g == 0
                and n_heads // g * head_dim <= DECODE_GROUP_WIDTH)


def decode_tile(width: int) -> int:
    """Positions of one tile of the bf16 kernel's ring: ``DECODE_TILE_BYTES``
    of bf16 K rows of a group's ``width`` lanes (a stage holds a tile of K
    and one of V), between 1 and 64."""
    return max(1, min(64, DECODE_TILE_BYTES // (2 * width)))


def decode_split_plan(b: int, s: int, n_heads: int, head_dim: int, sms: int):
    """``(groups, n_split, tile)`` of the bf16 kernel for ``b`` rows of a
    cache of ``s`` positions and ``n_heads`` heads of ``head_dim`` on a card
    of ``sms`` SMs: as many splits a row and group as fill one wave of
    blocks, one an SM, over the grid ``(n_split, b, groups)`` (H100, 8
    slots of D 1024: 16 splits a row, 128 blocks, whose partials the last
    block of a row merges in one round of loads), at most
    ``DECODE_MAX_SPLITS`` and no more than the cache has tiles.  It reads
    neither ``pos`` nor the device: the kernel balances each row's ``[0,
    pos]`` over its splits itself (:func:`decode_split_range`)."""
    groups = decode_groups(n_heads, head_dim)
    tile = decode_tile(n_heads // groups * head_dim)
    n_split = min(DECODE_MAX_SPLITS, sms // (b * groups), -(-s // tile))
    return groups, max(1, n_split), tile


def decode_split_range(z: int, n: int, n_split: int, tile: int):
    """Positions ``[lo, hi)`` that block ``z`` of a row reads, as the
    kernel computes them from the row's ``n = min(pos, S - 1) + 1``: tiles
    ``[z·nt // n_split, (z + 1)·nt // n_split)`` of the ``nt = ceil(n /
    tile)`` tiles of ``[0, n)``, the last one ragged.  ``lo == hi`` is an
    empty split."""
    nt = -(-n // tile)
    lo = (z * nt // n_split) * tile
    hi = min(n, ((z + 1) * nt // n_split) * tile)
    return lo, max(lo, hi)


def _row_layout(x, b: int, n_heads: int, head_dim: int, what: str):
    """``(row stride, head stride)`` of the rows ``x`` (``(B, H·hd)``,
    ``(B, 1, H·hd)``, ``(B, H, hd)`` or ``(B, 1, H, hd)``), read off its
    shape and strides without making a view; None where its lanes are not
    dense."""
    shape, st = x.shape, x.stride()
    d = n_heads * head_dim
    if shape == (b, d) or shape == (b, 1, d):
        layout = st[0], head_dim * st[-1]
    elif shape == (b, n_heads, head_dim) or shape == (b, 1, n_heads, head_dim):
        layout = st[0], st[-2]
    else:
        raise ValueError(f"{what} {tuple(shape)} is not ({b}, {d}) or "
                         f"({b}, {n_heads}, {head_dim}) rows")
    return layout if st[-1] == 1 else None


def _kernel_rows(x, b: int, n_heads: int, head_dim: int, what: str, dtype):
    """``(tensor, row stride, head stride)``: the rows ``x`` in ``dtype``
    as the kernel reads them, in place where the lanes are dense and the
    base and strides 16-byte aligned (the heads of a fused QKV
    projection), else a dense aligned copy."""
    if x.dtype != dtype:
        x = x.to(dtype)
    layout = _row_layout(x, b, n_heads, head_dim, what)
    elem = x.element_size()
    if layout is None or x.data_ptr() % 16 or (layout[0] * elem) % 16 \
            or (layout[1] * elem) % 16:
        x = x.reshape(b, n_heads * head_dim).contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        layout = n_heads * head_dim, head_dim
    return x, layout[0], layout[1]


_WORKSPACE = {}


def _workspace(device, b: int, n_split: int, n_heads: int, d: int,
               groups: int):
    """The bf16 kernel's fp32 partials and zeroed (row, group) counters for
    one (device, B, splits, heads, D), which fix the groups, kept across
    calls: the kernel leaves the counters zero.  One stream at a time."""
    key = (device, b, n_split, n_heads, d)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty(b * n_split * (d + 2 * n_heads), dtype=torch.float32,
                          device=device),
              torch.zeros(b * groups, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def _decode_attend_cuda(q, kc, vc, pos, n_heads: int, head_dim: int,
                        k_new=None, v_new=None):
    """The kernel's launch.  It runs on every layer of every tick, where
    the host is the bottleneck: shapes and strides are read off the
    tensors, and nothing is copied or viewed that the kernel can read in
    place."""
    b, s, d = kc.shape
    dtype, dev = kc.dtype, kc.device
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if q.dtype != dtype or vc.dtype != dtype:
        raise ValueError(f"the decode kernel takes q and caches of one dtype, "
                         f"got {q.dtype}, {kc.dtype}, {vc.dtype}")
    code = _build.dtype_code(dtype)
    if not (kc.is_contiguous() and vc.is_contiguous()) \
            or kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("the decode kernel needs contiguous caches with "
                         "16-byte aligned bases")
    if q.device != dev or vc.device != dev or k_new is not None and (
            k_new.device != dev or v_new.device != dev):
        raise ValueError("q, the caches and the new rows must be on one device")
    q, q_rs, q_hs = _kernel_rows(q, b, n_heads, head_dim, "q", dtype)
    # the append stores the new rows in the cache's dtype
    kn = vn = None
    kn_rs = kn_hs = vn_rs = vn_hs = 0
    if k_new is not None:
        kn, kn_rs, kn_hs = _kernel_rows(k_new, b, n_heads, head_dim, "k_new",
                                        dtype)
        vn, vn_rs, vn_hs = _kernel_rows(v_new, b, n_heads, head_dim, "v_new",
                                        dtype)
    pos_ptr, pos_scalar = _build.pos_argument(pos, b, dev)
    out = torch.empty((b, d), dtype=dtype, device=dev)
    groups, n_split, tile, ws, counters = 1, 1, 1, None, None
    if code == 1:
        groups, n_split, tile = decode_split_plan(b, s, n_heads, head_dim,
                                                  _build.sm_count(dev))
        ws, counters = _workspace(dev, b, n_split, n_heads, d, groups)
    lib = _build.library("decode_attention")
    err = lib.decode_attend(
        q.data_ptr(), q_rs, q_hs, None if kn is None else kn.data_ptr(),
        kn_rs, kn_hs, None if vn is None else vn.data_ptr(), vn_rs, vn_hs,
        kc.data_ptr(), vc.data_ptr(), out.data_ptr(), pos_ptr, pos_scalar,
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), b, s, n_heads,
        head_dim, code, n_split, tile, groups, 1.0 / (head_dim ** 0.5),
        _build.stream_handle(q))
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


def _check_caches(kc, vc, n_heads: int, head_dim: int):
    if kc.dim() != 3 or vc.shape != kc.shape \
            or kc.shape[2] != n_heads * head_dim:
        raise ValueError(f"decode_append_attend wants flat (B, S, H·hd) "
                         f"caches of n_heads={n_heads} x head_dim={head_dim}, "
                         f"got {tuple(kc.shape)}, {tuple(vc.shape)}")


def decode_append_attend_plain(q, k_new, v_new, kc, vc, pos, n_heads: int,
                               head_dim: int):
    """:func:`cache_append_plain` of the new rows at ``pos``, then
    :func:`decode_attend_plain` over the updated caches."""
    _check_caches(kc, vc, n_heads, head_dim)
    b, _, d = kc.shape
    for x, what in ((q, "q"), (k_new, "k_new"), (v_new, "v_new")):
        _row_layout(x, b, n_heads, head_dim, what)
    cache_append_plain(kc, vc, k_new.reshape(b, 1, d), v_new.reshape(b, 1, d),
                       pos)
    return decode_attend_plain(q.reshape(b, d), kc, vc, pos, n_heads,
                               head_dim)


def decode_append_attend(q, k_new, v_new, kc, vc, pos, n_heads: int,
                         head_dim: int):
    """The decode tick's append and attention in one call: ``k_new/v_new``
    written into ``kc/vc`` IN PLACE at ``pos`` (clamped to ``S - 1``, as
    ``cache_append`` clamps), then ``q`` attends ``[0, pos]`` of the updated
    caches.  ``q``, ``k_new`` and ``v_new`` are ``(B, H·hd)``, ``(B, 1,
    H·hd)``, ``(B, H, hd)`` or ``(B, 1, H, hd)`` rows, read in place where
    their lanes are dense (the heads of a fused QKV projection).  One
    launch of the decode kernel on a CUDA tensor (counted under
    ``decode_attend``), the plain pair on a CPU tensor.  Returns ``ctx
    (B, H·hd)`` in q's dtype."""
    _check_caches(kc, vc, n_heads, head_dim)
    if kc.device.type == "cpu":
        return decode_append_attend_plain(q, k_new, v_new, kc, vc, pos,
                                          n_heads, head_dim)
    if kc.is_cuda:
        return _decode_attend_cuda(q, kc, vc, pos, n_heads, head_dim, k_new,
                                   v_new)
    raise ValueError(f"decode_append_attend runs on cuda or cpu, got "
                     f"{kc.device}")


# ---------------------------------------------------------------------------
# the beam kernel: several query rows per cache row, unnormalised parts
# ---------------------------------------------------------------------------

BEAM_MAX_ROWS = 16      # query rows per cache row the kernel takes
BEAM_TILE = 64          # positions per tile of the kernel's TMA ring
BEAM_BLOCKS_PER_SM = 2  # the split plan's target: blocks per SM
BEAM_MIN_SPLIT_TILES = 16  # ... once the pairs alone give half a block an SM
_MODES = {"none": 0, "amask": 1, "pos": 2}


def beam_split_plan(s: int, pairs: int, sms: int):
    """``(split_len, n_split)`` of the beam kernel for a segment of ``s``
    positions and ``pairs`` (batch row, head) pairs on a card of ``sms``
    SMs: whole 64-position tiles per split, as few as give the grid
    ``pairs · n_split`` about ``BEAM_BLOCKS_PER_SM`` blocks an SM (long
    splits stream K and V through the ring; each block pays its start and
    its merge once), the last split ragged.  Where the pairs alone give
    half a block an SM, no split is cut below ``BEAM_MIN_SPLIT_TILES``
    tiles: a shorter one spends more on its start and the merge than a
    second block an SM wins back (H100: the beam prompt, 8 tiles x 128
    pairs, runs faster whole; the window's 32 tiles in two).  Split ``z``
    reads positions ``[z · split_len, min(s, (z + 1) · split_len))``."""
    tiles = -(-s // BEAM_TILE)
    per = max(1, -(-tiles * pairs // (BEAM_BLOCKS_PER_SM * sms)))
    if 2 * pairs >= sms:
        per = max(per, min(tiles, BEAM_MIN_SPLIT_TILES))
    split_len = per * BEAM_TILE
    return split_len, -(-s // split_len)


def _tma_misaligned(x) -> bool:
    """True where TMA cannot read the segment ``x`` in place: its base or
    its batch stride is not a multiple of 16 bytes."""
    return bool(x.data_ptr() % 16
                or (x.stride(0) * x.element_size()) % 16)


def _beam_check(q, kc, vc, amask, beams: int, n_heads: int, head_dim: int):
    if kc.dim() != 3 or vc.shape != kc.shape:
        raise ValueError(f"beam_attend_parts wants flat (B, S, H·hd) cache "
                         f"segments, got {tuple(kc.shape)}, {tuple(vc.shape)}")
    b, s, d = kc.shape
    if d != n_heads * head_dim or tuple(q.shape) != (b * beams, d):
        raise ValueError(f"q {tuple(q.shape)} / segment {tuple(kc.shape)} do "
                         f"not match beams={beams} x n_heads={n_heads} x "
                         f"head_dim={head_dim}")
    if amask is not None and tuple(amask.shape) != (b, beams, s):
        raise ValueError(f"amask {tuple(amask.shape)} != ({b}, {beams}, {s})")


def _mode(amask, pos) -> str:
    return "amask" if amask is not None else (
        "none" if pos is None else "pos")


def beam_attend_parts_plain(q, kc, vc, amask=None, pos=None, *, beams: int,
                            n_heads: int, head_dim: int):
    """Einsum, mask and the segment's ``(acc, m, l)``, all in fp32."""
    _beam_check(q, kc, vc, amask, beams, n_heads, head_dim)
    b, s, d = kc.shape
    q4 = q.float().reshape(b, beams, n_heads, head_dim)
    k4 = kc.float().reshape(b, s, n_heads, head_dim)
    v4 = vc.float().reshape(b, s, n_heads, head_dim)
    scores = torch.einsum("brhd,bshd->brhs", q4, k4) * (1.0 / head_dim ** 0.5)
    mode = _mode(amask, pos)
    if mode == "amask":
        valid = (amask.float() > 0.5)[:, :, None, :]
        scores = scores.masked_fill(~valid, NEG_INF)
    elif mode == "pos":
        p_vec = _pos_vector(pos, b, kc.device)
        valid = torch.arange(s, device=kc.device)[None, :] <= p_vec[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    acc = torch.einsum("brhs,bshd->brhd", p, v4)
    return (acc.reshape(b * beams, d), m.reshape(b * beams, n_heads),
            p.sum(-1).reshape(b * beams, n_heads))


def _beam_attend_cuda(q, kc, vc, amask, pos, beams: int, n_heads: int,
                      head_dim: int):
    b, s, d = kc.shape
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the beam kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if not 1 <= beams <= BEAM_MAX_ROWS:
        raise ValueError(f"the beam kernel takes 1..{BEAM_MAX_ROWS} query rows "
                         f"per cache row, got {beams}")
    if kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise ValueError(f"the beam kernel takes q and the segment in one "
                         f"dtype, got {q.dtype}, {kc.dtype}, {vc.dtype}")
    # the segment may be a window of a longer cache (a batch stride of
    # its own); rows and lanes must be dense, and K and V laid out alike
    if kc.stride(2) != 1 or kc.stride(1) != d or vc.stride() != kc.stride():
        raise ValueError(f"the beam kernel needs (B, S, D) segments with "
                         f"dense rows and one layout, got strides "
                         f"{kc.stride()} and {vc.stride()}")
    if not q.is_contiguous():
        raise ValueError("the beam kernel needs a contiguous q")
    if not (q.device == kc.device == vc.device):
        raise ValueError("q and the segment must be on one device")
    code = _build.dtype_code(q.dtype)
    if _tma_misaligned(kc) or _tma_misaligned(vc):    # copy both: one layout
        kc, vc = (x.clone(memory_format=torch.contiguous_format)
                  for x in (kc, vc))
    if q.data_ptr() % 16:     # the kernel reads q's rows in aligned words
        q = q.clone()
    mode = _mode(amask, pos)
    mask_ptr, pos_ptr, pos_scalar = None, None, 0
    if mode == "amask":
        if amask.dtype not in (torch.bool, torch.int8):
            amask = amask > 0.5
        if amask.device != kc.device:
            raise ValueError("amask must be on the segment's device")
        amask = amask.contiguous()
        mask_ptr = amask.data_ptr()
    elif mode == "pos":
        pos_ptr, pos_scalar = _build.pos_argument(pos, b, kc.device)
    acc = torch.empty((b * beams, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b * beams, n_heads), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    split_len, n_split = beam_split_plan(s, b * n_heads,
                                         _build.sm_count(q.device))
    # the splits' (acc, m, l), merged by the source's second launch
    ws = (torch.empty(n_split * b * beams * (d + 2 * n_heads),
                      dtype=torch.float32, device=q.device)
          if n_split > 1 else None)
    lib = _build.library("beam_attention")
    err = lib.beam_attend(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), mask_ptr,
                          pos_ptr, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                          None if ws is None else ws.data_ptr(), pos_scalar,
                          _MODES[mode], b, s, n_heads, beams, head_dim, code,
                          kc.stride(0) if b > 1 else s * d, split_len,
                          n_split, 1.0 / (head_dim ** 0.5),
                          _build.stream_handle(q))
    _build.check(err, "beam_attend")
    beam_attend_parts.launches += 1
    return acc, m, l


def beam_attend_parts(q, kc, vc, amask=None, pos=None, *, beams: int,
                      n_heads: int, head_dim: int):
    """One cache SEGMENT of beam attention, unnormalised.

    ``q (B·beams, H·hd)``: rows ``[b·beams, (b+1)·beams)`` attend row ``b``
    of the segment ``kc/vc (B, S, H·hd)`` (any batch stride: a window of a
    longer cache is read in place).  Mask modes: ``amask (B, beams, S)``,
    any 0/1 dtype, valid where > 0.5; ``pos`` (a Python int or an int32
    ``(B,)`` tensor), valid where the index <= pos; neither, every
    position valid.  Returns fp32 ``(acc (B·beams, D), m (B·beams, H),
    l (B·beams, H))``.  A masked score is the finite ``-1e30``, as in
    JAX: a row with no valid position yields junk that
    :func:`merge_attend_parts` cannot tell from data, so every row needs
    a valid position in some segment."""
    _beam_check(q, kc, vc, amask, beams, n_heads, head_dim)
    if kc.device.type == "cpu":
        return beam_attend_parts_plain(q, kc, vc, amask, pos, beams=beams,
                                       n_heads=n_heads, head_dim=head_dim)
    if kc.is_cuda:
        return _beam_attend_cuda(q, kc, vc, amask, pos, beams, n_heads,
                                 head_dim)
    raise ValueError(f"beam_attend_parts runs on cuda or cpu, got {kc.device}")


beam_attend_parts.launches = 0


def merge_attend_parts(parts, n_heads: int, head_dim: int, dtype):
    """Flash combine of ``(acc, m, l)`` segments into the normalised
    context ``(N, H·hd)`` in ``dtype``; an exact-zero denominator gives 0
    (JAX's ``den > 0`` guard)."""
    n = parts[0][0].shape[0]
    m = parts[0][1]
    for _, m_i, _ in parts[1:]:
        m = torch.maximum(m, m_i)
    l_tot = acc_tot = None
    for acc, m_i, l_i in parts:
        # per-head weights broadcast over the head's lanes in a view
        a = torch.exp(m_i - m)
        l_a, acc_a = l_i * a, acc.reshape(n, n_heads, head_dim) * a[..., None]
        l_tot = l_a if l_tot is None else l_tot + l_a
        acc_tot = acc_a if acc_tot is None else acc_tot + acc_a
    den = l_tot[..., None]
    ctx = torch.where(den > 0, acc_tot / den.clamp_min(1e-30), 0.0)
    return ctx.reshape(n, n_heads * head_dim).to(dtype)


def gqa_rows(q, n_kv_heads: int, g: int, head_dim: int):
    """Head-major ``(N, Hq·hd)`` queries to group-major rows ``(N·g,
    Hkv·hd)``: q-head ``h`` uses KV head ``h // g``, and row ``n·g + j``
    holds query group ``j`` of row ``n``."""
    n = q.shape[0]
    return q.reshape(n, n_kv_heads, g, head_dim).transpose(1, 2).reshape(
        n * g, n_kv_heads * head_dim)


def gqa_unrows(ctx, n_kv_heads: int, g: int, head_dim: int):
    """The inverse of :func:`gqa_rows`: ``(N·g, Hkv·hd)`` to ``(N, Hq·hd)``."""
    n = ctx.shape[0] // g
    return ctx.reshape(n, g, n_kv_heads, head_dim).transpose(1, 2).reshape(
        n, n_kv_heads * g * head_dim)


def decode_attend_gqa(q, kc, vc, pos, *, n_q_heads: int, n_kv_heads: int,
                      head_dim: int):
    """GQA decode tick: ``q (B, Hq·hd)`` head-major against the
    shared-KV-head caches ``kc/vc (B, S, Hkv·hd)``, positions past ``pos``
    (int or int32 ``(B,)``) masked.  The ``g`` query groups of a batch row
    are the beam kernel's rows of that cache row, so the cache is read
    once.  Returns ``ctx (B, Hq·hd)`` in q's dtype."""
    g = n_q_heads // n_kv_heads
    if n_q_heads % n_kv_heads or g < 1:
        raise ValueError(f"bad head ratio {n_q_heads}/{n_kv_heads}")
    part = beam_attend_parts(gqa_rows(q, n_kv_heads, g, head_dim), kc, vc,
                             None, pos, beams=g, n_heads=n_kv_heads,
                             head_dim=head_dim)
    ctx = merge_attend_parts([part], n_kv_heads, head_dim, q.dtype)
    return gqa_unrows(ctx, n_kv_heads, g, head_dim)
