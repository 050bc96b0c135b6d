"""Fused softmax cross-entropy over a large vocabulary: hand-written Hopper kernels and their plain versions.

Counterpart of ``chainermn_tpu/ops/fused_ce.py``: :func:`ce_stats`,
:func:`ce_grads` and the differentiable :func:`fused_cross_entropy`.  With
``s = h @ table.T`` (fp32 sums):

* ``ce_stats(h (T, D), table (V, D), targets (T,))`` → ``(m, l, picked)``,
  each ``(T,)`` fp32: row max, sum of ``exp(s − m)``, and the target
  column's logit (a target outside ``[0, V)`` picks nothing);
* ``ce_grads(h, table, targets, lse, dnll)`` → ``(dh, dtable)`` with
  ``ds = (exp(s − lse) − onehot)·dnll`` rounded to the other operand's
  dtype before each product, fp32 sums, ``dh`` in h's dtype and
  ``dtable`` in the table's.

On a CUDA tensor the wrappers launch ``csrc/fused_ce.cu``, which never
stores a logit: in bf16 ``ce_stats`` is one tensor-core GEMM whose
epilogue reduces each 128 x 256 logits tile to per-row statistics, merged
across V tiles by a second launch (:func:`_stats_plan`), and the
gradients go through ``ce_grads``'s GEMMs, which make ``ds`` one V chunk
at a time (:func:`_grad_plan`: at most 32 MiB, so that it stays in the
L2); fp32 keeps the CUDA-core ``ce_stats`` / ``ce_dh`` / ``ce_dtable``
kernels.  On a CPU tensor the wrappers take the
plain versions, which materialise the ``(T, V)`` logits as JAX's
``_stats_xla`` / ``_grads_xla`` do.
"""

from __future__ import annotations

import torch

from . import _build

_TILE = 64              # the CUDA-core kernels' logits tile, both axes
_TARGET_BLOCKS = 528    # ~4 resident blocks on each of the H100's 132 SMs
_GRAD_TILE = 128        # the bf16 GEMMs' M tile: the V chunk is a multiple
_DS_TILE = 256          # the ds pass's and bf16 ce_stats' N tile
# what the bf16 GEMMs re-read (the ds chunk, h in ce_stats) stays in the
# H100's 50 MB L2 at this size
_L2_BYTES = 32 << 20


def _check(h, table, targets):
    if h.dim() != 2 or table.dim() != 2 or h.shape[1] != table.shape[1]:
        raise ValueError(f"fused CE wants h (T, D) and table (V, D), got "
                         f"{tuple(h.shape)} and {tuple(table.shape)}")
    if tuple(targets.shape) != (h.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} do not match "
                         f"h {tuple(h.shape)}")


def _logits(h, table):
    return torch.matmul(h.float(), table.float().t())      # (T, V) fp32


def _onehot(targets, v, device):
    return targets.long()[:, None] == torch.arange(v, device=device)[None, :]


def ce_stats_plain(h, table, targets):
    """``_stats_xla``: materialised logits, then max, sum-exp and pick."""
    _check(h, table, targets)
    logits = _logits(h, table)
    m = logits.amax(-1)
    l = torch.exp(logits - m[:, None]).sum(-1)
    onehot = _onehot(targets, table.shape[0], h.device)
    p = torch.where(onehot, logits, torch.zeros((), device=h.device)).sum(-1)
    return m, l, p


def _ds_plain(h, table, targets, lse, dnll):
    """``(exp(s − lse) − onehot)·dnll`` in fp32, materialised ``(T, V)``."""
    _check(h, table, targets)
    logits = _logits(h, table)
    onehot = _onehot(targets, table.shape[0], h.device).float()
    return (torch.exp(logits - lse.float()[:, None]) - onehot) \
        * dnll.float()[:, None]


def _dh_from(ds, h, table):
    return torch.matmul(ds.to(table.dtype).float(), table.float()).to(h.dtype)


def _dtable_from(ds, h, table):
    return torch.matmul(ds.to(h.dtype).float().t(),
                        h.float()).to(table.dtype)


def ce_dh_plain(h, table, targets, lse, dnll):
    """``dh`` alone, as ``_grads_xla`` computes it."""
    return _dh_from(_ds_plain(h, table, targets, lse, dnll), h, table)


def ce_dtable_plain(h, table, targets, lse, dnll):
    """``dtable`` alone, as ``_grads_xla`` computes it."""
    return _dtable_from(_ds_plain(h, table, targets, lse, dnll), h, table)


def ce_grads_plain(h, table, targets, lse, dnll):
    """``_grads_xla``: materialised ``ds``, then the two products."""
    ds = _ds_plain(h, table, targets, lse, dnll)
    return _dh_from(ds, h, table), _dtable_from(ds, h, table)


def _tiles_per_split(n_blocks: int, n_tiles: int) -> int:
    """Tiles each block walks along the split axis, so that about
    ``_TARGET_BLOCKS`` blocks run and every split is non-empty."""
    want = max(1, min(n_tiles, -(-_TARGET_BLOCKS // n_blocks)))
    return -(-n_tiles // want)


def _cuda_args(h, table, targets):
    _check(h, table, targets)
    if table.dtype != h.dtype:
        raise ValueError(f"the fused CE kernels take h and table of one "
                         f"dtype, got {h.dtype}, {table.dtype}")
    code = _build.dtype_code(h.dtype)
    if not (h.is_contiguous() and table.is_contiguous()):
        raise ValueError("the fused CE kernels need contiguous h and table")
    if not (h.device == table.device == targets.device):
        raise ValueError("h, table and targets must be on one device")
    return code, targets.to(torch.int32).contiguous()


def _cuda_rows(x, device):
    return x.to(device=device, dtype=torch.float32).contiguous()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stats_plan(t: int, v: int, d: int, dtype) -> dict:
    """What ``ce_stats`` is told, all of it decided here and checked in C.
    V goes in ``parts`` parts of ``per`` tiles of ``tile_v`` columns, each
    part's ``(m, l, picked)`` in a ``(3, parts, T)`` fp32 workspace that a
    second launch merges in a fixed order.  fp32 (the CUDA-core kernel): 64-wide
    tiles, ``per`` of them a block so that about ``_TARGET_BLOCKS`` blocks
    run.  bf16 (the ``wgmma`` GEMM): one part per 256-wide tile, D padded to
    ``d_pad``, a multiple of 8 (TMA's 16-byte row strides; zero columns add
    nothing to a logit); C launches its T tiles fastest, so that the blocks
    in flight share a table tile and h stays in the L2."""
    if dtype != torch.bfloat16:
        n_v = -(-v // _TILE)
        per = _tiles_per_split(-(-t // _TILE), n_v)
        return {"d_pad": d, "tile_v": _TILE, "per": per,
                "parts": -(-n_v // per)}
    return {"d_pad": _round_up(d, 8), "tile_v": _DS_TILE, "per": 1,
            "parts": -(-v // _DS_TILE)}


def _ce_stats_cuda(h, table, targets):
    code, tgt = _cuda_args(h, table, targets)
    t, d = h.shape
    v = table.shape[0]
    plan = _stats_plan(t, v, d, h.dtype)
    if code:                             # TMA: padded D, aligned bases
        h = _build.tma_operand(h, plan["d_pad"])
        table = _build.tma_operand(table, plan["d_pad"])
    out = torch.empty((3, t), dtype=torch.float32, device=h.device)
    work = torch.empty((3, plan["parts"], t), dtype=torch.float32,
                       device=h.device)
    err = _build.library("fused_ce").ce_stats(
        h.data_ptr(), table.data_ptr(), tgt.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), work.data_ptr(), t, v,
        plan["d_pad"], plan["tile_v"], plan["per"], plan["parts"], code,
        _build.stream_handle(h))
    _build.check(err, "ce_stats")
    ce_stats.launches += 1
    return out[0], out[1], out[2]


def _grad_plan(t: int, v: int, d: int, dtype, chunk=None) -> dict:
    """How ``ce_grads`` walks V in bf16: the chunk width ``chunk`` (a
    multiple of 128, at most V rounded up to 128; by default the widest
    whose ``(T, chunk)`` bf16 ``ds`` fits 32 MiB), the chunks' ``(v0, v1)``
    bounds, the ``ds`` workspace ``(T, ld)`` (``ld``: the chunk rounded up
    to 256) and the fp32 dh accumulator ``(T, D)`` (``None`` with one
    chunk).  ``chunk`` overrides the width (for tests).  ``d_pad``: the
    width the kernels see; TMA needs 16-byte row strides, so bf16 pads D
    to a multiple of 8 with zero columns (they add nothing to the logits
    and are dropped from dh and dtable)."""
    if chunk is None:
        chunk = max(_GRAD_TILE,
                    _L2_BYTES // (2 * t) // _GRAD_TILE * _GRAD_TILE)
    elif chunk < _GRAD_TILE or chunk % _GRAD_TILE:
        raise ValueError(f"the V chunk must be a positive multiple of "
                         f"{_GRAD_TILE}, got {chunk}")
    chunk = min(chunk, _round_up(v, _GRAD_TILE))
    bounds = [(v0, min(v, v0 + chunk)) for v0 in range(0, v, chunk)]
    d_pad = _round_up(d, 8) if dtype == torch.bfloat16 else d
    return {"chunk": chunk, "bounds": bounds, "d_pad": d_pad,
            "ds_shape": (t, _round_up(chunk, _DS_TILE)),
            "acc_shape": (t, d_pad) if len(bounds) > 1 else None}


def _grads_f32_cuda(fn_name, h, table, tgt, ls, dn):
    """One fp32 gradient through the CUDA-core split kernels."""
    t, d = h.shape
    v = table.shape[0]
    n_t, n_v = -(-t // _TILE), -(-v // _TILE)
    if fn_name == "ce_dh":           # blocks over T, V split
        per = _tiles_per_split(n_t, n_v)
        rows, n_split, out = t, -(-n_v // per), torch.empty_like(h)
    else:                            # blocks over V, T split
        per = _tiles_per_split(n_v, n_t)
        rows, n_split, out = v, -(-n_t // per), torch.empty_like(table)
    work = torch.empty((n_split, rows, d), dtype=torch.float32,
                       device=h.device)
    err = getattr(_build.library("fused_ce"), fn_name)(
        h.data_ptr(), table.data_ptr(), tgt.data_ptr(), ls.data_ptr(),
        dn.data_ptr(), out.data_ptr(), work.data_ptr(), t, v, d, per, 0,
        _build.stream_handle(h))
    _build.check(err, fn_name)
    return out


def _grads_cuda(h, table, targets, lse, dnll, want_dh, want_dtable):
    """``(dh or None, dtable or None)`` on the card: fp32 through the
    CUDA-core kernels, bf16 through one ``ce_grads`` call that shares each
    chunk's ``ds`` between the two products."""
    code, tgt = _cuda_args(h, table, targets)
    ls, dn = _cuda_rows(lse, h.device), _cuda_rows(dnll, h.device)
    if code == 0:
        return (_grads_f32_cuda("ce_dh", h, table, tgt, ls, dn)
                if want_dh else None,
                _grads_f32_cuda("ce_dtable", h, table, tgt, ls, dn)
                if want_dtable else None)
    t, d = h.shape
    v = table.shape[0]
    plan = _grad_plan(t, v, d, h.dtype)
    dp = plan["d_pad"]
    hk, tk = _build.tma_operand(h, dp), _build.tma_operand(table, dp)
    ds_bytes = _round_up(2 * plan["ds_shape"][0] * plan["ds_shape"][1], 256)
    acc_bytes = 0
    if want_dh and plan["acc_shape"] is not None:
        acc_bytes = 4 * plan["acc_shape"][0] * plan["acc_shape"][1]
    work = torch.empty(ds_bytes + acc_bytes, dtype=torch.uint8,
                       device=h.device)
    dh = torch.empty_like(hk) if want_dh else None
    dtable = torch.empty_like(tk) if want_dtable else None
    err = _build.library("fused_ce").ce_grads(
        hk.data_ptr(), tk.data_ptr(), tgt.data_ptr(), ls.data_ptr(),
        dn.data_ptr(), None if dh is None else dh.data_ptr(),
        None if dtable is None else dtable.data_ptr(), work.data_ptr(), t, v,
        dp, plan["chunk"], code, _build.stream_handle(h))
    _build.check(err, "ce_grads")
    if dp != d:                          # drop the pad columns
        dh = None if dh is None else dh[:, :d].contiguous()
        dtable = None if dtable is None else dtable[:, :d].contiguous()
    return dh, dtable


def _is_cuda(h, what):
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {h.device}")
    return h.device.type == "cuda"


def ce_dh(h, table, targets, lse, dnll):
    """``dh (T, D)`` in h's dtype: the bf16 GEMMs or the fp32 ``ce_dh``
    kernel on CUDA, the plain version on the CPU."""
    if not _is_cuda(h, "ce_dh"):
        return ce_dh_plain(h, table, targets, lse, dnll)
    out, _ = _grads_cuda(h, table, targets, lse, dnll, True, False)
    ce_dh.launches += 1
    return out


def ce_dtable(h, table, targets, lse, dnll):
    """``dtable (V, D)`` in the table's dtype: the bf16 GEMMs or the fp32
    ``ce_dtable`` kernel on CUDA, the plain version on the CPU."""
    if not _is_cuda(h, "ce_dtable"):
        return ce_dtable_plain(h, table, targets, lse, dnll)
    _, out = _grads_cuda(h, table, targets, lse, dnll, False, True)
    ce_dtable.launches += 1
    return out


def ce_stats(h, table, targets):
    """``(m, l, picked)``, each ``(T,)`` fp32, without materialising the
    logits on CUDA.  Not differentiable: use :func:`fused_cross_entropy`."""
    if _is_cuda(h, "ce_stats"):
        return _ce_stats_cuda(h, table, targets)
    return ce_stats_plain(h, table, targets)


def ce_grads(h, table, targets, lse, dnll):
    """``(dh, dtable)`` for the per-row NLL cotangent ``dnll (T,)`` given
    the (possibly globally combined) ``lse (T,)``.  On CUDA one pass: in
    bf16 each chunk's ``ds`` feeds both products.  Counts one ``ce_dh``
    and one ``ce_dtable`` launch."""
    if not _is_cuda(h, "ce_grads"):
        return ce_grads_plain(h, table, targets, lse, dnll)
    dh, dtable = _grads_cuda(h, table, targets, lse, dnll, True, True)
    ce_dh.launches += 1
    ce_dtable.launches += 1
    return dh, dtable


def _local_combine(m, l, picked):
    """One vocabulary shard holds the whole row: ``(lse, picked)``."""
    return m + torch.log(l), picked


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, targets, combine, dh_axis):
        lse, picked = combine(*ce_stats(h, table, targets))
        ctx.dh_axis = dh_axis
        ctx.save_for_backward(h, table, targets, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, dnll):
        h, table, targets, lse = ctx.saved_tensors
        dh, dtable = ce_grads(h, table, targets, lse, dnll)
        if ctx.dh_axis is not None:
            # every vocabulary shard's share of dh, summed in fp32 and cast
            # back (JAX's _fused_vp_nll_bwd); dtable stays this shard's
            from . import collective as col
            dh = col.psum(dh.float(), ctx.dh_axis).to(h.dtype)
        return dh, dtable, None, None, None


def fused_cross_entropy(h, table, targets, combine=_local_combine,
                        dh_axis=None):
    """Per-row NLL ``(T,)`` of ``softmax(h @ table.T)`` at ``targets``,
    differentiable in ``h`` and ``table``.  ``combine(m, l, picked)`` turns
    this shard's stats into the row's ``(lse, picked)``; the default is the
    single-shard form, and ``parallel.transformer.vocab_parallel_logits_loss``
    passes the vocab-parallel one, with the model axis (a 1-D
    ``topology.Mesh``) as ``dh_axis``, over which the backward sums ``dh``.
    The backward starts from that ``lse``."""
    return _FusedCrossEntropy.apply(h, table, targets, combine, dh_axis)


ce_stats.launches = 0
ce_dh.launches = 0
ce_dtable.launches = 0
