"""Port ops vs the JAX package's kernels, on the CPU.

The same numpy inputs (seeded) go through ``chainermn_tpu.ops`` (Pallas in
interpret mode, or the XLA paths the JAX package itself runs off-TPU) and
through ``chainermn_tpu_torch.ops``, whose wrappers take their plain
PyTorch versions for CPU tensors.  Tolerances: fp32 atol 1e-5 (the plain
flash version is one tile where the kernel is online over tiles, so sums
differ in order only; gradients 2e-5, since they chain three such
products); bf16 atol/rtol 2e-2 (8 mantissa bits); the append is a copy and
must be exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import decode_attention as jax_da
from chainermn_tpu.ops.decode_attention import decode_attend as jax_decode_attend
from chainermn_tpu.ops import fused_ce as jax_ce
from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu.ops.kv_cache import cache_append as jax_cache_append
from chainermn_tpu_torch import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 0.0),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}


def _both(x, dtype_name):
    jd, td, _, _ = DTYPES[dtype_name]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _close(t, j, dtype_name, atol=None):
    _, _, a, r = DTYPES[dtype_name]
    got = t.float().numpy()
    want = np.asarray(jnp.asarray(j, jnp.float32))
    np.testing.assert_allclose(got, want, atol=a if atol is None else atol,
                               rtol=r)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("seq", [37, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_matches_jax(causal, seq, group, dtype_name):
    rng = np.random.RandomState(seq + 10 * group + int(causal))
    b, h, d = 2, 4, 8
    q = rng.randn(b, seq, h, d).astype(np.float32)
    k = rng.randn(b, seq, h // group, d).astype(np.float32)
    v = rng.randn(b, seq, h // group, d).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, dtype_name) for x in (q, k, v))
    out_j, lse_j = jax_flash(qj, kj, vj, causal=causal, return_lse=True,
                             interpret=True)
    before = ops.flash_attention.launches
    out_t, lse_t = ops.flash_attention(qt, kt, vt, causal=causal,
                                       return_lse=True)
    assert ops.flash_attention.launches == before   # CPU: plain version
    assert out_t.dtype == qt.dtype and tuple(out_t.shape) == q.shape
    assert lse_t.dtype == torch.float32 and tuple(lse_t.shape) == (b, h, seq)
    _close(out_t, out_j, dtype_name)
    _close(lse_t, lse_j, dtype_name)
    # without return_lse only the output comes back
    only = ops.flash_attention(qt, kt, vt, causal=causal)
    assert torch.equal(only, out_t)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("seq", [40, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_jax(causal, seq, group, dtype_name):
    """dq, dk, dv through the port's autograd Function (plain backward on
    the CPU) vs ``jax.vjp`` of the JAX flash attention with the fused
    Pallas backward in interpret mode."""
    rng = np.random.RandomState(100 + seq + 10 * group + int(causal))
    b, h, d = 2, 4, 8
    arrays = [rng.randn(b, seq, h, d), rng.randn(b, seq, h // group, d),
              rng.randn(b, seq, h // group, d), rng.randn(b, seq, h, d)]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _both(x.astype(np.float32), dtype_name) for x in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, interpret=True, backward="pallas"), qj, kj, vj)
    want = vjp(doj)
    leaves = [x.requires_grad_() for x in (qt, kt, vt)]
    out = ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    before = ops.flash_attention_bwd.launches
    got = torch.autograd.grad(out, leaves, dot)
    assert ops.flash_attention_bwd.launches == before   # CPU: plain version
    tol = 2e-5 if dtype_name == "float32" else None
    for name, g, w, x in zip("qkv", got, want, leaves):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        _close(g, w, dtype_name, atol=tol) if tol is None else \
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                       rtol=tol, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_cotangent_matches_jax(causal):
    """``return_lse=True``: the LSE cotangent folds into delta."""
    rng = np.random.RandomState(7 + int(causal))
    b, s, h, d = 2, 48, 4, 8
    q, k, v, do = (rng.randn(b, s, h if i in (0, 3) else 2, d).astype(
        np.float32) for i in range(4))
    dlse = rng.randn(b, h, s).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, interpret=True, backward="pallas",
        return_lse=True), *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = ops.flash_attention(*leaves, causal=causal, return_lse=True)
    # the lse alone carries a gradient too
    only = torch.autograd.grad(lse.sum(), leaves[0], retain_graph=True)[0]
    assert torch.isfinite(only).all() and only.abs().sum() > 0
    got = torch.autograd.grad((out, lse), leaves,
                              (torch.tensor(do), torch.tensor(dlse)))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name}")


def test_resolve_attn_impl():
    assert ops.resolve_attn_impl("auto", 1024, 128, "cpu") == "xla"
    assert ops.resolve_attn_impl("flash", 16, 8, "cpu") == "flash"
    assert ops.resolve_attn_impl("xla", 1024, 128, "cpu") == "xla"
    with pytest.raises(ValueError, match="attn_impl"):
        ops.resolve_attn_impl("pallas", 16, 8, "cpu")


def test_flash_rejects_bad_gqa():
    q = torch.zeros(1, 8, 4, 8)
    k = torch.zeros(1, 8, 3, 8)
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q, k, k)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

B, S, H, HD = 2, 16, 4, 8


def _decode_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H * HD).astype(np.float32),
            rng.randn(B, S, H * HD).astype(np.float32),
            rng.randn(B, S, H * HD).astype(np.float32))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 7, 15, 40])
def test_decode_scalar_pos_matches_pallas(pos, dtype_name):
    q, kc, vc = _decode_inputs(pos)
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, dtype_name) for x in (q, kc, vc))
    want = jax_decode_attend(qj, kj, vj, pos, n_heads=H, head_dim=HD,
                             interpret=True)
    got = ops.decode_attend(qt, kt, vt, pos, n_heads=H, head_dim=HD)
    assert got.dtype == qt.dtype
    _close(got, want, dtype_name)


def _jax_per_row_attend(q, kc, vc, pos):
    """The per-row einsum attention of chainermn_tpu/parallel/decode.py
    (serving tick, s_q = 1, h_q == h_kv), written out on jnp."""
    n, total = kc.shape[0], kc.shape[1]
    kc4 = kc.reshape(n, total, H, HD)
    vc4 = vc.reshape(n, total, H, HD)
    valid = (pos[:, None] + jnp.arange(1) + 1)[:, None, None, :, None]
    q5 = q.reshape(n, 1, H, 1, HD)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", q5, kc4,
                   preferred_element_type=jnp.float32) / (HD ** 0.5)
    mask = jnp.arange(total)[None, None, None, None, :] < valid
    p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    ctx = jnp.einsum("bhgqk,bkhd->bqhgd", p.astype(vc4.dtype), vc4,
                     preferred_element_type=jnp.float32)
    return ctx.reshape(n, H * HD)


@pytest.mark.parametrize("pos", [[0, 9], [15, 3], [4, 100]])
def test_decode_per_row_pos_matches_einsum_path(pos):
    q, kc, vc = _decode_inputs(sum(pos))
    want = _jax_per_row_attend(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(pos, jnp.int32))
    got = ops.decode_attend(torch.tensor(q), torch.tensor(kc),
                            torch.tensor(vc), torch.tensor(pos, dtype=torch.int32),
                            n_heads=H, head_dim=HD)
    _close(got, want, "float32")


def test_decode_int_pos_broadcasts_like_vector():
    q, kc, vc = (torch.tensor(x) for x in _decode_inputs(3))
    a = ops.decode_attend(q, kc, vc, 6, n_heads=H, head_dim=HD)
    b = ops.decode_attend(q, kc, vc, torch.tensor([6, 6], dtype=torch.int32),
                          n_heads=H, head_dim=HD)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# beam attention (the beam kernel), its merge and GQA decode
# ---------------------------------------------------------------------------

BH, BHD, BS = 4, 16, 24


def _beam_inputs(seed, beams, s=BS, h=BH):
    rng = np.random.RandomState(seed)
    d = h * BHD
    q = rng.randn(2 * beams, d).astype(np.float32)
    kc, vc = (rng.randn(2, s, d).astype(np.float32) for _ in range(2))
    amask = (rng.rand(2, beams, s) > 0.4).astype(np.int8)
    amask[:, :, 0] = 1             # every row keeps a valid position
    return q, kc, vc, amask


def _close_parts(got, want, dtype_name):
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32, name
        tol = 1e-5 if dtype_name == "float32" else 2e-2
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("beams", [2, 4])
@pytest.mark.parametrize("mode", ["none", "amask", "pos"])
def test_beam_attend_parts_matches_pallas(mode, beams, dtype_name):
    """``(acc, m, l)`` of one segment vs the Pallas beam kernel in
    interpret mode, in each mask mode."""
    q, kc, vc, amask = _beam_inputs(beams, beams)
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, dtype_name) for x in (q, kc, vc))
    kw = dict(beams=beams, n_heads=BH, head_dim=BHD)
    jm, tm, pos = None, None, None
    if mode == "amask":
        jm, tm = jnp.asarray(amask), torch.tensor(amask)
    if mode == "pos":
        pos = 13
    want = jax_da.beam_attend_parts(qj, kj, vj, jm, pos, block_s=8,
                                    interpret=True, **kw)
    before = ops.beam_attend_parts.launches
    got = ops.beam_attend_parts(qt, kt, vt, tm, pos, **kw)
    assert ops.beam_attend_parts.launches == before   # CPU: plain version
    _close_parts(got, want, dtype_name)


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int8,
                                        torch.float32])
def test_beam_amask_any_01_dtype(mask_dtype):
    q, kc, vc, amask = (torch.tensor(x) for x in _beam_inputs(5, 3))
    kw = dict(beams=3, n_heads=BH, head_dim=BHD)
    ref = ops.beam_attend_parts(q, kc, vc, amask, **kw)
    got = ops.beam_attend_parts(q, kc, vc, amask.to(mask_dtype), **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_beam_two_segment_merge_matches_jax(dtype_name):
    """The lazy beam tick's attention: prompt segment (mode none) and the
    ancestry-masked generated segment, merged by the flash combine."""
    q, pk, pv, _ = _beam_inputs(7, 3, s=32)
    _, gk, gv, amask = _beam_inputs(8, 3, s=24)
    (qj, qt), (pkj, pkt), (pvj, pvt), (gkj, gkt), (gvj, gvt) = (
        _both(x, dtype_name) for x in (q, pk, pv, gk, gv))
    kw = dict(beams=3, n_heads=BH, head_dim=BHD)
    want = jax_da.merge_attend_parts(
        [jax_da.beam_attend_parts(qj, pkj, pvj, block_s=16, interpret=True,
                                  **kw),
         jax_da.beam_attend_parts(qj, gkj, gvj, jnp.asarray(amask),
                                  block_s=8, interpret=True, **kw)],
        n_heads=BH, head_dim=BHD, dtype=DTYPES[dtype_name][0])
    got = ops.merge_attend_parts(
        [ops.beam_attend_parts(qt, pkt, pvt, **kw),
         ops.beam_attend_parts(qt, gkt, gvt, torch.tensor(amask), **kw)],
        BH, BHD, qt.dtype)
    assert got.dtype == qt.dtype
    _close(got, want, dtype_name)


def test_merge_zero_denominator_gives_zero():
    acc = torch.zeros(2, BH * BHD)
    m = torch.full((2, BH), -1e30)
    out = ops.merge_attend_parts([(acc, m, torch.zeros(2, BH))], BH, BHD,
                                 torch.float32)
    assert torch.equal(out, torch.zeros_like(out))


def test_beam_segment_window_is_read_in_place():
    """A live-prefix window of a longer cache (a strided view, as the lazy
    beam reads its generated slots) gives what a contiguous copy gives."""
    q, kc, vc, amask = (torch.tensor(x) for x in _beam_inputs(9, 4, s=40))
    kw = dict(beams=4, n_heads=BH, head_dim=BHD)
    win_k, win_v, win_m = kc[:, :24], vc[:, :24], amask[:, :, :24]
    assert not win_k.is_contiguous()
    got = ops.beam_attend_parts(q, win_k, win_v, win_m, **kw)
    ref = ops.beam_attend_parts(q, win_k.contiguous(), win_v.contiguous(),
                                win_m.contiguous(), **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("pos", [0, 21, 63, 90])
def test_decode_attend_gqa_matches_pallas(pos, g, dtype_name):
    rng = np.random.RandomState(pos + g)
    hkv, s = 2, 64
    q = rng.randn(2, hkv * g * BHD).astype(np.float32)
    kc, vc = (rng.randn(2, s, hkv * BHD).astype(np.float32) for _ in range(2))
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, dtype_name) for x in (q, kc, vc))
    kw = dict(n_q_heads=hkv * g, n_kv_heads=hkv, head_dim=BHD)
    want = jax_da.decode_attend_gqa(qj, kj, vj, pos, block_s=16,
                                    interpret=True, **kw)
    got = ops.decode_attend_gqa(qt, kt, vt, pos, **kw)
    assert got.dtype == qt.dtype and tuple(got.shape) == q.shape
    _close(got, want, dtype_name)


def _jax_per_row_gqa(q, kc, vc, pos, hkv, g):
    """The serving tick's per-row einsum attention of
    chainermn_tpu/parallel/decode.py for a GQA cache (s_q = 1), on jnp."""
    n, total = kc.shape[0], kc.shape[1]
    kc4 = kc.reshape(n, total, hkv, BHD)
    vc4 = vc.reshape(n, total, hkv, BHD)
    valid = (pos[:, None] + 1)[:, None, None, :, None]
    q5 = q.reshape(n, 1, hkv, g, BHD)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", q5, kc4,
                   preferred_element_type=jnp.float32) / (BHD ** 0.5)
    mask = jnp.arange(total)[None, None, None, None, :] < valid
    p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    ctx = jnp.einsum("bhgqk,bkhd->bqhgd", p, vc4,
                     preferred_element_type=jnp.float32)
    return ctx.reshape(n, hkv * g * BHD)


@pytest.mark.parametrize("pos", [[0, 30], [63, 5], [17, 200]])
def test_decode_attend_gqa_per_row_pos_matches_einsum_tick(pos):
    rng = np.random.RandomState(sum(pos))
    hkv, g, s = 2, 4, 64
    q = rng.randn(2, hkv * g * BHD).astype(np.float32)
    kc, vc = (rng.randn(2, s, hkv * BHD).astype(np.float32) for _ in range(2))
    want = _jax_per_row_gqa(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(pos, jnp.int32), hkv, g)
    got = ops.decode_attend_gqa(torch.tensor(q), torch.tensor(kc),
                                torch.tensor(vc),
                                torch.tensor(pos, dtype=torch.int32),
                                n_q_heads=hkv * g, n_kv_heads=hkv,
                                head_dim=BHD)
    _close(got, want, "float32")


def test_beam_rejects_bad_shapes():
    q, kc, vc, amask = (torch.tensor(x) for x in _beam_inputs(1, 2))
    with pytest.raises(ValueError, match="beams"):
        ops.beam_attend_parts(q, kc, vc, beams=3, n_heads=BH, head_dim=BHD)
    with pytest.raises(ValueError, match="amask"):
        ops.beam_attend_parts(q, kc, vc, amask[:, :1], beams=2, n_heads=BH,
                              head_dim=BHD)
    with pytest.raises(ValueError, match="ratio"):
        ops.decode_attend_gqa(torch.zeros(2, 48), kc, vc, 3, n_q_heads=3,
                              n_kv_heads=2, head_dim=BHD)


# ---------------------------------------------------------------------------
# KV-cache append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 5, 15])
def test_append_scalar_pos_matches_pallas(pos):
    rng = np.random.RandomState(pos)
    kc, vc = (rng.randn(B, S, H * HD).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(B, 1, H * HD).astype(np.float32) for _ in range(2))
    wk, wv = jax_cache_append(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(kn), jnp.asarray(vn), pos,
                              impl="pallas", interpret=True)
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    gk, gv = ops.cache_append(tk, tv, torch.tensor(kn), torch.tensor(vn), pos)
    assert gk is tk and gv is tv                  # in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("rows,pos", [(1, [3, 16]), (1, [15, 40]),
                                      (4, [0, 13]), (4, [12, 99]),
                                      (16, [0, 5])])
def test_append_vector_pos_matches_vmapped_dus(rows, pos):
    """Per-row positions, including starts past S - rows (clamped exactly as
    dynamic_update_slice clamps)."""
    rng = np.random.RandomState(rows)
    kc, vc = (rng.randn(B, S, H * HD).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(B, rows, H * HD).astype(np.float32) for _ in range(2))
    wk, wv = jax_cache_append(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(pos, jnp.int32))
    gk, gv = ops.cache_append(torch.tensor(kc), torch.tensor(vc),
                              torch.tensor(kn), torch.tensor(vn),
                              torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("pos", [0, 9, 30])
def test_append_scalar_slab_matches_dus(pos):
    rng = np.random.RandomState(pos)
    kc, vc = (rng.randn(B, S, H * HD).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(B, 8, H * HD).astype(np.float32) for _ in range(2))
    wk, wv = jax_cache_append(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(kn), jnp.asarray(vn), pos, impl="xla")
    gk, gv = ops.cache_append(torch.tensor(kc), torch.tensor(vc),
                              torch.tensor(kn), torch.tensor(vn), pos)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_append_rejects_other_axes():
    kc = torch.zeros(2, 4, 8)
    with pytest.raises(NotImplementedError):
        ops.cache_append(kc, kc.clone(), torch.zeros(2, 1, 8),
                         torch.zeros(2, 1, 8), 0, axis=2)


# ---------------------------------------------------------------------------
# fused cross-entropy
# ---------------------------------------------------------------------------

CE_T, CE_D, CE_V = 64, 32, 256


def _ce_inputs(seed, dtype_name, t=CE_T, v=CE_V):
    rng = np.random.RandomState(seed)
    h = rng.randn(t, CE_D).astype(np.float32)
    tab = rng.randn(v, CE_D).astype(np.float32) * 0.5
    tgt = rng.randint(0, v, (t,)).astype(np.int32)
    tgt[:3] = [-1, v, v + 7]                       # out of range: pick nothing
    (hj, ht), (tj, tt) = _both(h, dtype_name), _both(tab, dtype_name)
    return hj, ht, tj, tt, jnp.asarray(tgt), torch.tensor(tgt)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ce_stats_matches_pallas(dtype_name):
    hj, ht, tj, tt, gj, gt = _ce_inputs(0, dtype_name)
    want = jax_ce.ce_stats(hj, tj, gj, 16, 64, interpret=True)
    got = ops.ce_stats(ht, tt, gt)
    for name, g, w in zip(("m", "l", "picked"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (CE_T,), name
        _close(g, w, "float32", atol=1e-4 if dtype_name == "float32" else 2e-2)
    assert float(got[2][0]) == 0.0 and float(got[2][1]) == 0.0


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ce_grads_match_pallas(dtype_name):
    hj, ht, tj, tt, gj, gt = _ce_inputs(1, dtype_name)
    m, l, _ = ops.ce_stats(ht, tt, gt)
    lse = (m + torch.log(l)).numpy()         # the softmax's own LSE: p <= 1
    dnll = np.random.RandomState(2).rand(CE_T).astype(np.float32)
    want = jax_ce.ce_grads(hj, tj, gj, jnp.asarray(lse), jnp.asarray(dnll),
                           16, 64, interpret=True)
    args = (ht, tt, gt, torch.tensor(lse), torch.tensor(dnll))
    got = ops.ce_grads(*args)
    for name, g, w, x in zip(("dh", "dtable"), got, want, (ht, tt)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        _close(g, w, dtype_name, atol=1e-5 if dtype_name == "float32" else None)
    # the one-output wrappers (the ce_dh / ce_dtable kernels' plain versions)
    torch.testing.assert_close(ops.ce_dh(*args), got[0], atol=0, rtol=0)
    torch.testing.assert_close(ops.ce_dtable(*args), got[1], atol=0, rtol=0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_cross_entropy_grads_match_pallas(dtype_name):
    """Loss and both gradients through the autograd Function vs
    ``jax.vjp`` of the Pallas ``fused_cross_entropy`` (interpret mode)."""
    hj, ht, tj, tt, gj, gt = _ce_inputs(3, dtype_name)
    ct = np.random.RandomState(4).rand(CE_T).astype(np.float32)
    nll_j, vjp = jax.vjp(lambda h, t: jax_ce.fused_cross_entropy(
        h, t, gj, 16, 64, True), hj, tj)
    dh_j, dt_j = vjp(jnp.asarray(ct))
    leaves = [x.requires_grad_() for x in (ht, tt)]
    nll = ops.fused_cross_entropy(*leaves, gt)
    _close(nll.detach(), nll_j, "float32",
           atol=1e-4 if dtype_name == "float32" else 5e-2)
    dh, dt = torch.autograd.grad(nll, leaves, torch.tensor(ct))
    _close(dh, dh_j, dtype_name, atol=1e-5 if dtype_name == "float32" else None)
    _close(dt, dt_j, dtype_name, atol=1e-5 if dtype_name == "float32" else None)


def test_fused_ce_ragged_shapes_match_plain_math():
    """T and V that are not multiples of any tile: the plain version is
    the materialised log-softmax."""
    hj, ht, tj, tt, gj, gt = _ce_inputs(5, "float32", t=37, v=77)
    nll = ops.fused_cross_entropy(ht, tt, gt)
    logits = ht @ tt.t()
    lse = torch.logsumexp(logits, -1)
    ok = (gt >= 0) & (gt < 77)
    pick = torch.where(ok, logits.gather(1, gt.long().clamp(0, 76)[:, None])[:, 0],
                       torch.zeros(()))
    torch.testing.assert_close(nll, lse - pick, atol=1e-5, rtol=1e-5)


def test_fused_cross_entropy_takes_the_vocab_parallel_combine():
    """The loss path's combine (``pmax``/``psum`` legs, identities at
    world 1) gives the single-shard NLL and gradients exactly."""
    from chainermn_tpu_torch.parallel.transformer import _vp_combine

    _, ht, _, tt, _, gt = _ce_inputs(6, "float32")
    runs = []
    for combine in ({}, {"combine": _vp_combine}):
        leaves = [x.detach().clone().requires_grad_() for x in (ht, tt)]
        nll = ops.fused_cross_entropy(*leaves, gt, **combine)
        runs.append((nll.detach(), *torch.autograd.grad(nll.sum(), leaves)))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_launch_counters_reset():
    ops.flash_attention.launches = 5
    ops.ce_dtable.launches = 2
    ops.beam_attend_parts.launches = 3
    ops.conv3x3_wgrad.launches = 4
    assert ops.launch_counts()["flash_fwd"] == 5
    assert ops.launch_counts()["ce_dtable"] == 2
    assert ops.launch_counts()["beam_attend"] == 3
    assert ops.launch_counts()["conv_wgrad"] == 4
    assert set(ops.launch_counts()) == {
        "flash_fwd", "flash_bwd", "decode_attend", "cache_append",
        "ce_stats", "ce_dh", "ce_dtable", "beam_attend", "conv_wgrad",
        "conv_dgrad"}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
