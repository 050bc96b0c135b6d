"""The bf16 CE kernels' plans and schedules, on the CPU.

``ce_grads`` on the card walks V in chunks (``ops.fused_ce._grad_plan``):
per chunk a ``ds`` pass writes ``(exp(s − lse) − onehot)·dnll`` rounded to
bf16 into a workspace, then ``dh`` is summed in fp32 across the chunks and
rounded once, and each chunk's rows of ``dtable`` are written once.  The
kernels run only on the card; here the plan is checked directly, and an
emulation of the kernels' schedule (the chunk's logits over the ds pass's
256-wide tiles, the onehot offset by the chunk's start, columns past the
chunk masked, TMA's zero rows past V, the dh product's 64-deep k range)
is held against ``ce_grads_plain`` and JAX's ``ce_grads`` in interpret
mode.  Likewise ``ce_stats`` (``ops.fused_ce._stats_plan``): per 256-wide V
tile the statistics of its logits with the columns past V (TMA's zero
rows) left out, then the merge of the tiles in order, against
``ce_stats_plain`` and JAX's interpret-mode ``ce_stats``.  Inputs come
from seeded numpy.  Tolerances: fp32 atol 1e-5 (sums in another order);
bf16 atol = rtol = 2e-2 (8 mantissa bits; a chunked fp32 sum can move the
final bf16 rounding by one unit); the statistics, fp32 from either input
dtype, atol 1e-4 and rtol 1e-5 (the same fp32 products, summed in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import fused_ce as jax_ce
from chainermn_tpu_torch import ops
from chainermn_tpu_torch.ops._build import tma_operand
from chainermn_tpu_torch.ops.fused_ce import _grad_plan, _stats_plan

TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,v,d,chunk", [
    (8192, 32768, 1024, None), (64, 300, 32, 128), (1000, 1101, 200, 512),
    (77, 301, 96, None), (300, 461, 64, 128), (5, 1, 8, None),
    (200000, 50000, 1024, None)])
def test_grad_plan_covers_v_once_in_order(t, v, d, chunk):
    plan = _grad_plan(t, v, d, torch.bfloat16, chunk)
    bounds = plan["bounds"]
    assert bounds[0][0] == 0 and bounds[-1][1] == v
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0                               # contiguous, in order
    assert all(0 < v1 - v0 <= plan["chunk"] for v0, v1 in bounds)
    assert all(v1 - v0 == plan["chunk"] for v0, v1 in bounds[:-1])
    assert plan["chunk"] % 128 == 0 and plan["chunk"] >= 128
    assert plan["chunk"] <= -(-v // 128) * 128       # at most V, to the tile
    rows, ld = plan["ds_shape"]
    assert rows == t and ld % 256 == 0 and ld >= plan["chunk"]
    assert plan["acc_shape"] == ((t, d) if len(bounds) > 1 else None)


def test_grad_plan_keeps_the_ds_chunk_in_l2_at_the_training_shape():
    plan = _grad_plan(8192, 32768, 1024, torch.bfloat16)
    rows, ld = plan["ds_shape"]
    assert plan["chunk"] == 2048 and len(plan["bounds"]) == 16
    assert 2 * rows * ld <= 32 << 20


@pytest.mark.parametrize("d", [100, 4, 1026, 33])
def test_grad_plan_bf16_pads_d_to_a_multiple_of_8(d):
    """The kernels reject a D that is not a multiple of 8 (TMA's 16-byte
    row strides), so the plan never hands them one: bf16 pads D up to a
    multiple of 8 with zero columns in a copy; fp32 keeps D."""
    plan = _grad_plan(64, 300, d, torch.bfloat16)
    assert plan["d_pad"] % 8 == 0 and 0 <= plan["d_pad"] - d < 8
    assert plan["acc_shape"] in (None, (64, plan["d_pad"]))
    assert _grad_plan(64, 300, d, torch.float32)["d_pad"] == d
    x = torch.ones(5, d, dtype=torch.bfloat16)
    padded = tma_operand(x, plan["d_pad"])
    assert padded.shape == (5, plan["d_pad"])
    assert torch.equal(padded[:, :d], x)
    assert not padded[:, d:].any()               # the pad adds nothing


@pytest.mark.parametrize("chunk,n_chunks", [(128, 3), (256, 2), (384, 1),
                                            (1024, 1)])
def test_grad_plan_takes_a_small_chunk(chunk, n_chunks):
    plan = _grad_plan(64, 300, 32, torch.bfloat16, chunk)
    assert len(plan["bounds"]) == n_chunks
    assert plan["chunk"] == min(chunk, 384)


@pytest.mark.parametrize("chunk", [0, 64, 100, 200])
def test_grad_plan_rejects_a_chunk_off_the_tile(chunk):
    with pytest.raises(ValueError, match="multiple of 128"):
        _grad_plan(64, 300, 32, torch.bfloat16, chunk)


# ---------------------------------------------------------------------------
# the kernels' schedule, emulated
# ---------------------------------------------------------------------------

def _rows(x, lo, hi):
    """Rows lo..hi-1 of x, zeros past its end (TMA's out-of-bounds fill)."""
    out = torch.zeros((hi - lo, x.shape[1]), dtype=torch.float32)
    n = max(0, min(hi, x.shape[0]) - lo)
    out[:n] = x[lo:lo + n].float()
    return out


def _emulate(h, table, targets, lse, dnll, plan):
    """``ce_grads`` as ``csrc/fused_ce.cu`` schedules it (bf16 rounding
    points and masks; fp32 keeps fp32 where the kernels would)."""
    t, d = h.shape
    v = table.shape[0]
    dt = h.dtype
    h, table = tma_operand(h, plan["d_pad"]), tma_operand(table,
                                                           plan["d_pad"])
    acc = torch.zeros((t, plan["d_pad"]), dtype=torch.float32)
    dtable = torch.empty_like(table)
    for v0, v1 in plan["bounds"]:
        vr = v1 - v0
        width = -(-vr // 256) * 256                 # the ds pass's tiles
        s = h.float() @ _rows(table, v0, v0 + width).t()
        col = torch.arange(width)[None, :]
        onehot = (col == (targets.long() - v0)[:, None]).float()
        ds = (torch.exp(s - lse[:, None]) - onehot) * dnll[:, None]
        ds = torch.where(col < vr, ds, torch.zeros(()))
        ds = ds.to(dt).float()                      # the workspace is bf16
        kw = -(-vr // 64) * 64                      # the dh product's k range
        acc += ds[:, :kw] @ _rows(table, v0, v0 + kw)
        dtable[v0:v1] = (ds[:, :vr].t() @ h.float()).to(dt)
    assert v1 == v
    return acc[:, :d].to(dt), dtable[:, :d]


def _inputs(dtype, t=64, v=300, d=32, seed=11):
    rng = np.random.RandomState(seed)
    h = rng.randn(t, d).astype(np.float32)
    tab = (rng.randn(v, d) * 0.5).astype(np.float32)
    tgt = rng.randint(0, v, (t,)).astype(np.int32)
    # out of range, then each chunk's first column, the one before it, V - 1
    tgt[:10] = [-1, v, v + 7, 127, 128, 255, 256, v - 1, 0, 129]
    dnll = rng.rand(t).astype(np.float32)
    ht, tt = torch.tensor(h).to(dtype), torch.tensor(tab).to(dtype)
    m, l, _ = ops.ce_stats_plain(ht, tt, torch.tensor(tgt))
    lse = m + torch.log(l)
    return ht, tt, torch.tensor(tgt), lse, torch.tensor(dnll)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_schedule_matches_plain_and_jax(dtype):
    h, tab, tgt, lse, dnll = _inputs(dtype)
    plan = _grad_plan(64, 300, 32, dtype, chunk=128)
    assert plan["bounds"] == [(0, 128), (128, 256), (256, 300)]
    dh, dtable = _emulate(h, tab, tgt, lse, dnll, plan)
    assert dh.dtype == dtype and dtable.dtype == dtype
    atol, rtol = TOL[dtype]
    ref = ops.ce_grads_plain(h, tab, tgt, lse, dnll)
    want = jax_ce.ce_grads(jnp.asarray(h.float().numpy(), JNP[dtype]),
                           jnp.asarray(tab.float().numpy(), JNP[dtype]),
                           jnp.asarray(tgt.numpy()), jnp.asarray(lse.numpy()),
                           jnp.asarray(dnll.numpy()), 16, 1024,
                           interpret=True)
    for got, r, w in zip((dh, dtable), ref, want):
        torch.testing.assert_close(got.float(), r.float(), atol=atol,
                                   rtol=rtol)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)),
            atol=atol, rtol=rtol)


@pytest.mark.parametrize("chunk", [128, 256, 384])
def test_schedule_is_the_same_function_for_every_chunk(chunk):
    """fp32: the chunking only reorders sums."""
    h, tab, tgt, lse, dnll = _inputs(torch.float32, seed=12)
    ref = ops.ce_grads_plain(h, tab, tgt, lse, dnll)
    got = _emulate(h, tab, tgt, lse, dnll,
                   _grad_plan(64, 300, 32, torch.float32, chunk))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def test_bf16_d_not_multiple_of_8_matches_jax():
    """bf16 at D = 100: the padded schedule gives JAX's gradients."""
    h, tab, tgt, lse, dnll = _inputs(torch.bfloat16, d=100, seed=13)
    plan = _grad_plan(64, 300, 100, torch.bfloat16, chunk=128)
    assert plan["d_pad"] == 104
    dh, dtable = _emulate(h, tab, tgt, lse, dnll, plan)
    assert dh.shape == (64, 100) and dtable.shape == (300, 100)
    want = jax_ce.ce_grads(jnp.asarray(h.float().numpy(), jnp.bfloat16),
                           jnp.asarray(tab.float().numpy(), jnp.bfloat16),
                           jnp.asarray(tgt.numpy()), jnp.asarray(lse.numpy()),
                           jnp.asarray(dnll.numpy()), 16, 1024,
                           interpret=True)
    atol, rtol = TOL[torch.bfloat16]
    for got, w in zip((dh, dtable), want):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)),
            atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# ce_stats: the plan and the bf16 kernel's schedule, emulated
# ---------------------------------------------------------------------------

STATS_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("t,v,d", [
    (8192, 32768, 1024), (64, 300, 100), (77, 301, 96), (5, 1, 8),
    (64, 300, 4), (64, 300, 1026), (200000, 1000, 1024)])
def test_stats_plan_pads_d_and_counts_the_tiles(t, v, d):
    plan = _stats_plan(t, v, d, torch.bfloat16)
    assert plan["d_pad"] % 8 == 0 and 0 <= plan["d_pad"] - d < 8
    assert plan["tile_v"] == 256 and plan["per"] == 1
    assert (plan["parts"] - 1) * 256 < v <= plan["parts"] * 256
    f32 = _stats_plan(t, v, d, torch.float32)
    assert f32["d_pad"] == d and f32["tile_v"] == 64
    n_v = -(-v // 64)                      # every 64-wide tile in one part
    assert f32["per"] * f32["parts"] >= n_v > f32["per"] * (f32["parts"] - 1)


def test_stats_plan_partials_fit_13_mb_at_the_training_shape():
    """A part per 256-wide V tile: the partials are 3 x 128 x 8192 fp32,
    under 13 MB."""
    plan = _stats_plan(8192, 32768, 1024, torch.bfloat16)
    assert plan["parts"] == 128
    assert 3 * plan["parts"] * 8192 * 4 < 13e6


MERGE_G = 8     # csrc/fused_ce.cu: the merge's groups of parts


def _merge(tiles):
    """``(m, l, picked)`` from per-part ones, in the merge kernel's order:
    group g takes parts g, g + 8, ... in order, then the groups in order."""
    def one(parts):
        m = torch.stack([x[0] for x in parts]).amax(0)
        l, p = torch.zeros_like(m), torch.zeros_like(m)
        for mx, se, pk in parts:
            l += se * torch.exp(mx - m)
            p += pk
        return m, l, p
    return one([one(tiles[g::MERGE_G]) for g in range(MERGE_G)
                if tiles[g::MERGE_G]])


def _emulate_stats(h, table, targets, plan):
    """bf16 ``ce_stats`` as ``csrc/fused_ce.cu`` schedules it: per V tile
    the logits of the padded operands (TMA's zero rows past V), the row
    max, the sum of exp(s - max) and the pick over the columns < V alone,
    then the merge of the tiles in the merge kernel's fixed order."""
    v = table.shape[0]
    h, table = tma_operand(h, plan["d_pad"]), tma_operand(table,
                                                           plan["d_pad"])
    tv, tgt = plan["tile_v"], targets.long()[:, None]
    tiles = []
    for part in range(plan["parts"]):
        v0 = part * tv
        s = h.float() @ _rows(table, v0, v0 + tv).t()
        col = v0 + torch.arange(tv)[None, :]
        valid = col < v
        mx = torch.where(valid, s, torch.full((), -1e30)).amax(-1)
        se = torch.where(valid, torch.exp(s - mx[:, None]),
                         torch.zeros(())).sum(-1)
        pk = torch.where(valid & (col == tgt), s, torch.zeros(())).sum(-1)
        tiles.append((mx, se, pk))
    return _merge(tiles)


def _stats_inputs(dtype, t=64, v=300, d=100, seed=21):
    rng = np.random.RandomState(seed)
    h = torch.tensor(rng.randn(t, d).astype(np.float32)).to(dtype)
    tab = torch.tensor((rng.randn(v, d) * 0.5).astype(np.float32)).to(dtype)
    tgt = rng.randint(0, v, (t,)).astype(np.int32)
    # out of range, the 256-wide tile edges, the last tile's first column
    tgt[:7] = [-1, v, 255, 256, v - 1, 0, (v - 1) // 256 * 256]
    return h, tab, torch.tensor(tgt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("t,v,d", [(64, 300, 100), (40, 256, 32),
                                   (77, 513, 8), (33, 2600, 16)])
def test_stats_schedule_matches_plain_and_jax(t, v, d, dtype):
    """V off the 256 tile, D padded (100 -> 104), targets on the tile
    edges and out of range."""
    h, tab, tgt = _stats_inputs(dtype, t, v, d)
    plan = _stats_plan(t, v, d, torch.bfloat16)
    got = _emulate_stats(h, tab, tgt, plan)
    ref = ops.ce_stats_plain(h, tab, tgt)
    jd = JNP[dtype]
    want = jax_ce.ce_stats(jnp.asarray(h.float().numpy(), jd),
                           jnp.asarray(tab.float().numpy(), jd),
                           jnp.asarray(tgt.numpy()), interpret=True)
    for g, r, w in zip(got, ref, want):
        torch.testing.assert_close(g, r, **STATS_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATS_TOL)
    assert float(got[2][0]) == 0.0 and float(got[2][1]) == 0.0  # no pick
