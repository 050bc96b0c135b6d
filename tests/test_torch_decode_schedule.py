"""The bf16 decode kernel's schedule and the fused tick append, on the CPU.

``csrc/decode_attention.cu`` runs only on the card.  Here its device-side
split rule is checked for coverage, its schedule is emulated and held
against JAX's ``decode_attend`` (interpret mode, as
``tests/test_decode_attention.py`` runs it) and against the per-row einsum
attention of ``chainermn_tpu/parallel/decode.py``, and the port's
``decode_append_attend`` is held against JAX's ``cache_append`` followed by
``decode_attend``:

* the heads are split evenly into the fewest groups of at most 2048 lanes
  (``decode_groups``), a block reading one group's lanes;
* row ``b`` attends ``[0, n)``, ``n = min(pos[b], S - 1) + 1``; block ``z``
  of the row takes tiles ``[z·nt // k, (z + 1)·nt // k)`` of its ``nt``
  tiles (``decode_split_range``), some of them empty;
* in a block, per tile: fp32 scores from the input values, scaled; the
  head's tile max, ``corr = exp(m - m_new)``, ``p = exp(s - m_new)``
  unrounded; each of the block's position subsets (position ``t`` in
  subset ``t % PS``) keeps its own ``l`` and ``acc`` rescaled by ``corr``,
  summed in subset order at the end; an empty block gives ``m = -1e30, l =
  0, acc = 0``;
* the last block merges the row's splits in split order, 16 a round
  with a running max: ``M = max m_i``, ``acc = Σ exp(m_i − M)·acc_i``,
  ``l`` alike, the running sums rescaled by ``exp(M_old − M)``, ``ctx =
  acc / l``;
* with the append, the row at ``n - 1`` is ``k_new`` / ``v_new`` in the
  cache's dtype, in the attention and in the cache afterwards.

Inputs come from seeded numpy.  Tolerances: fp32 atol 1e-5, rtol 1e-4
(the same fp32 sums as JAX's, taken in another order: per tile, per
subset, per split); bf16 inputs atol = rtol = 2e-2, as the port's other
bf16 tests hold them (JAX's bf16 kernel computes in fp32 too).  The caches
after an append are a copy and must be equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.decode_attention import decode_attend as jax_decode_attend
from chainermn_tpu.ops.kv_cache import cache_append as jax_cache_append
from chainermn_tpu_torch import ops
from chainermn_tpu_torch.ops.decode_attention import (decode_groups,
                                                      decode_split_plan,
                                                      decode_split_range,
                                                      decode_tile)

NEG = -1e30
MERGE_ROUND = 16                # splits the last block merges a round
SMS = 132                       # the H100's SMs, for the plan
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _valid_len(s, pos_b):
    return min(max(pos_b, 0), s - 1) + 1


def _position_subsets(width):
    """PV position subsets of a block: its 256 threads over the 16-byte
    chunks of its group's ``width`` lanes."""
    return 256 // (width // 8)


# ---------------------------------------------------------------------------
# the split rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d", [
    (8, 1024, 1024), (1, 1024, 1024), (3, 7, 256), (3, 1, 256),
    (2, 77, 128), (16, 2048, 2048), (5, 333, 384), (8, 1024, 4096)])
def test_split_rule_covers_each_position_once(b, s, d):
    """For every row length n in 1..S, the plan's blocks cover [0, n)
    exactly once, in split order, each with whole tiles but the last, and
    the live tiles spread evenly (the counts differ by at most one).
    Heads of 64 (D 4096: two groups)."""
    h, hd = d // 64, 64
    groups, k, tile = decode_split_plan(b, s, h, hd, SMS)
    width = h // groups * hd
    assert 1 <= k <= 64 and tile == decode_tile(width)
    assert 2 * tile * width * 2 <= 32768 and k * b * groups <= SMS
    for n in range(1, s + 1):
        end, counts = 0, []
        for z in range(k):
            lo, hi = decode_split_range(z, n, k, tile)
            if lo == hi:
                counts.append(0)
                continue
            assert lo == end and lo % tile == 0 and lo < hi <= n
            assert hi % tile == 0 or hi == n
            end = hi
            counts.append(-(-(hi - lo) // tile))
        assert end == n
        assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("k,tile", [(1, 8), (16, 8), (33, 8), (64, 1),
                                    (5, 3), (7, 64)])
def test_split_rule_other_plans(k, tile):
    """The rule alone, for split counts and tiles the plan may not give."""
    for n in (1, 2, 3, 7, 8, 9, 63, 64, 65, 100, 513, 1024):
        hits = np.zeros(n, np.int64)
        for z in range(k):
            lo, hi = decode_split_range(z, n, k, tile)
            hits[lo:hi] += 1
        assert (hits == 1).all()


def test_plan_at_the_main_paths_shapes():
    """Serving (8 slots, cache 1024, D 1024): 16 blocks a row of 8-position
    tiles, one wave of 128 blocks; one slot: the cap of 64; four: 33 (the
    merge takes three rounds); 200 slots: one split each; a 7-position
    cache: one split; D 4096 and 8192: two and four head groups of 2048
    lanes, the wave shared between them; no plan reads pos."""
    assert decode_split_plan(8, 1024, 16, 64, SMS) == (1, 16, 8)
    assert decode_split_plan(1, 1024, 16, 64, SMS) == (1, 64, 8)
    assert decode_split_plan(4, 1024, 16, 64, SMS) == (1, 33, 8)
    assert decode_split_plan(200, 1024, 16, 64, SMS) == (1, 1, 8)
    assert decode_split_plan(3, 7, 4, 64, SMS) == (1, 1, 32)
    assert decode_split_plan(8, 1024, 16, 128, SMS) == (1, 16, 4)
    assert decode_split_plan(8, 1024, 32, 128, SMS) == (2, 8, 4)
    assert decode_split_plan(2, 512, 64, 128, SMS) == (4, 16, 4)


@pytest.mark.parametrize("h,hd,groups", [
    (16, 64, 1), (32, 64, 1), (16, 128, 1), (24, 128, 2), (32, 128, 2),
    (40, 64, 2), (64, 128, 4), (96, 128, 6), (37, 64, 37), (49, 128, 7)])
def test_head_groups_split_the_heads_evenly(h, hd, groups):
    """The fewest groups that divide the heads, each at most 2048 lanes:
    one instantiation of the kernel takes any width."""
    assert decode_groups(h, hd) == groups
    assert h % groups == 0 and h // groups * hd <= 2048


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated
# ---------------------------------------------------------------------------

def _emulate(q, kc, vc, pos, n_heads, head_dim, k, tile, k_new=None,
             v_new=None):
    """``decode_attend`` (``decode_append_attend`` with the new rows) as the
    bf16 kernel schedules it; returns fp32 ``ctx`` and the fp32 caches the
    kernel reads.  The heads' sums do not mix, so the groups' blocks are
    emulated together; the groups set the position subsets."""
    b, s, d = kc.shape
    scale = 1.0 / math.sqrt(head_dim)
    ps = _position_subsets(n_heads // decode_groups(n_heads, head_dim)
                           * head_dim)
    pos_v = ([int(pos)] * b if not isinstance(pos, torch.Tensor)
             else [int(x) for x in pos])
    q3 = q.float().reshape(b, n_heads, head_dim)
    k4 = kc.float().reshape(b, s, n_heads, head_dim).clone()
    v4 = vc.float().reshape(b, s, n_heads, head_dim).clone()
    ctx = torch.zeros(b, n_heads, head_dim)
    for bi in range(b):
        n = _valid_len(s, pos_v[bi])
        if k_new is not None:      # the new row, in the cache's dtype
            k4[bi, n - 1] = k_new[bi].to(kc.dtype).float().reshape(
                n_heads, head_dim)
            v4[bi, n - 1] = v_new[bi].to(vc.dtype).float().reshape(
                n_heads, head_dim)
        parts = []
        for z in range(k):
            lo, hi = decode_split_range(z, n, k, tile)
            m = torch.full((n_heads,), NEG)
            l = torch.zeros(ps, n_heads)
            acc = torch.zeros(ps, n_heads, head_dim)
            for t0 in range(lo, hi, tile):
                t = torch.arange(t0, min(hi, t0 + tile))
                sc = torch.einsum("hd,thd->ht", q3[bi], k4[bi, t]) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[:, None])
                l = l * corr
                acc = acc * corr[:, None]
                for lp in range(len(t)):
                    l[lp % ps] += p[:, lp]
                    acc[lp % ps] += p[:, lp, None] * v4[bi, t[lp]]
                m = m_new
            parts.append((acc.sum(0), m, l.sum(0)))
        # the last block: MERGE_ROUND splits a round, in split order, with a
        # running max
        mx = torch.full((n_heads,), NEG)
        a_tot, l_tot = torch.zeros(n_heads, head_dim), torch.zeros(n_heads)
        for z0 in range(0, k, MERGE_ROUND):
            chunk = parts[z0:z0 + MERGE_ROUND]
            m_new = mx
            for _, m_i, _ in chunk:
                m_new = torch.maximum(m_new, m_i)
            c = torch.exp(mx - m_new)
            a_tot, l_tot = a_tot * c[:, None], l_tot * c
            for a_i, m_i, l_i in chunk:
                w = torch.exp(m_i - m_new)
                a_tot = a_tot + w[:, None] * a_i
                l_tot = l_tot + w * l_i
            mx = m_new
        ctx[bi] = a_tot / l_tot[:, None]
    return ctx.reshape(b, d), k4.reshape(b, s, d), v4.reshape(b, s, d)


def _inputs(b, s, h, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    d = h * hd
    q, kn, vn = (torch.tensor(rng.randn(b, d).astype(np.float32)).to(dtype)
                 for _ in range(3))
    kc, vc = (torch.tensor(rng.randn(b, s, d).astype(np.float32)).to(dtype)
              for _ in range(2))
    return q, kc, vc, kn, vn


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _jax(x, dtype):
    return jnp.asarray(x.float().numpy(), JNP[dtype])


def _jax_per_row(q, kc, vc, pos, n_heads, head_dim):
    """The per-row einsum attention of chainermn_tpu/parallel/decode.py
    (serving tick, s_q = 1, h_q == h_kv), written out on jnp in fp32."""
    n, total = kc.shape[0], kc.shape[1]
    kc4 = kc.astype(jnp.float32).reshape(n, total, n_heads, head_dim)
    vc4 = vc.astype(jnp.float32).reshape(n, total, n_heads, head_dim)
    q4 = q.astype(jnp.float32).reshape(n, n_heads, 1, head_dim)
    s = jnp.einsum("bhqd,bkhd->bhqk", q4, kc4) / (head_dim ** 0.5)
    mask = jnp.arange(total)[None, None, None, :] < (pos[:, None, None, None]
                                                      + 1)
    p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    return jnp.einsum("bhqk,bkhd->bhqd", p, vc4).reshape(n, n_heads * head_dim)


SCHEDULES = [(1, 64), (4, 8), (7, 3), (16, 1), (40, 1),
             None]                                     # None: the plan's


def _splits(schedule, b, s, h, hd):
    """``(n_split, tile)``: the given schedule, or the plan's."""
    return schedule or decode_split_plan(b, s, h, hd, SMS)[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("hd,pos", [(64, 0), (64, 37), (128, 71), (64, 500)])
def test_schedule_matches_jax_scalar_pos(hd, pos, schedule, dtype):
    b, s, h = 3, 72, 2
    q, kc, vc, _, _ = _inputs(b, s, h, hd, dtype, seed=pos + hd)
    k, tile = _splits(schedule, b, s, h, hd)
    got, _, _ = _emulate(q, kc, vc, pos, h, hd, k, tile)
    want = jax_decode_attend(_jax(q, dtype), _jax(kc, dtype),
                             _jax(vc, dtype), pos, n_heads=h, head_dim=hd,
                             interpret=True)
    _close(got, want, dtype, "emulation vs JAX")
    _close(got, ops.decode_attend(q, kc, vc, pos, n_heads=h, head_dim=hd),
           dtype, "emulation vs plain")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("h,hd,pos", [(40, 64, 19), (24, 128, 5)])
def test_schedule_with_head_groups_matches_jax(h, hd, pos, dtype):
    """Widths past one group's 2048 lanes (two groups each), in the plan's
    schedule and in 7 splits of 3, against JAX's interpret-mode kernel."""
    b, s = 2, 24
    q, kc, vc, _, _ = _inputs(b, s, h, hd, dtype, seed=h + pos)
    want = jax_decode_attend(_jax(q, dtype), _jax(kc, dtype),
                             _jax(vc, dtype), pos, n_heads=h, head_dim=hd,
                             interpret=True)
    for k, tile in (_splits(None, b, s, h, hd), (7, 3)):
        got, _, _ = _emulate(q, kc, vc, pos, h, hd, k, tile)
        _close(got, want, dtype, f"emulation {k}x{tile} vs JAX")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("pos", [[0, 9, 71], [40, 3, 5000], [8, 16, 7]])
def test_schedule_matches_per_row_einsum(pos, schedule):
    """Per-row pos, with 0, a tile edge and past S, against the JAX tick's
    per-row einsum attention (JAX's kernel takes one scalar pos)."""
    b, s, h, hd = 3, 72, 4, 64
    q, kc, vc, _, _ = _inputs(b, s, h, hd, torch.float32, seed=sum(pos))
    k, tile = _splits(schedule, b, s, h, hd)
    pt = torch.tensor(pos, dtype=torch.int32)
    got, _, _ = _emulate(q, kc, vc, pt, h, hd, k, tile)
    want = _jax_per_row(_jax(q, torch.float32), _jax(kc, torch.float32),
                        _jax(vc, torch.float32), jnp.asarray(pos, jnp.int32),
                        h, hd)
    _close(got, want, torch.float32, "emulation vs JAX per-row")


# ---------------------------------------------------------------------------
# the fused append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 7, 40, 71, 300])
def test_fused_append_matches_jax_append_then_attend(pos, dtype):
    """Scalar pos: JAX's Pallas append in interpret mode, then its decode
    kernel, against the port's call and the kernel's fused schedule.  Past
    S the append is JAX's dynamic_update_slice, which clamps the start to
    row S - 1 (the Pallas kernel takes in-range positions only), and the
    attention reads all S."""
    b, s, h, hd = 2, 72, 2, 64
    q, kc, vc, kn, vn = _inputs(b, s, h, hd, dtype, seed=pos + 11)
    impl = dict(impl="pallas", interpret=True) if pos < s else dict(impl="xla")
    wk, wv = jax_cache_append(_jax(kc, dtype), _jax(vc, dtype),
                              _jax(kn, dtype)[:, None],
                              _jax(vn, dtype)[:, None], pos, **impl)
    want = jax_decode_attend(_jax(q, dtype), wk, wv, pos, n_heads=h,
                             head_dim=hd, interpret=True)
    tk, tv = kc.clone(), vc.clone()
    got = ops.decode_append_attend(q, kn[:, None], vn[:, None], tk, tv, pos,
                                   n_heads=h, head_dim=hd)
    assert got.dtype == dtype
    _close(got, want, dtype, "fused vs JAX")
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(wk.astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(wv.astype(jnp.float32)))
    for k, tile in (_splits(None, b, s, h, hd), (5, 4)):
        em, ek, ev = _emulate(q, kc, vc, pos, h, hd, k, tile, kn, vn)
        _close(em, want, dtype, f"fused schedule {k}x{tile} vs JAX")
        assert torch.equal(ek, tk.float()) and torch.equal(ev, tv.float())


@pytest.mark.parametrize("pos", [[0, 9, 71], [40, 3, 5000], [8, 16, 7]])
def test_fused_append_matches_vmapped_dus_and_einsum(pos):
    """Per-row pos: JAX's vector-pos append (vmapped dynamic_update_slice,
    the start clamped) and the per-row einsum attention."""
    b, s, h, hd = 3, 72, 4, 64
    q, kc, vc, kn, vn = _inputs(b, s, h, hd, torch.float32, seed=sum(pos))
    pj = jnp.asarray(pos, jnp.int32)
    wk, wv = jax_cache_append(_jax(kc, torch.float32), _jax(vc, torch.float32),
                              _jax(kn, torch.float32)[:, None],
                              _jax(vn, torch.float32)[:, None], pj)
    want = _jax_per_row(_jax(q, torch.float32), wk, wv, pj, h, hd)
    tk, tv = kc.clone(), vc.clone()
    pt = torch.tensor(pos, dtype=torch.int32)
    got = ops.decode_append_attend(q, kn, vn, tk, tv, pt, n_heads=h,
                                   head_dim=hd)
    _close(got, want, torch.float32, "fused vs JAX per-row")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    em, ek, ev = _emulate(q, kc, vc, pt, h, hd, 7, 3, kn, vn)
    _close(em, want, torch.float32, "fused schedule vs JAX per-row")
    assert torch.equal(ek, tk) and torch.equal(ev, tv)


def test_fused_append_reads_qkv_head_views():
    """q, k and v as the tick hands them over: head views of one fused QKV
    projection ``(B, 1, H, 3, hd)``, read in place, with k and v in fp32
    against bf16 caches (stored rounded)."""
    b, s, h, hd = 2, 16, 4, 64
    rng = np.random.RandomState(5)
    qkv = torch.tensor(rng.randn(b, 1, h, 3, hd).astype(np.float32))
    kc, vc = (torch.tensor(rng.randn(b, s, h * hd).astype(np.float32))
              .bfloat16() for _ in range(2))
    pos = torch.tensor([3, 15], dtype=torch.int32)
    q, k, v = (qkv[..., i, :] for i in range(3))
    tk, tv = kc.clone(), vc.clone()
    got = ops.decode_append_attend(q.bfloat16(), k, v, tk, tv, pos,
                                   n_heads=h, head_dim=hd)
    rk, rv = kc.clone(), vc.clone()
    ops.cache_append(rk, rv, k.reshape(b, 1, h * hd), v.reshape(b, 1, h * hd),
                     pos)
    want = ops.decode_attend(q.reshape(b, h * hd).bfloat16(), rk, rv, pos,
                             n_heads=h, head_dim=hd)
    assert torch.equal(got, want)
    assert torch.equal(tk, rk) and torch.equal(tv, rv)


def test_fused_append_rejects_bad_shapes_and_counts_nothing_on_cpu():
    kc = torch.zeros(2, 8, 128)
    before = ops.decode_attend.launches
    with pytest.raises(ValueError):
        ops.decode_append_attend(torch.zeros(2, 128), torch.zeros(2, 1, 64),
                                 torch.zeros(2, 1, 64), kc, kc.clone(), 3,
                                 n_heads=2, head_dim=64)
    with pytest.raises(ValueError):
        ops.decode_append_attend(torch.zeros(3, 128), torch.zeros(2, 128),
                                 torch.zeros(2, 128), kc, kc.clone(), 3,
                                 n_heads=2, head_dim=64)
    ops.decode_append_attend(torch.zeros(2, 128), torch.zeros(2, 128),
                             torch.zeros(2, 128), kc, kc.clone(), 3,
                             n_heads=2, head_dim=64)
    assert ops.decode_attend.launches == before
