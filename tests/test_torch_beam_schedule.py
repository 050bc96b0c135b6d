"""The bf16 beam kernel's schedule, on the CPU.

``csrc/beam_attention.cu`` runs only on the card.  Here its split plan is
checked for coverage, and its schedule is emulated and held against JAX's
``beam_attend_parts`` in interpret mode (as ``tests/test_decode_attention.py``
runs it) and against the port's plain version:

* the segment is cut into splits of whole 64-position tiles
  (``beam_split_plan``); in pos mode only the splits that start at or
  before ``pos[b]`` run;
* in a split, each of four warps takes 16 positions of every tile and
  keeps its own online softmax per q row: scores in fp32 from the input
  values, scaled, masked with the finite ``-1e30``, positions past the
  split excluded (p = 0); the warp's max, ``corr = exp(m - m_new)``, ``p =
  exp(s - m_new)`` unrounded, ``l`` and ``acc`` rescaled by ``corr``;
* the four warps merge in order, then the splits merge in order: ``M =
  max m_i``, ``acc = Σ exp(m_i − M)·acc_i``, ``l`` alike.

Inputs come from seeded numpy.  Tolerances: fp32 atol 1e-5, rtol 1e-4
(the same fp32 sums as JAX's, taken in another order: per tile, per warp,
per split); bf16 inputs atol = rtol = 2e-2, as the port's other bf16 beam
tests hold them (JAX's bf16 kernel computes in fp32 too, so the
differences are again the order of the sums).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import decode_attention as jax_da
from chainermn_tpu_torch import ops
from chainermn_tpu_torch.ops.decode_attention import BEAM_TILE, beam_split_plan

NEG = -1e30
QUARTER = 16                    # positions of a tile one warp takes
SMS = 132                       # the H100's SMs, for the plan
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _valid_len(s, pos_b):
    """Positions [0, n) of a row are read: all of S, or up to pos."""
    return s if pos_b is None else min(pos_b, s - 1) + 1


def _live_splits(s, split_len, pos_b):
    """The splits that run for a row: ``(t_begin, t_end)`` in split order."""
    n = _valid_len(s, pos_b)
    return [(z, min(n, z + split_len)) for z in range(0, n, split_len)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,pairs", [
    (1, 8), (4, 128), (77, 8), (512, 128), (1024, 32), (2044, 128),
    (2048, 128), (5000, 2), (8192, 4)])
def test_plan_covers_each_position_once(s, pairs):
    """The beam window (B 8 x 16 heads, up to 2048 rows), the prompt, the
    GQA tick (B 8 x 4 KV heads) and ragged or long segments: whole tiles,
    every position in exactly one split, the last one ragged; few pairs
    are split to fill the card, and a grid of half a block an SM or more
    keeps splits of at least 16 tiles."""
    split_len, n_split = beam_split_plan(s, pairs, SMS)
    assert split_len % BEAM_TILE == 0 and n_split == -(-s // split_len)
    hits = torch.zeros(s, dtype=torch.int64)
    for z in range(n_split):
        hits[z * split_len:(z + 1) * split_len] += 1
    assert bool((hits == 1).all())
    tiles, per = -(-s // BEAM_TILE), split_len // BEAM_TILE
    if 2 * pairs >= SMS:                 # the window, the prompt
        assert per >= min(tiles, 16)
    if per > min(tiles, 16) or 2 * pairs < SMS:
        if tiles * pairs <= 2 * SMS:    # one tile a split: every block at once
            assert per == 1
        else:
            assert pairs * n_split >= SMS   # a full wave at least
            # one tile fewer a split would give more than two blocks an SM
            assert per == 1 or pairs * -(-tiles // (per - 1)) > 2 * SMS


@pytest.mark.parametrize("s,pairs,want", [
    (2048, 128, 2), (2044, 128, 2), (1024, 128, 1), (512, 128, 1),
    (1024, 32, 8), (261, 8, 5)])
def test_plan_at_the_main_paths_shapes(s, pairs, want):
    """The beam window splits in two, a window of up to 16 tiles and the
    prompt stay whole, the GQA tick splits in eight, the smoke's edge
    segments (B 2 x 4 heads) every tile."""
    assert beam_split_plan(s, pairs, SMS)[1] == want


@pytest.mark.parametrize("s,pos_b", [(261, 0), (261, 63), (261, 64),
                                     (261, 127), (261, 128), (261, 260),
                                     (261, 5000), (77, 76), (77, 10)])
def test_pos_mode_runs_the_splits_up_to_pos(s, pos_b):
    """A split wholly past pos reads nothing; the live splits cover
    [0, pos] exactly once, split edges included."""
    split_len, n_split = beam_split_plan(s, 8, SMS)
    live = _live_splits(s, split_len, pos_b)
    n = _valid_len(s, pos_b)
    assert len(live) == -(-n // split_len) <= n_split
    hits = torch.zeros(s, dtype=torch.int64)
    for t0, t1 in live:
        assert t0 < n
        hits[t0:t1] += 1
    assert bool((hits[:n] == 1).all()) and int(hits[n:].sum()) == 0


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated
# ---------------------------------------------------------------------------

def _merge(parts):
    """Fixed-order merge of ``(acc, m, l)`` states (acc (R, H, hd), m and l
    (R, H))."""
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    acc = l = 0.0
    for a, m, li in parts:
        w = torch.exp(m - mx)
        acc = acc + w[..., None] * a
        l = l + w * li
    return acc, mx, l


def _emulate(q, kc, vc, amask, pos, beams, n_heads, head_dim):
    """``beam_attend_parts`` as the bf16 kernel schedules it."""
    b, s, d = kc.shape
    scale = 1.0 / math.sqrt(head_dim)
    split_len, _ = beam_split_plan(s, b * n_heads, SMS)
    q4 = q.float().reshape(b, beams, n_heads, head_dim)
    k4 = kc.float().reshape(b, s, n_heads, head_dim)
    v4 = vc.float().reshape(b, s, n_heads, head_dim)
    pos_v = None if pos is None else (
        [int(pos)] * b if not isinstance(pos, torch.Tensor)
        else [int(x) for x in pos])
    accs, ms, ls = [], [], []
    for bi in range(b):
        splits = []
        for t_begin, t_end in _live_splits(
                s, split_len, None if pos_v is None else pos_v[bi]):
            warps = []
            for quarter in range(BEAM_TILE // QUARTER):
                m = torch.full((beams, n_heads), NEG)
                l = torch.zeros(beams, n_heads)
                acc = torch.zeros(beams, n_heads, head_dim)
                for t0 in range(t_begin, t_end, BEAM_TILE):
                    t = torch.arange(t0 + QUARTER * quarter,
                                     t0 + QUARTER * (quarter + 1))
                    inside = t < t_end
                    tc = t.clamp(max=s - 1)         # TMA: rows past S are 0
                    kk = torch.where(inside[:, None, None], k4[bi, tc], 0.0)
                    vv = torch.where(inside[:, None, None], v4[bi, tc], 0.0)
                    sc = torch.einsum("rhd,thd->rht", q4[bi], kk) * scale
                    ok = inside[None, None, :]
                    if amask is not None:
                        ok = ok & (amask[bi][:, tc] > 0)[:, None, :]
                    sc = torch.where(ok, sc, torch.tensor(NEG))
                    m_new = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp(m - m_new)
                    p = torch.where(inside[None, None, :],
                                    torch.exp(sc - m_new[..., None]), 0.0)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "rht,thd->rhd", p, vv)
                    m = m_new
                warps.append((acc, m, l))
            splits.append(_merge(warps))
        acc, m, l = _merge(splits) if len(splits) > 1 else splits[0]
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return (torch.stack(accs).reshape(b * beams, d),
            torch.stack(ms).reshape(b * beams, n_heads),
            torch.stack(ls).reshape(b * beams, n_heads))


def _inputs(b, s, h, hd, beams, mode, dtype, seed, window=False):
    rng = np.random.RandomState(seed)
    d = h * hd
    q = torch.tensor(rng.randn(b * beams, d).astype(np.float32)).to(dtype)
    rows = s + 40 if window else s
    kc, vc = (torch.tensor(rng.randn(b, rows, d).astype(np.float32))
              .to(dtype)[:, :s] for _ in range(2))
    amask = None
    if mode == "amask":
        amask = torch.tensor((rng.rand(b, beams, s) > 0.6).astype(np.int8))
        amask[:, :, 0] = 1                  # every row keeps a valid position
        if s > 2 * BEAM_TILE:               # a split with no valid position
            amask[:, :, BEAM_TILE:2 * BEAM_TILE] = 0
    return q, kc, vc, amask


def _close(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    for name, g, w in zip(("acc", "m", "l"), got, want):
        np.testing.assert_allclose(
            np.asarray(g, np.float32), np.asarray(w, np.float32), atol=atol,
            rtol=rtol, err_msg=f"{name} vs {what}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("mode,beams,s,window", [
    ("none", 1, 136, False), ("none", 4, 200, True),
    ("amask", 3, 200, True), ("amask", 4, 136, False),
    ("amask", 16, 72, True), ("pos", 8, 136, False),
    ("pos", 4, 200, False),
])
def test_schedule_matches_jax_and_plain(mode, beams, s, window, dtype):
    b, h, hd = 2, 2, 64
    q, kc, vc, amask = _inputs(b, s, h, hd, beams, mode, dtype,
                               seed=s + beams, window=window)
    assert kc.is_contiguous() != window
    pos = {"pos": 70, "none": None, "amask": None}[mode]
    kw = dict(beams=beams, n_heads=h, head_dim=hd)
    got = _emulate(q, kc, vc, amask, pos, **kw)
    ref = ops.beam_attend_parts(q, kc, vc, amask, pos, **kw)
    _close(got, ref, dtype, "plain")
    jq, jk, jv = (jnp.asarray(x.float().numpy(), JNP[dtype])
                  for x in (q, kc, vc))
    jm = None if amask is None else jnp.asarray(amask.numpy())
    want = jax_da.beam_attend_parts(jq, jk, jv, jm, pos, block_s=8,
                                    interpret=True, **kw)
    _close(got, want, dtype, "JAX")


@pytest.mark.parametrize("beams", [1, 3, 4, 16])
@pytest.mark.parametrize("hd", [64, 128])
def test_schedule_per_row_pos_and_ragged_s(beams, hd):
    """Per-row pos on a split's last and first positions, and past S, over a
    ragged S (77, 261): against the plain version (JAX's kernel takes one
    scalar pos)."""
    for s, pos in ((77, [76, 10]), (261, [63, 128]), (261, [64, 5000])):
        q, kc, vc, _ = _inputs(2, s, 2, hd, beams, "pos", torch.float32,
                               seed=s + hd + beams)
        pos_t = torch.tensor(pos, dtype=torch.int32)
        kw = dict(beams=beams, n_heads=2, head_dim=hd)
        got = _emulate(q, kc, vc, None, pos_t, **kw)
        ref = ops.beam_attend_parts_plain(q, kc, vc, None, pos_t, **kw)
        _close(got, ref, torch.float32, f"plain (S {s}, pos {pos})")
