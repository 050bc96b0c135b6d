"""The bf16 flash forward's schedule, on the CPU.

``csrc/flash_fwd.cu`` runs only on the card.  Here its schedule is
emulated and held against JAX's ``flash_attention`` in interpret mode and
against the port's plain version: 128-row q tiles launched heavy-first,
128-key tiles walked up to the diagonal, TMA's zero rows past S masked by
index, scores scaled after the product and kept in log2 units (``exp2``
with log2(e) folded into the scale), the finite ``-1e30`` sentinel, ``l``
summed from the unrounded ``p`` and the PV product from ``p`` rounded to
bf16, ``o = acc / max(l, 1e-37)`` rounded once.  Inputs come from seeded
numpy.  Tolerances: fp32 atol 1e-5 (sums in another order); bf16 atol =
rtol = 2e-2 (8 mantissa bits).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu_torch import ops

ROWS = 128                      # q rows a block: two consumer warpgroups
KEY_TILE = 128
NEG = -1e30
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _q_tiles(s, causal):
    """The kernel's walk: per q tile in launch order (block ``i`` of a
    head takes tile ``n_qt - 1 - i``, heavy first), its ``(q0,
    n_key_tiles)``; a causal tile stops at the key tile of its diagonal."""
    n_qt, n_kv = -(-s // ROWS), -(-s // KEY_TILE)
    order = []
    for i in range(n_qt):
        q0 = (n_qt - 1 - i) * ROWS
        n_kt = min(n_kv, (q0 + ROWS - 1) // KEY_TILE + 1) if causal else n_kv
        order.append((q0, n_kt))
    return order


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 77, 128, 200, 512, 1000, 1024, 8192])
def test_q_tiles_cover_each_row_once(s):
    """Serving's prefill (S 512), the LM step's (S 1024) and a long
    prompt: every q row lies in exactly one tile, and every key a causal
    row needs lies in a tile its block walks."""
    tiles = _q_tiles(s, True)
    rows = torch.zeros(s, dtype=torch.int64)
    for q0, n_kt in tiles:
        rows[q0:q0 + ROWS] += 1
        assert n_kt * KEY_TILE >= min(s, q0 + ROWS)
    assert bool((rows == 1).all())


@pytest.mark.parametrize("s", [1, 77, 128, 200, 512, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_plan_walks_heavy_first_and_stops_at_the_diagonal(s, causal):
    tiles = _q_tiles(s, causal)
    assert sorted(q0 for q0, _ in tiles) == list(range(0, s, ROWS))
    assert [q0 for q0, _ in tiles] == sorted((q0 for q0, _ in tiles),
                                             reverse=True)
    n_kv = -(-s // KEY_TILE)
    for q0, n_kt in tiles:
        if not causal:
            assert n_kt == n_kv
            continue
        # up to the tile of the diagonal of the block's last real row
        assert n_kt == (min(s, q0 + ROWS) - 1) // KEY_TILE + 1
    costs = [n_kt for _, n_kt in tiles]
    assert costs == sorted(costs, reverse=True)


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated
# ---------------------------------------------------------------------------

def _rows(x, lo, hi):
    """Rows lo..hi-1 of x (..., S, D), zeros past S (TMA's fill)."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]))
    n = max(0, min(hi, x.shape[-2]) - lo)
    out[..., :n, :] = x[..., lo:lo + n, :].float()
    return out


def _emulate(q, k, v, causal):
    """``flash_attention`` as the bf16 kernel schedules it (fp32 inputs
    keep fp32 where the kernel would hold bf16)."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    rows = ROWS
    qh = q.transpose(1, 2)                                  # (B, H, S, D)
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1)  # q head h reads
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)  # kv head h / g
    sl2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    out = torch.empty((b, h, s, d), dtype=q.dtype)
    lse = torch.empty((b, h, s))
    for q0, n_kt in _q_tiles(s, causal):
        qt = _rows(qh, q0, q0 + rows)
        row = torch.arange(q0, q0 + rows)[:, None]
        m = torch.full((b, h, rows, 1), NEG)
        l = torch.zeros((b, h, rows, 1))
        acc = torch.zeros((b, h, rows, d))
        for kt in range(n_kt):
            k0 = kt * KEY_TILE
            col = torch.arange(k0, k0 + KEY_TILE)[None, :]
            x = (qt @ _rows(kh, k0, k0 + KEY_TILE).transpose(-1, -2)) * sl2
            edge = k0 + KEY_TILE > s or (causal and k0 + KEY_TILE - 1 > q0)
            ok = (col < s) & (col <= row) if causal else (col < s) & (row >= 0)
            if edge:
                x = torch.where(ok, x, torch.tensor(NEG))
            mx = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx)
            if edge:
                p = torch.where(ok, p, torch.zeros(()))
            l = l * alpha + p.sum(-1, keepdim=True)   # the unrounded p
            pv = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 \
                else p
            acc = acc * alpha + pv @ _rows(vh, k0, k0 + KEY_TILE)
            m = mx
        n = min(s, q0 + rows) - q0
        lc = l.clamp_min(1e-37)
        out[:, :, q0:q0 + n] = (acc / lc)[:, :, :n].to(q.dtype)
        lse[:, :, q0:q0 + n] = (m * math.log(2) + torch.log(lc))[:, :, :n, 0]
    return out.transpose(1, 2).contiguous(), lse


def _inputs(b, s, h, group, d, dtype, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, h // group, d).astype(np.float32)
    v = rng.randn(b, s, h // group, d).astype(np.float32)
    return [torch.tensor(x).to(dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("s,group,d,causal", [
    (1, 1, 64, True), (1, 3, 128, False),
    (77, 2, 64, True), (77, 3, 128, False),
    (200, 1, 128, True), (200, 2, 64, False),
    (512, 3, 64, True), (512, 1, 128, False),
])
def test_schedule_matches_jax_and_plain(s, group, d, causal, dtype):
    b, h = 1, 6
    q, k, v = _inputs(b, s, h, group, d, dtype, seed=s + 10 * group + d)
    out, lse = _emulate(q, k, v, causal)
    assert out.dtype == dtype and out.shape == q.shape
    atol, rtol = TOL[dtype]
    ref, ref_lse = ops.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=atol, rtol=rtol)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), JNP[dtype])
                  for x in (q, k, v))
    want, want_lse = jax_flash(jq, jk, jv, causal=causal, return_lse=True,
                               interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=atol, rtol=rtol)
