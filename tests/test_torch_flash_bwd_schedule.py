"""The bf16 flash backward's schedule, on the CPU.

``csrc/flash_bwd.cu`` runs only on the card.  Here its two walks are
checked for coverage, and its schedule is emulated and held against the
gradients of JAX's ``flash_attention(..., backward="pallas",
interpret=True)`` and against the port's plain backward:

* ``delta = rowsum(dO·O) − dlse`` in fp32, the first launch;
* dk/dv: a block per (batch, KV head, 128-key tile), each of its two
  consumers owning 64 keys; it walks the group's q heads and their 64-row
  q tiles from the diagonal on, skipping a tile the causal mask empties
  for its keys; per tile ``S^T = K Q^T`` and ``dP^T = V dO^T`` in fp32,
  ``P^T = exp2(S^T·scale·log2e − lse·log2e)`` masked by index (TMA's zero
  rows past S included), ``dS^T = P^T (dP^T − delta)·scale``, then ``dV +=
  bf16(P^T) dO`` and ``dK += bf16(dS^T) Q`` in fp32, rounded once;
* dq: a block per (batch, head, 128-row q tile), heavy tiles first, each
  consumer owning 64 rows; 64-key tiles up to the diagonal; ``dQ +=
  bf16(dS) K``, rounded once.

Inputs come from seeded numpy.  Tolerances: fp32 atol 1e-5, rtol 1e-4
(the products are summed tile by tile in another order than JAX's and the
plain version's, and exp2 takes log2(e) folded into the scale); bf16 atol
= rtol = 2e-2 (8 mantissa bits: the gradients are rounded to bf16 once,
and the rounded p and ds of the two schedules may differ by a unit where
their fp32 sums do).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu_torch import ops

BLOCK = 128                     # rows a block owns: two consumers of 64
TILE = 64                       # rows of a streamed tile
LOG2E = math.log2(math.e)
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _dkdv_walk(s, causal, group):
    """dk/dv's walk: per (key tile, consumer), in the kernel's order, the
    ``(g, i0)`` q tiles it computes (head ``g`` of the KV head's group,
    first q row ``i0``); the tiles it skips are left out."""
    walk = {}
    for kt in range(-(-s // BLOCK)):
        k0 = kt * BLOCK
        qt_begin = k0 // TILE if causal else 0
        for c in range(2):
            kc0 = k0 + TILE * c
            walk[(kt, c)] = [
                (g, qt * TILE) for g in range(group)
                for qt in range(qt_begin, -(-s // TILE))
                if not (causal and qt * TILE + TILE - 1 < kc0)]
    return walk


def _dq_walk(s, causal):
    """dq's walk: blocks in launch order (heavy first), per consumer the
    first key ``j0`` of each 64-key tile it computes."""
    n_qt, n_kv = -(-s // BLOCK), -(-s // TILE)
    walk = []
    for i in range(n_qt):
        q0 = (n_qt - 1 - i) * BLOCK
        n_kt = min(n_kv, (q0 + BLOCK - 1) // TILE + 1) if causal else n_kv
        for c in range(2):
            qc0 = q0 + TILE * c
            walk.append((q0, c, [it * TILE for it in range(n_kt)
                                 if not (causal and it * TILE > qc0 + TILE - 1)]))
    return walk


def _needed(s, causal):
    q = torch.arange(s)[:, None]
    k = torch.arange(s)[None, :]
    return (k <= q) if causal else torch.ones(s, s, dtype=torch.bool)


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 63, 64, 77, 128, 200, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_dkdv_walk_visits_each_pair_once(s, causal, group):
    """Every (q head of the group, q row, key) the mask keeps is computed by
    exactly one (block, consumer, q tile), and no tile is walked twice."""
    count = torch.zeros(group, s, s, dtype=torch.int64)
    for (kt, c), tiles in _dkdv_walk(s, causal, group).items():
        kc0 = kt * BLOCK + TILE * c
        assert len(set(tiles)) == len(tiles)
        for g, i0 in tiles:
            count[g, i0:i0 + TILE, kc0:kc0 + TILE] += 1
    need = _needed(s, causal)
    assert bool((count[:, need] == 1).all())
    # a walked tile may hold masked cells, never a pair counted twice
    assert int(count.max()) == 1


@pytest.mark.parametrize("s", [1, 63, 64, 77, 128, 200, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_walk_visits_each_pair_once_heavy_first(s, causal):
    count = torch.zeros(s, s, dtype=torch.int64)
    starts, costs = [], []
    for q0, c, keys in _dq_walk(s, causal):
        qc0 = q0 + TILE * c
        for j0 in keys:
            count[qc0:qc0 + TILE, j0:j0 + TILE] += 1
        if c == 0:
            starts.append(q0)
            costs.append(len(keys))
    assert bool((count[_needed(s, causal)] == 1).all())
    assert int(count.max()) == 1
    assert starts == sorted(starts, reverse=True)
    assert costs == sorted(costs, reverse=True)


# ---------------------------------------------------------------------------
# the kernels' schedule, emulated
# ---------------------------------------------------------------------------

def _rows(x, lo, hi):
    """Rows lo..hi-1 of x (..., S, D) in fp32, zeros past S (TMA's fill)."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]))
    n = max(0, min(hi, x.shape[-2]) - lo)
    out[..., :n, :] = x[..., lo:lo + n, :].float()
    return out


def _vals(x, lo, hi):
    """Entries lo..hi-1 of x (..., S), zeros past S."""
    out = torch.zeros(x.shape[:-1] + (hi - lo,))
    n = max(0, min(hi, x.shape[-1]) - lo)
    out[..., :n] = x[..., lo:lo + n]
    return out


def _emulate(q, k, v, out, lse, do, causal, dlse=None):
    """``flash_attention_bwd`` as the bf16 kernels schedule it (fp32 inputs
    keep fp32 where the kernels would round to bf16)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E

    def rnd(x):                 # a bf16 packing of a fragment
        return x.to(q.dtype).float()

    # first launch: delta
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    # (B, H_kv, group, S, ·): q head hkv·group + g reads KV head hkv
    qg = q.transpose(1, 2).reshape(b, hkv, group, s, d)
    dog = do.transpose(1, 2).reshape(b, hkv, group, s, d)
    lse2 = (lse.float() * LOG2E).reshape(b, hkv, group, s)
    dlt = delta.reshape(b, hkv, group, s)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)        # (B, H_kv, S, D)

    dk = torch.zeros(b, hkv, s, d)
    dv = torch.zeros(b, hkv, s, d)
    for (kt, c), tiles in _dkdv_walk(s, causal, group).items():
        kc0 = kt * BLOCK + TILE * c
        key = torch.arange(kc0, kc0 + TILE)[:, None]
        kt_, vt_ = _rows(kh, kc0, kc0 + TILE), _rows(vh, kc0, kc0 + TILE)
        acc_k = torch.zeros(b, hkv, TILE, d)
        acc_v = torch.zeros(b, hkv, TILE, d)
        for g, i0 in tiles:
            qt = _rows(qg[:, :, g], i0, i0 + TILE)
            dot = _rows(dog[:, :, g], i0, i0 + TILE)
            col = torch.arange(i0, i0 + TILE)[None, :]
            st = kt_ @ qt.transpose(-1, -2)                      # S^T
            dpt = vt_ @ dot.transpose(-1, -2)                    # dP^T
            p = torch.exp2(st * sl2 - _vals(lse2[:, :, g], i0, i0 + TILE)[
                ..., None, :])
            ok = (col < s) & (key < s)
            if causal:
                ok = ok & (key <= col)
            p = torch.where(ok, p, torch.zeros(()))
            ds = p * (dpt - _vals(dlt[:, :, g], i0, i0 + TILE)[..., None, :]) \
                * scale
            acc_v = acc_v + rnd(p) @ dot
            acc_k = acc_k + rnd(ds) @ qt
        n = max(0, min(s, kc0 + TILE) - kc0)
        dk[:, :, kc0:kc0 + n] = acc_k[:, :, :n]
        dv[:, :, kc0:kc0 + n] = acc_v[:, :, :n]

    qh, doh = q.transpose(1, 2), do.transpose(1, 2)       # (B, H, S, D)
    kq = kh.repeat_interleave(group, dim=1)               # q head h: KV h // g
    vq = vh.repeat_interleave(group, dim=1)
    lse2h, dlth = lse.float() * LOG2E, delta
    dq = torch.zeros(b, h, s, d)
    for q0, c, keys in _dq_walk(s, causal):
        qc0 = q0 + TILE * c
        row = torch.arange(qc0, qc0 + TILE)[:, None]
        qt, dot = _rows(qh, qc0, qc0 + TILE), _rows(doh, qc0, qc0 + TILE)
        l2 = _vals(lse2h, qc0, qc0 + TILE)[..., None]
        dl = _vals(dlth, qc0, qc0 + TILE)[..., None]
        acc = torch.zeros(b, h, TILE, d)
        for j0 in keys:
            kt_, vt_ = _rows(kq, j0, j0 + TILE), _rows(vq, j0, j0 + TILE)
            col = torch.arange(j0, j0 + TILE)[None, :]
            p = torch.exp2((qt @ kt_.transpose(-1, -2)) * sl2 - l2)
            ok = (col < s) & (row < s)
            if causal:
                ok = ok & (col <= row)
            p = torch.where(ok, p, torch.zeros(()))
            ds = p * ((dot @ vt_.transpose(-1, -2)) - dl) * scale
            acc = acc + rnd(ds) @ kt_
        n = max(0, min(s, qc0 + TILE) - qc0)
        dq[:, :, qc0:qc0 + n] = acc[:, :, :n]
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("s,group,d,causal,with_dlse", [
    (77, 1, 64, True, False), (77, 2, 128, False, True),
    (130, 2, 64, True, True), (130, 1, 128, False, False),
    (200, 1, 128, True, False), (200, 2, 64, False, False),
])
def test_schedule_matches_jax_and_plain(s, group, d, causal, with_dlse,
                                        dtype):
    b, h = 1, 4
    rng = np.random.RandomState(s + 10 * group + d + int(causal))
    q, do = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, h // group, d).astype(np.float32)
            for _ in range(2))
    dlse = rng.randn(b, h, s).astype(np.float32) if with_dlse else None
    qt, kt, vt, dot = (torch.tensor(x).to(dtype) for x in (q, k, v, do))
    out, lse = ops.flash_attention_plain(qt, kt, vt, causal)
    dlt = None if dlse is None else torch.tensor(dlse)
    got = _emulate(qt, kt, vt, out, lse, dot, causal, dlt)
    atol, rtol = TOL[dtype]
    ref = ops.flash_attention_bwd_plain(qt, kt, vt, out, lse, dot, causal,
                                        dlt)
    for name, g, r, x in zip("qkv", got, ref, (qt, kt, vt)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=f"d{name} vs plain")
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), JNP[dtype])
                       for x in (qt, kt, vt, dot))
    if with_dlse:
        _, vjp = jax.vjp(lambda a, b_, c: jax_flash(
            a, b_, c, causal=causal, interpret=True, backward="pallas",
            return_lse=True), jq, jk, jv)
        want = vjp((jdo, jnp.asarray(dlse)))
    else:
        _, vjp = jax.vjp(lambda a, b_, c: jax_flash(
            a, b_, c, causal=causal, interpret=True, backward="pallas"),
            jq, jk, jv)
        want = vjp(jdo)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(jnp.asarray(w, jnp.float32)),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"d{name} vs JAX")


def test_delta_is_rowsum_minus_dlse():
    """The first launch's function: ``rowsum(dO·O) − dlse`` as (B, H, S)
    fp32, the plain path's ``_delta``."""
    from chainermn_tpu_torch.ops.flash_attention import _delta

    rng = np.random.RandomState(3)
    out, do = (torch.tensor(rng.randn(2, 33, 3, 64).astype(np.float32))
               .bfloat16() for _ in range(2))
    dlse = torch.tensor(rng.randn(2, 3, 33).astype(np.float32))
    want = np.einsum("bshd,bshd->bhs", out.float().numpy(),
                     do.float().numpy()) - dlse.numpy()
    np.testing.assert_allclose(_delta(out, do, dlse).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_delta(out, do, None).numpy(),
                               want + dlse.numpy(), atol=1e-5, rtol=1e-5)
