"""Port ops vs the JAX package's kernels, on the CPU.

The same numpy inputs (seeded) go through ``chainermn_tpu.ops`` (Pallas in
interpret mode, or the XLA paths the JAX package itself runs off-TPU) and
through ``chainermn_tpu_torch.ops``, whose wrappers take their plain
PyTorch versions for CPU tensors.  Tolerances: fp32 atol 1e-5 (the plain
flash version is one tile where the kernel is online over tiles, so sums
differ in order only); bf16 atol/rtol 2e-2 (8 mantissa bits); the append
is a copy and must be exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.decode_attention import decode_attend as jax_decode_attend
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


def test_launch_counters_reset():
    ops.flash_attention.launches = 5
    assert ops.launch_counts()["flash_fwd"] == 5
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
