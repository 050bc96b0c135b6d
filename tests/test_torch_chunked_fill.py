"""The chunked fill of the port's ``_decoder_core`` vs the JAX package's, on
the CPU.

``attn_block`` at ``s_q > 1`` with a nonzero write position and valid
length: a block of new tokens written into a cache that already holds a
prefix, query i attending ``[0, q_valid + i + 1)``.  Both forms: one scalar
start for every row, and one start per row (an ``(N,)`` vector, the
serving pool's contract).  MHA with learned positions and GQA (2 KV heads
for 4 query heads) with RoPE.  The same seeded numpy inputs go through
JAX's ``attn_block`` (inside a size-1 ``shard_map``, its einsum fallback)
and the port's; the block's output and both caches must agree to rtol
1e-5 with an atol of 1e-5 x the tensor's largest |value| (fp32; the two
sum in another order, and an entry near 0 keeps only the absolute
error), the repo's CPU tolerance for the TP layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu as mn
from chainermn_tpu._compat import shard_map
from chainermn_tpu.parallel import decode as jdec
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel.transformer import transformer_lm_specs
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.parallel import decode as tdec

VOCAB, D, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 64
HEAD_DIM = D // HEADS
N, TOTAL, S_Q = 3, 24, 5
RTOL = 1e-5

CASES = {"mha_learned": (None, "learned"), "gqa_rope": (2, "rope")}


def _params(n_kv_heads, pos_impl):
    jp = jax_init(jax.random.PRNGKey(3), VOCAB, D, HEADS, LAYERS,
                  max_len=MAX_LEN, pos_impl=pos_impl, n_kv_heads=n_kv_heads)
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jp, from_jax(host, device="cpu")


def _inputs(n_kv_heads, per_row):
    """x, the caches (a filled prefix, zeros past it), the positions and
    the write starts: scalar 7, or 2 / 9 / 13 per row."""
    rng = np.random.RandomState(11)
    kv = (n_kv_heads or HEADS) * HEAD_DIM
    x = rng.randn(N, S_Q, D).astype(np.float32)
    kc = rng.randn(N, TOTAL, kv).astype(np.float32)
    vc = rng.randn(N, TOTAL, kv).astype(np.float32)
    start = (np.array([2, 9, 13], np.int32) if per_row
             else np.int32(7))
    pos = (start[:, None] if per_row else start) + np.arange(S_Q)
    # rows past the prefix hold stale values, as a recycled slot does:
    # the mask, not zeros, keeps them out
    return x, kc, vc, pos.astype(np.int32), start


def _jax_block(jp, x, kc, vc, pos, start, per_row):
    specs = transformer_lm_specs(jp, "model")
    mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
    # a scalar start rides as a Python int, as JAX's callers pass it
    scalar = None if per_row else int(start)

    def fn(p, x, kc, vc, pos, start):
        _, attn_block, _, _ = jdec._decoder_core(p, HEAD_DIM, "model")
        w = start if per_row else scalar
        return attn_block(x, p["blocks"][0], kc, vc, pos, w, w)

    out = jax.jit(shard_map(fn, mesh=mesh,
                            in_specs=(specs, P(), P(), P(), P(), P()),
                            out_specs=(P(), P(), P()), check_vma=False))(
        jp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos), jnp.asarray(start))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_fill_equals_jax_decoder_core(case, per_row):
    n_kv, pos_impl = CASES[case]
    jp, tp = _params(n_kv, pos_impl)
    x, kc, vc, pos, start = _inputs(n_kv, per_row)
    want = _jax_block(jp, x, kc, vc, pos, start, per_row)
    _, attn_block, _, _ = tdec._decoder_core(tp, HEAD_DIM)
    w = torch.from_numpy(start) if per_row else int(start)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = attn_block(torch.from_numpy(x), tp["blocks"][0], tkc, tvc,
                     torch.from_numpy(pos).long(), w, w)
    for g, wnt, name in zip(got, want, ("out", "k_cache", "v_cache")):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=RTOL,
                                   atol=RTOL * np.abs(wnt).max(),
                                   err_msg=name)
    # the caches were written in place, at the starts, and nowhere else
    assert got[1] is tkc and got[2] is tvc
    rows = (start[:, None] if per_row else np.full((N, 1), start)) \
        + np.arange(S_Q)
    untouched = np.ones((N, TOTAL), bool)
    untouched[np.arange(N)[:, None], rows] = False
    np.testing.assert_array_equal(tkc.numpy()[untouched], kc[untouched])


def test_chunked_fill_continues_a_prefill():
    """A prompt fed as a prefill of 6 and a chunk of 4 through every layer
    gives the hidden states of the 10-token prefill at the chunk's
    positions (the same function, summed in another order)."""
    _, tp = _params(2, "rope")
    tokens = torch.from_numpy(
        np.random.RandomState(2).randint(0, VOCAB, (2, 10)))
    embed, attn_block, _, _ = tdec._decoder_core(tp, HEAD_DIM)
    whole = embed(tokens, torch.arange(10))
    part = embed(tokens[:, 6:], torch.arange(6, 10))
    head = embed(tokens[:, :6], torch.arange(6))
    for blk in tp["blocks"]:
        kw = torch.zeros(2, 16, 2 * HEAD_DIM)
        whole, _, _ = attn_block(whole, blk, kw, kw.clone(),
                                 torch.arange(10), 0, 0)
        kc, vc = torch.zeros(2, 16, 2 * HEAD_DIM), torch.zeros(
            2, 16, 2 * HEAD_DIM)
        head, kc, vc = attn_block(head, blk, kc, vc, torch.arange(6), 0, 0)
        part, kc, vc = attn_block(part, blk, kc, vc, torch.arange(6, 10),
                                  6, 6)
    np.testing.assert_allclose(part.numpy(), whole[:, 6:].numpy(),
                               rtol=1e-5, atol=1e-5)
