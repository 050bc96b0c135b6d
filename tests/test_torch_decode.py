"""Port LM layers and KV-cache decoding vs the JAX package, on the CPU.

Params come from the JAX package's ``init_tp_transformer_lm`` (d 32, 4
heads, 2 layers, vocab 64, max_len 64) and reach the port through
``chainermn_tpu_torch.convert.from_jax``; inputs are seeded numpy.  The
JAX decode functions run inside a size-1 ``shard_map`` (the model axis
bound, as the JAX package calls them).  Tolerances: fp32 atol 1e-4 for
hidden states and caches (the port's plain attention sums in another
order); greedy, sampled and beam tokens must be equal.  The JAX
generators run on the one-device CPU mesh, where ``attend_impl="auto"``
takes the einsum path; the port's beam attends through the beam kernel's
plain version there, and through the einsum oracle with
``attend_impl="einsum"``.
"""

from functools import partial

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
from chainermn_tpu.parallel import make_lm_beam_generator as jax_beam
from chainermn_tpu.parallel import make_lm_generator as jax_generator
from chainermn_tpu.parallel import tensor_parallel as jtp
from chainermn_tpu.parallel import transformer as jtr
from chainermn_tpu.parallel.transformer import transformer_lm_specs
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.parallel import decode as tdec
from chainermn_tpu_torch.parallel import tensor_parallel as ttp
from chainermn_tpu_torch.parallel import transformer as ttr

VOCAB, D, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 64
HEAD_DIM = D // HEADS
ATOL = 1e-4


def _params(pos_impl="learned", n_kv_heads=None, seed=0):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=MAX_LEN, pos_impl=pos_impl, n_kv_heads=n_kv_heads)
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jp, from_jax(host, device="cpu")


def _mesh():
    return mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])


def _smap(fn, jp, extra_specs, out_specs):
    specs = transformer_lm_specs(jp, "model")
    return jax.jit(shard_map(fn, mesh=_mesh(), in_specs=(specs,) + extra_specs,
                             out_specs=out_specs, check_vma=False))


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm_and_dense_layers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, D).astype(np.float32)
    scale, bias = rng.randn(D).astype(np.float32), rng.randn(D).astype(np.float32)
    w = rng.randn(D, 3 * D).astype(np.float32)
    bw = rng.randn(3 * D).astype(np.float32)
    w2 = rng.randn(3 * D, D).astype(np.float32)
    t = torch.tensor
    np.testing.assert_allclose(
        _np(ttr._layer_norm(t(x), t(scale), t(bias))),
        np.asarray(jtr._layer_norm(x, scale, bias)), atol=1e-5)
    np.testing.assert_allclose(
        _np(ttp.column_parallel_dense(t(x), t(w), t(bw))),
        np.asarray(jtp.column_parallel_dense(x, w, bw, axis_name="model")),
        atol=1e-4)
    h = rng.randn(2, 5, 3 * D).astype(np.float32)
    row = shard_map(partial(jtp.row_parallel_dense, axis_name="model"),
                    mesh=_mesh(), in_specs=(P(), P(), P()), out_specs=P())
    np.testing.assert_allclose(_np(ttp.row_parallel_dense(t(h), t(w2), t(bias))),
                               np.asarray(row(h, w2, bias)), atol=1e-4)


def test_tp_mlp_uses_tanh_gelu_like_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, D).astype(np.float32)
    p = {"wi": rng.randn(D, 4 * D).astype(np.float32),
         "bi": rng.randn(4 * D).astype(np.float32),
         "wo": rng.randn(4 * D, D).astype(np.float32) * 0.1,
         "bo": rng.randn(D).astype(np.float32)}
    mlp = shard_map(partial(jtp.tp_mlp, axis_name="model"), mesh=_mesh(),
                    in_specs=(P(), P()), out_specs=P())
    got = ttp.tp_mlp(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(_np(got), np.asarray(mlp(x, p)), atol=1e-4)


def test_vocab_parallel_embedding_matches_jax():
    rng = np.random.RandomState(2)
    table = rng.randn(VOCAB, D).astype(np.float32)
    ids = rng.randint(0, VOCAB, (3, 4)).astype(np.int32)
    emb = shard_map(partial(jtp.vocab_parallel_embedding, axis_name="model"),
                    mesh=_mesh(), in_specs=(P(), P()), out_specs=P())
    got = ttp.vocab_parallel_embedding(torch.tensor(ids), torch.tensor(table))
    np.testing.assert_array_equal(_np(got), np.asarray(emb(ids, table)))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, HEADS, HEAD_DIM).astype(np.float32)
    pos = (rng.randint(0, 60, (2, 5)) if per_row else np.arange(7, 12)
           ).astype(np.int32)
    np.testing.assert_allclose(
        _np(ttr.apply_rope(torch.tensor(x), torch.tensor(pos))),
        np.asarray(jtr.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_project_qkv_both_layouts_match_jax(n_kv_heads):
    jp, tp = _params(n_kv_heads=n_kv_heads)
    rng = np.random.RandomState(4)
    h = rng.randn(2, 5, D).astype(np.float32)
    ja, ta = jp["blocks"][0]["attn"], tp["blocks"][0]["attn"]
    proj = shard_map(partial(jtr._project_qkv, head_dim=HEAD_DIM,
                             axis_name="model"),
                     mesh=_mesh(),
                     in_specs=(P(), jax.tree_util.tree_map(lambda _: P(), ja)),
                     out_specs=(P(), P(), P()))
    want = proj(h, ja)
    got = ttr._project_qkv(torch.tensor(h), ta, HEAD_DIM)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("n_kv_heads,pos_impl", [(None, "learned"),
                                                 (2, "rope")])
def test_init_matches_jax_layout_and_scales(n_kv_heads, pos_impl):
    """Same tree, shapes and dtypes as the JAX init; same distributions
    (He-normal weights, 0.02 positions, zero biases, unit norms)."""
    tp = ttr.init_tp_transformer_lm(
        torch.Generator().manual_seed(0), 256, 64, HEADS, LAYERS,
        max_len=MAX_LEN, n_kv_heads=n_kv_heads, pos_impl=pos_impl,
        device="cpu")
    jshape = jax_init(jax.random.PRNGKey(0), 256, 64, HEADS, LAYERS,
                      max_len=MAX_LEN, pos_impl=pos_impl,
                      n_kv_heads=n_kv_heads)
    jleaves = jax.tree_util.tree_leaves_with_path(jshape)
    tflat = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert {jax.tree_util.keystr(k) for k, _ in jleaves} == \
        {jax.tree_util.keystr(k) for k in tflat}
    for k, leaf in jleaves:
        t = tflat[k]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    blk = tp["blocks"][0]
    w = blk["mlp"]["wi"]
    assert abs(float(w.std()) - (2.0 / 64) ** 0.5) < 0.02
    assert abs(float(tp["embed"].std()) - (2.0 / 64) ** 0.5) < 0.02
    assert float(blk["mlp"]["bi"].abs().max()) == 0.0
    assert float((blk["ln1_scale"] - 1).abs().max()) == 0.0
    if pos_impl == "learned":
        assert abs(float(tp["pos_embed"].std()) - 0.02) < 0.002
    else:
        assert "pos_embed" not in tp


# ---------------------------------------------------------------------------
# prefill, tick, generate
# ---------------------------------------------------------------------------

def _jax_prefill(jp, prompt, total):
    fn = _smap(partial(jdec.lm_prefill, total=total, head_dim=HEAD_DIM,
                       axis_name="model"), jp, (P(),), P())
    return fn(jp, prompt)


@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
def test_lm_prefill_matches_jax(pos_impl):
    jp, tp = _params(pos_impl)
    prompt = np.random.RandomState(5).randint(0, VOCAB, (2, 9)).astype(np.int32)
    h_j, caches_j = _jax_prefill(jp, prompt, 16)
    h_t, caches_t = tdec.lm_prefill(tp, torch.tensor(prompt, dtype=torch.long),
                                    16, head_dim=HEAD_DIM)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), atol=ATOL)
    for (kt, vt), (kj, vj) in zip(caches_t, caches_j):
        np.testing.assert_allclose(_np(kt), np.asarray(kj), atol=ATOL)
        np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=ATOL)


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
def test_lm_decode_tick_matches_jax(pos_impl, per_row):
    jp, tp = _params(pos_impl)
    rng = np.random.RandomState(6)
    prompt = rng.randint(0, VOCAB, (3, 8)).astype(np.int32)
    total = 20
    _, caches_j = _jax_prefill(jp, prompt, total)
    tokens = rng.randint(0, VOCAB, (3,)).astype(np.int32)
    pos = np.array([8, 11, 19], np.int32) if per_row else 8
    cache_specs = [(P(), P()) for _ in range(LAYERS)]
    tick = _smap(partial(jdec.lm_decode_tick, head_dim=HEAD_DIM,
                         axis_name="model"), jp,
                 (P(), cache_specs, P()), (P(), cache_specs))
    h_j, new_j = tick(jp, tokens, caches_j,
                      jnp.asarray(pos) if per_row else jnp.int32(pos))
    caches_t = [(torch.tensor(np.asarray(k)), torch.tensor(np.asarray(v)))
                for k, v in caches_j]
    pos_t = torch.tensor(pos, dtype=torch.int32) if per_row else pos
    h_t, new_t = tdec.lm_decode_tick(tp, torch.tensor(tokens, dtype=torch.long),
                                     caches_t, pos_t, head_dim=HEAD_DIM)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), atol=ATOL)
    for (kt, vt), (kj, vj) in zip(new_t, new_j):
        np.testing.assert_allclose(_np(kt), np.asarray(kj), atol=ATOL)
        np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=ATOL)
    # the greedy pick agrees too
    pick = shard_map(partial(jdec._greedy_token, axis_name="model"),
                     mesh=_mesh(), in_specs=(P(), P()), out_specs=P())
    np.testing.assert_array_equal(
        tdec._greedy_token(tp["embed"], h_t).numpy(),
        np.asarray(pick(jp["embed"], h_j)))


@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
def test_lm_generate_token_exact_vs_make_lm_generator(pos_impl):
    jp, tp = _params(pos_impl, seed=1)
    prompt = np.random.RandomState(7).randint(0, VOCAB, (3, 6)).astype(np.int32)
    want = np.asarray(jax_generator(_mesh(), "model", head_dim=HEAD_DIM,
                                    max_new_tokens=10)(jp, prompt))
    gen = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=10)
    got = gen(tp, prompt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_ties_go_to_lowest_index():
    table = torch.zeros(8, 4)
    table[2] = table[5] = torch.ones(4)
    assert tdec._greedy_token(table, torch.ones(1, 4)).tolist() == [2]


def test_unported_paths_raise():
    _, tp = _params()
    embed, attn_block, _, _ = tdec._decoder_core(tp, HEAD_DIM)
    x = embed(torch.zeros(1, 3, dtype=torch.long), torch.arange(3))
    kc = torch.zeros(1, 16, D)
    with pytest.raises(NotImplementedError, match="chunked fill"):
        attn_block(x, tp["blocks"][0], kc, kc.clone(), torch.arange(3), 4, 4)


def test_learned_positions_past_the_table_are_clamped():
    """A free serving slot's position drifts past max_len: the lookup is
    clamped (JAX fills those rows) and the tick still runs."""
    _, tp = _params()
    _, caches = tdec.lm_prefill(tp, torch.zeros(2, 4, dtype=torch.long), 16,
                                head_dim=HEAD_DIM)
    h, _ = tdec.lm_decode_tick(tp, torch.zeros(2, dtype=torch.long), caches,
                               torch.tensor([4, MAX_LEN + 30],
                                            dtype=torch.int32),
                               head_dim=HEAD_DIM)
    assert torch.isfinite(h).all()


# ---------------------------------------------------------------------------
# GQA decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
def test_gqa_lm_decode_tick_matches_jax(pos_impl, per_row):
    jp, tp = _params(pos_impl, n_kv_heads=2)
    rng = np.random.RandomState(16)
    prompt = rng.randint(0, VOCAB, (3, 8)).astype(np.int32)
    total = 20
    _, caches_j = _jax_prefill(jp, prompt, total)
    tokens = rng.randint(0, VOCAB, (3,)).astype(np.int32)
    pos = np.array([8, 12, 19], np.int32) if per_row else 8
    cache_specs = [(P(), P()) for _ in range(LAYERS)]
    tick = _smap(partial(jdec.lm_decode_tick, head_dim=HEAD_DIM,
                         axis_name="model"), jp,
                 (P(), cache_specs, P()), (P(), cache_specs))
    h_j, new_j = tick(jp, tokens, caches_j,
                      jnp.asarray(pos) if per_row else jnp.int32(pos))
    caches_t = [(torch.tensor(np.asarray(k)), torch.tensor(np.asarray(v)))
                for k, v in caches_j]
    pos_t = torch.tensor(pos, dtype=torch.int32) if per_row else pos
    h_t, new_t = tdec.lm_decode_tick(tp, torch.tensor(tokens, dtype=torch.long),
                                     caches_t, pos_t, head_dim=HEAD_DIM)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), atol=1e-5)
    for (kt, vt), (kj, vj) in zip(new_t, new_j):
        np.testing.assert_allclose(_np(kt), np.asarray(kj), atol=1e-5)
        np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=1e-5)


@pytest.mark.parametrize("n_kv_heads", [2, 1])
@pytest.mark.parametrize("pos_impl", ["learned", "rope"])
def test_gqa_lm_generate_token_exact(pos_impl, n_kv_heads):
    jp, tp = _params(pos_impl, n_kv_heads=n_kv_heads, seed=2)
    prompt = np.random.RandomState(17).randint(0, VOCAB, (3, 6)).astype(
        np.int32)
    want = np.asarray(jax_generator(_mesh(), "model", head_dim=HEAD_DIM,
                                    max_new_tokens=10)(jp, prompt))
    got = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=10)(
        tp, prompt)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("pos_impl,n_kv_heads", [("learned", None),
                                                 ("rope", 2)])
def test_sampled_lm_generate_token_exact(pos_impl, n_kv_heads, batch):
    """``temperature=0.7`` with a key: the port draws JAX's threefry
    Gumbel noise (one ``(B, V)`` uniform per step), so the tokens are
    JAX's."""
    jp, tp = _params(pos_impl, n_kv_heads=n_kv_heads, seed=3)
    prompt = np.random.RandomState(18).randint(0, VOCAB, (batch, 6)).astype(
        np.int32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax_generator(_mesh(), "model", head_dim=HEAD_DIM,
                                    max_new_tokens=12, temperature=0.7)(
        jp, prompt, key))
    got = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=12,
                                 temperature=0.7)(tp, prompt,
                                                  np.asarray(key))
    np.testing.assert_array_equal(got.numpy(), want)
    # sampling is live: another key draws another sequence
    other = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=12,
                                   temperature=0.7)(
        tp, prompt, np.asarray(jax.random.PRNGKey(22)))
    assert not torch.equal(other, got)


def test_sampling_requires_an_explicit_rng():
    _, tp = _params()
    gen = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=2,
                                 temperature=0.7)
    with pytest.raises(ValueError, match="rng"):
        gen(tp, np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="rng"):
        tdec.lm_generate(tp, torch.zeros(1, 4, dtype=torch.long),
                         head_dim=HEAD_DIM, max_new_tokens=2, temperature=0.7)
    # greedy ignores the key
    greedy = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=3)
    assert torch.equal(greedy(tp, np.zeros((1, 4), np.int32)),
                       greedy(tp, np.zeros((1, 4), np.int32),
                              np.array([1, 2], np.uint32)))


def test_next_token_matches_jax_per_row():
    """The serving tick's selection: greedy rows, and sampled rows each
    with its own key and step position, vs JAX's ``_next_token``."""
    jp, tp = _params(seed=4)
    rng = np.random.RandomState(19)
    h = rng.randn(5, D).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), i))
                     for i in range(5)])
    temps = np.array([0.0, 0.7, 1.3, 0.0, 0.5], np.float32)
    step = np.array([6, 9, 12, 3, 40], np.int32)
    fn = shard_map(lambda t, hh, k, tt, sp: jdec._next_token(
        t, hh, "model", k, tt, sp), mesh=_mesh(), in_specs=(P(),) * 5,
        out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(fn)(jp["embed"], h, keys, temps, step))
    got = tdec._next_token(tp["embed"], torch.tensor(h), keys, temps,
                           torch.tensor(step))
    np.testing.assert_array_equal(got.numpy(), want)


def test_next_token_greedy_rows_are_greedy_token_bits():
    _, tp = _params(seed=5)
    h = torch.tensor(np.random.RandomState(20).randn(4, D).astype(np.float32))
    greedy = tdec._greedy_token(tp["embed"], h)
    keys = np.array([[0, 1], [0, 2], [0, 3], [0, 4]], np.uint32)
    for temps in (None, np.zeros(4, np.float32),
                  np.array([0.0, 0.9, 0.0, 0.9], np.float32)):
        got = tdec._next_token(tp["embed"], h, keys, temps,
                               torch.tensor([5, 5, 5, 5]))
        rows = [0, 2] if temps is not None and temps.any() else [0, 1, 2, 3]
        assert got.dtype == torch.int32
        assert torch.equal(got[rows], greedy[rows])


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def test_top_k_ties_go_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    vals, idx = tdec._top_k(x, 4)
    assert idx.tolist() == [[1, 2, 4, 5]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert ji.tolist() == idx.tolist()


@pytest.mark.parametrize("beam", [2, 4])
@pytest.mark.parametrize("pos_impl,n_kv_heads", [("learned", None),
                                                 ("rope", None),
                                                 ("learned", 2),
                                                 ("rope", 2)])
@pytest.mark.parametrize("lazy", [True, False])
def test_beam_token_exact_vs_jax(lazy, pos_impl, n_kv_heads, beam):
    jp, tp = _params(pos_impl, n_kv_heads=n_kv_heads, seed=6)
    prompt = np.random.RandomState(22).randint(0, VOCAB, (3, 6)).astype(
        np.int32)
    kw = dict(head_dim=HEAD_DIM, max_new_tokens=9, beam_size=beam,
              lazy_reorder=lazy)
    want = np.asarray(jax_beam(_mesh(), "model", **kw)(jp, prompt))
    got = tdec.make_lm_beam_generator(**kw)(tp, prompt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos_impl,n_kv_heads", [("learned", None),
                                                 ("rope", 2)])
def test_beam_lazy_equals_physical_and_einsum(pos_impl, n_kv_heads):
    """In the port: the lazy beam through the beam kernel's plain version,
    through the einsum oracle, and the physical cache gather agree."""
    _, tp = _params(pos_impl, n_kv_heads=n_kv_heads, seed=7)
    prompt = np.random.RandomState(23).randint(0, VOCAB, (2, 5)).astype(
        np.int32)
    kw = dict(head_dim=HEAD_DIM, max_new_tokens=12, beam_size=3)
    runs = [tdec.make_lm_beam_generator(lazy_reorder=lazy, attend_impl=impl,
                                        **kw)(tp, prompt)
            for lazy, impl in ((True, "auto"), (True, "einsum"),
                               (False, "auto"))]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    # beam 1 is greedy
    greedy = tdec.make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=12)(
        tp, prompt)
    beam1 = tdec.make_lm_beam_generator(head_dim=HEAD_DIM, max_new_tokens=12,
                                        beam_size=1)(tp, prompt)
    assert torch.equal(beam1, greedy)
    with pytest.raises(ValueError, match="attend_impl"):
        tdec.make_lm_beam_generator(attend_impl="pallas", **kw)(tp, prompt)
