"""The port's decoding and serving at TP = 2 vs the JAX package's, on the CPU.

The same JAX-initialised weights (sharded by ``convert.shard_from_jax``)
and prompts go through the port's ``make_lm_generator(mesh, 'model')`` /
``make_lm_beam_generator(mesh, 'model')`` on a ``('model',)`` mesh of two
gloo processes (one launch that runs every case) and through JAX's on a
``('model',)`` mesh of two virtual CPU devices: greedy (MHA, learned
positions), sampled (GQA, RoPE: each shard draws its ``(B, V/P)``
uniform from ``fold_in(fold_in(key, step), rank)``, so the tokens are
JAX's at TP = 2) and beam 4 (MHA lazy, GQA with the physical reorder);
every token equal.  ``ServingEngine(mesh=...)`` (rank 0 leads, rank 1
follows its plan) serves the staggered 8-request schedule, half the
requests sampled, against JAX's engine on the same mesh: every request's
tokens equal.  A leader whose loop raises still releases its follower.
"""

import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_lm_beam_generator as jax_beam
from chainermn_tpu.parallel import make_lm_generator as jax_generator
from chainermn_tpu.serving import ServingEngine as JaxServingEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_tp_worker import AX, serve_schedule  # noqa: E402
from test_torch_functions import launch  # noqa: E402

WORLD = 2
VOCAB, D, HEADS, LAYERS = 64, 32, 4, 2
HEAD_DIM = D // HEADS


def _params(seed, pos_impl, n_kv_heads=None):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=32, pos_impl=pos_impl, n_kv_heads=n_kv_heads)
    return jax.tree_util.tree_map(np.asarray, jp)


def _decode_cases():
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, VOCAB, (2, 6)).astype(np.int32)
    base = dict(prompt=prompt, head_dim=HEAD_DIM, max_new=8,
                temperature=0.0, key=None, kind="generate")
    return {
        "greedy_mha_learned": dict(base, params=_params(0, "learned")),
        "sampled_gqa_rope": dict(base, params=_params(1, "rope", 2),
                                 temperature=0.8,
                                 key=np.asarray(jax.random.PRNGKey(5))),
        "beam_mha_learned": dict(base, params=_params(2, "learned"),
                                 kind="beam", lazy=True, max_new=6),
        "beam_gqa_rope_physical": dict(base, params=_params(3, "rope", 2),
                                       kind="beam", lazy=False, max_new=6),
    }


def _serving_cases():
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, 6).astype(np.int32) for _ in range(8)]
    max_new = [12, 4, 4, 4, 6, 6, 6, 6]
    sample = [None if i % 2 == 0 else
              (0.7, np.asarray(jax.random.fold_in(jax.random.PRNGKey(3), i)))
              for i in range(8)]
    kw = dict(head_dim=HEAD_DIM, n_slots=4, max_total=32, queue_capacity=8,
              max_prefills_per_tick=2)
    return {name: dict(params=p, prompts=prompts, max_new=max_new,
                       sample=sample, kw=kw)
            for name, p in (("serving_mha", _params(6, "learned")),
                            ("serving_gqa", _params(7, "rope", 2)))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inp = {"decode": _decode_cases(), "serving": _serving_cases()}
    tmp = tmp_path_factory.mktemp("tpdec")
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    return inp, launch("_torch_tp_worker.py", "decode", WORLD, tmp,
                       timeout=240)[0]


def _mesh():
    return mn.make_nd_mesh((AX,), (WORLD,), jax.devices()[:WORLD])


@pytest.mark.parametrize("name", ["greedy_mha_learned", "sampled_gqa_rope",
                                  "beam_mha_learned",
                                  "beam_gqa_rope_physical"])
def test_tp_decode_tokens_equal_jax(run, name):
    inp, out = run
    case = inp["decode"][name]
    kw = dict(head_dim=HEAD_DIM, max_new_tokens=case["max_new"])
    if case["kind"] == "beam":
        want = jax_beam(_mesh(), AX, beam_size=4, lazy_reorder=case["lazy"],
                        **kw)(case["params"], case["prompt"])
    else:
        gen = jax_generator(_mesh(), AX, temperature=case["temperature"],
                            **kw)
        want = (gen(case["params"], case["prompt"], case["key"])
                if case["key"] is not None
                else gen(case["params"], case["prompt"]))
    for r, res in enumerate(out):
        np.testing.assert_array_equal(res[name], np.asarray(want),
                                      err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", ["serving_mha", "serving_gqa"])
def test_tp_serving_tokens_equal_jax(run, name):
    inp, out = run
    case = inp["serving"][name]
    eng = JaxServingEngine(case["params"], mesh=_mesh(), prefix_cache=False,
                           spill_bytes=0, **case["kw"])
    try:
        want = serve_schedule(eng, case["prompts"], case["max_new"],
                              case["sample"])
    finally:
        eng.close()
    got = out[0][name]
    assert out[1][name] is None                # the follower reports nothing
    for i, ((status, toks), w) in enumerate(zip(got, want)):
        assert status == w.status == "done", (i, status, w.status)
        assert toks == w.tokens, (i, toks, w.tokens)


def test_tp_serving_follower_returns_when_leader_raises(run):
    """The leader's loop raises between ticks and closes in ``finally``:
    the follower leaves ``follow()`` after the leader's calls, its own
    ``close()`` joins no broadcast, and both ranks meet in the next
    collective."""
    _, out = run
    lead, follow = out[0]["leader_raises"], out[1]["leader_raises"]
    assert lead[:2] == ("raised", "on_token failed"), lead
    ticks = lead[2]
    assert ticks >= 1, lead
    # the follower ran the prefill and every tick, then the stop freed it
    assert follow[0] == "followed" and follow[1] == 1 + ticks, follow
    assert lead[-1] == follow[-1] == float(WORLD)
