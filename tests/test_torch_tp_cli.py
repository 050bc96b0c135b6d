"""The port's DP x TP CLIs vs the JAX examples' recipes, on the CPU.

``train_transformer --tp 2``, ``train_hybrid --tp 2``, ``generate --tp 2``
and ``serve --tp 2`` run in four gloo processes (a ``(2, 2)`` ``('data',
'model')`` mesh; one launch that runs all four, each CLI from JAX's
initial params through ``run(argv, params=...)``), and the JAX examples'
recipes (``examples/transformer/train_transformer.py``,
``examples/hybrid_parallel/train_hybrid.py``, ``examples/generate/
generate.py``, ``chainermn_tpu/serve.py``'s training and serving) run here
on a ``(2, 2)`` mesh of virtual CPU devices at the same small size: every
loss within rtol 1e-4 (Adam at lr 1e-2 over a few steps), the generated and
served tokens equal, and the printed lines carry the same numbers.
"""

import pickle
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import chainermn_tpu as mn
from chainermn_tpu.parallel import (init_tp_mlp_params,
                                    init_tp_transformer_lm,
                                    make_hybrid_shard_map_step,
                                    make_lm_generator, shard_pytree,
                                    state_specs_like, tp_mlp, tp_mlp_specs,
                                    tp_transformer_lm_loss,
                                    transformer_lm_specs)
from chainermn_tpu.serve import make_corpus
from chainermn_tpu.serving import ServingEngine as JaxServingEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_functions import launch  # noqa: E402

WORLD, TP = 4, 2
LM = ["--vocab", "64", "--d-model", "32", "--n-heads", "4", "--n-layers",
      "2"]
ARGV = {
    "train_transformer": ["--tp", "2", *LM, "--seq-len", "8",
                          "--batchsize", "8", "--steps", "3"],
    "train_hybrid": ["--tp", "2", "--d-model", "16", "--d-hidden", "32",
                     "--batchsize", "8", "--steps", "3"],
    "generate": ["--tp", "2", *LM, "--seq-len", "12", "--steps", "20",
                 "--prompt-len", "4", "--max-new-tokens", "6"],
    "serve": ["--tp", "2", *LM, "--seq-len", "12", "--train-steps", "20",
              "--requests", "4", "--n-slots", "2", "--prompt-len", "4",
              "--max-new-tokens", "4"],
}
HEAD_DIM = 32 // 4


def _mesh():
    return mn.make_nd_mesh(("data", "model"), (WORLD // TP, TP),
                           jax.devices()[:WORLD])


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lm_trainer(params, mesh, lr):
    specs = transformer_lm_specs(params, "model")
    opt = optax.adam(lr)
    step = make_hybrid_shard_map_step(
        partial(tp_transformer_lm_loss, head_dim=HEAD_DIM,
                axis_name="model"), opt, mesh, params, specs, donate=False)
    p = shard_pytree(params, mesh, specs)
    st = shard_pytree(opt.init(params), mesh,
                      state_specs_like(opt, params, specs))
    return step, p, st


def jax_train_transformer(params):
    mesh = _mesh()
    step, p, st = _lm_trainer(params, mesh, 1e-2)
    tokens = np.random.RandomState(0).randint(0, 64, (8, 9)).astype(np.int32)
    batch = (jax.device_put(tokens, NamedSharding(mesh, JP("data"))),)
    losses = []
    for _ in range(4):
        p, st, loss = step(p, st, batch)
        losses.append(float(loss))
    return losses


def jax_train_hybrid(params):
    mesh = _mesh()
    specs = tp_mlp_specs("model")
    opt = optax.adam(1e-2)

    def loss_fn(p, batch):
        return jnp.mean((tp_mlp(batch[0], p, axis_name="model")
                         - batch[1]) ** 2)

    step = make_hybrid_shard_map_step(loss_fn, opt, mesh, params, specs)
    p = shard_pytree(params, mesh, specs)
    st = shard_pytree(opt.init(params), mesh,
                      state_specs_like(opt, params, specs))
    rng = np.random.RandomState(0)
    xs = rng.randn(8, 16).astype(np.float32)
    w_true = rng.randn(16, 16).astype(np.float32) / 16
    put = partial(jax.device_put, device=NamedSharding(mesh, JP("data")))
    batch = (put(xs), put(xs @ w_true))
    losses = []
    for _ in range(4):
        p, st, loss = step(p, st, batch)
        losses.append(float(loss))
    return losses[1:]


def _train_toy(params, steps, seq_len):
    """The generate / serve recipe: Adam 1e-2 on 8 · dp corpus rows a
    step from RandomState(0)."""
    mesh = _mesh()
    step, p, st = _lm_trainer(params, mesh, 1e-2)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        tokens = make_corpus(rng, 8 * (WORLD // TP), seq_len, 64)
        p, st, loss = step(p, st, (jax.device_put(
            tokens, NamedSharding(mesh, JP("data"))),))
        losses.append(float(loss))
    return mesh, p, losses


def jax_generate(params):
    mesh, p, losses = _train_toy(params, 20, 12)
    gen = make_lm_generator(mesh, "model", head_dim=HEAD_DIM,
                            max_new_tokens=6)
    test = make_corpus(np.random.RandomState(99), 4, 12, 64)
    return losses, np.asarray(gen(p, test[:, :4], jax.random.PRNGKey(1)))


def jax_serve(params):
    _, p, losses = _train_toy(params, 20, 12)
    serve_mesh = mn.make_nd_mesh(("model",), (TP,), jax.devices()[:TP])
    eng = JaxServingEngine(_host(p), head_dim=HEAD_DIM, n_slots=2,
                           max_total=8, mesh=serve_mesh, queue_capacity=16)
    prompts = make_corpus(np.random.RandomState(99), 4, 8, 64)[:, :4]
    try:
        handles = [eng.submit(pr, 4) for pr in prompts]
        eng.run(steps_budget=200)
    finally:
        eng.close()
    return losses, [h.tokens for h in handles]


def _inputs():
    lm = _host(init_tp_transformer_lm(jax.random.PRNGKey(0), 64, 32, 4, 2,
                                      max_len=8))
    toy = _host(init_tp_transformer_lm(jax.random.PRNGKey(0), 64, 32, 4, 2,
                                       max_len=12))
    mlp = _host(init_tp_mlp_params(jax.random.PRNGKey(0), 16, 32))
    return {"train_transformer": lm, "train_hybrid": mlp, "generate": toy,
            "serve": toy}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    params = _inputs()
    tmp = tmp_path_factory.mktemp("tpcli")
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump({"cli": {k: (ARGV[k], params[k]) for k in ARGV}}, fh)
    return params, launch("_torch_tp_worker.py", "cli", WORLD, tmp,
                          timeout=300)[0]


def test_train_transformer_tp2_matches_the_jax_example(run):
    params, out = run
    want = jax_train_transformer(params["train_transformer"])
    for r, res in enumerate(out):
        got, printed = res["train_transformer"]
        assert got["mesh"] == (2, 2)
        np.testing.assert_allclose([got["initial_loss"]] + got["losses"],
                                   want, rtol=1e-4, err_msg=f"rank {r}")
    printed = out[0]["train_transformer"][1].splitlines()
    assert printed[0].startswith("mesh 2x2 (data x model)")
    assert printed[1].startswith("initial loss ")
    assert abs(float(printed[1].split()[2]) - want[0]) <= 5e-5 + 1e-4 * want[0]
    assert out[1]["train_transformer"][1] == ""        # rank 0 prints


def test_train_hybrid_tp2_matches_the_jax_example(run):
    params, out = run
    want = jax_train_hybrid(params["train_hybrid"])
    for r, res in enumerate(out):
        got, _ = res["train_hybrid"]
        assert got["mesh"] == (2, 2)
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4,
                                   err_msg=f"rank {r}")
    assert out[0]["train_hybrid"][1].startswith(
        "mesh 2x2 (data x model)  global_batch=8")


def test_generate_tp2_matches_the_jax_example(run):
    params, out = run
    want_losses, want_tokens = jax_generate(params["generate"])
    for r, res in enumerate(out):
        got, _ = res["generate"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["tokens"], want_tokens,
                                      err_msg=f"rank {r}")
    printed = out[0]["generate"][1]
    assert f"-> {want_tokens[0].tolist()}" in printed
    assert "continuation accuracy:" in printed


def test_serve_tp2_matches_the_jax_recipe(run):
    params, out = run
    _, want_tokens = jax_serve(params["serve"])
    summary, _ = out[0]["serve"]
    assert summary["tp"] == 2 and summary["world"] == 4
    assert [r["status"] for r in summary["requests"]] == ["done"] * 4
    assert [r["tokens"] for r in summary["requests"]] == want_tokens
    # rank 1 followed rank 0's plan; ranks 2 and 3 only trained
    assert [res["serve"][0] for res in out[1:]] == [None] * 3


def test_serve_refuses_a_tp_that_does_not_divide_the_world():
    """JAX's message: ``--tp 3 does not divide 1 devices``."""
    from chainermn_tpu_torch.serve import main

    with pytest.raises(SystemExit, match="--tp 3 does not divide 1 devices"):
        main(["--device", "cpu", "--tp", "3", "--train-steps", "0"])
