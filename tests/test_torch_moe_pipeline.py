"""The port's MoE layer and pipelines vs the JAX package's, on the CPU.

``tests/_torch_sp_worker.py moe`` runs in two and in four gloo processes
(one launch per world that runs every case) on a ``('sp',)`` mesh, and
JAX runs the same cases under ``shard_map`` on as many virtual CPU
devices, from the same numpy inputs:

* ``make_moe_mlp`` (two experts a rank), top-1 and top-2, with room for
  every token (capacity factor 8) and with drops (0.5): the output, the
  aux loss and the gradients of ``sum(y · R) + 3 aux`` for the tokens and
  every leaf, rtol 1e-5 with an atol of 1e-5 of the largest entry;
* ``make_pipeline`` (``tests/test_pipeline.py``'s dense + tanh stage, one
  stage a rank, 4 microbatches) with and without ``remat``: the output
  and the gradients of ``sum(y · R)``; ``make_pipeline_1f1b`` with a mean
  squared error: the loss and the stage-stacked gradients; the same
  tolerance;
* ``train_moe``, ``--router-topk 1`` and ``2``, 5 steps from JAX's initial
  params, against the JAX example's recipe
  (``examples/moe/train_moe.py``: Adam 3e-2, ``make_hybrid_shard_map_step``
  with the experts' gradients local): every loss and the maximum expert
  fraction rtol 1e-4;
* JAX's ``ValueError`` messages: ``router_topk``, experts not divisible by
  the axis, microbatches, the stage count, an unsqueezed stage slice.

Every launch has its own timeout, so that a hang fails the test; the JAX
side runs while the gloo ranks do (``test_torch_sp.run_worlds``).
"""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from chainermn_tpu.parallel import (init_moe_mlp_params,
                                    make_hybrid_shard_map_step, make_moe_mlp,
                                    make_pipeline, make_pipeline_1f1b,
                                    moe_mlp, moe_mlp_specs, pipeline_apply,
                                    shard_pytree, stack_stage_params,
                                    state_specs_like)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_sp_worker import (AX, MOE, MOE_ARGV, MOE_CASES,  # noqa: E402
                              PIPE, moe_inputs, pipe_inputs)
from test_torch_sp import run_worlds  # noqa: E402
from test_torch_tp import close  # noqa: E402

WORLDS = (2, 4)
CLI = dict(d_in=16, d_model=32, d_hidden=64, num_classes=8, batchsize=256,
           lr=3e-2, aux_weight=0.01, capacity_factor=1.5,
           steps=int(MOE_ARGV[MOE_ARGV.index("--steps") + 1]))


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), (AX,))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def moe_params(world):
    """``init_moe_mlp_params``' layout and scales, drawn with numpy (a
    jax.random draw compiles for every shape)."""
    rng = np.random.RandomState(world)
    e, d, f = MOE["experts_per_rank"] * world, MOE["d_model"], MOE["d_hidden"]
    return {"router": rng.randn(d, e).astype(np.float32) * 0.02,
            "wi": rng.randn(e, d, f).astype(np.float32) * (2.0 / d) ** 0.5,
            "bi": rng.randn(e, f).astype(np.float32) * 0.1,
            "wo": rng.randn(e, f, d).astype(np.float32) * (2.0 / f) ** 0.5,
            "bo": rng.randn(e, d).astype(np.float32) * 0.1}


def cli_params(world):
    """The JAX example's initial params for ``world`` experts."""
    k_in, k_moe, k_head = jax.random.split(jax.random.PRNGKey(0), 3)
    return _host({
        "w_in": jax.random.normal(k_in, (CLI["d_in"], CLI["d_model"])) * 0.3,
        "moe": init_moe_mlp_params(k_moe, CLI["d_model"], CLI["d_hidden"],
                                   world),
        "w_head": jax.random.normal(
            k_head, (CLI["d_model"], CLI["num_classes"])) * 0.3})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank's results and JAX's references, world by world (the JAX
    side runs while the gloo ranks do)."""
    inp = {"moe": {w: moe_params(w) for w in WORLDS},
           "moe_cli": {w: cli_params(w) for w in WORLDS}}

    def references(world):
        return {"moe": {n: jax_moe(n, world, inp["moe"][world])
                        for n in MOE_CASES},
                "gpipe": {remat: jax_gpipe(world, remat)
                          for remat in (False, True)},
                "1f1b": jax_1f1b(world),
                "cli": {topk: jax_train_moe(world, topk) for topk in (1, 2)},
                "errors": jax_errors(world)}

    return run_worlds(tmp_path_factory, "moe", inp, references)


def jax_moe(name, world, params):
    topk, cf = MOE_CASES[name]
    fn = make_moe_mlp(MOE["experts_per_rank"] * world, mesh=_mesh(world),
                      axis_name=AX, capacity_factor=cf, router_topk=topk)
    x, r = moe_inputs(name)

    def loss(x, p):
        y, aux = fn(x, p)
        return jnp.sum(y * r) + 3.0 * aux, (y, aux)

    (_, (y, aux)), (dx, dp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(x, params)
    return np.asarray(y), float(aux), np.asarray(dx), _host(dp)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_mlp_matches_jax(worlds, name, world):
    out, refs = worlds
    y, aux, dx, dp = refs[world]["moe"][name]
    for r, res in enumerate(out[world]):
        got = res["moe"][name]
        close(got["y"], y, f"{name} y rank {r}")
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-5,
                                   err_msg=f"{name} aux rank {r}")
        close(got["dx"], dx, f"{name} dx rank {r}")
        assert got["dparams"].keys() == dp.keys()
        for leaf, w in dp.items():
            close(got["dparams"][leaf], w, f"{name} d{leaf} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_capacity_cases_drop_tokens(worlds, world):
    """Capacity 0.5 drops tokens (zero rows of JAX's output) and 8.0 keeps
    them all, so the parity above covers both regimes."""
    for name, (_, cf) in MOE_CASES.items():
        y = worlds[1][world]["moe"][name][0]
        zero_rows = int((np.abs(y).sum(-1) == 0).sum())
        assert (zero_rows > 0) == (cf < 1), (name, zero_rows)


def jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def jax_mse(y, t):
    return jnp.mean((y - t) ** 2)


def jax_gpipe(world, remat):
    """``make_pipeline``'s output and the gradients of ``sum(y · R)``."""
    per, x, r, _ = pipe_inputs(world)
    fn = make_pipeline(jax_stage, mesh=_mesh(world), axis_name=AX,
                       num_microbatches=PIPE["microbatches"], remat=remat)

    def loss(p, x):
        y = fn(p, x)
        return jnp.sum(y * r), y

    (_, y), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(
        stack_stage_params(per), x)
    return np.asarray(y), np.asarray(dx), _host(dp)


def jax_1f1b(world):
    per, x, _, tgt = pipe_inputs(world)
    loss, grads = make_pipeline_1f1b(
        jax_stage, jax_mse, mesh=_mesh(world), axis_name=AX,
        num_microbatches=PIPE["microbatches"])(stack_stage_params(per), x,
                                               tgt)
    return float(loss), _host(grads)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_matches_jax(worlds, world, remat):
    y, dx, dp = worlds[1][world]["gpipe"][remat]
    for rank, res in enumerate(worlds[0][world]):
        got = res["pipe"][f"gpipe_remat{int(remat)}"]
        close(got["y"], y, f"gpipe y rank {rank}")
        close(got["dx"], dx, f"gpipe dx rank {rank}")
        for leaf in ("w", "b"):
            close(got["dparams"][leaf], dp[leaf],
                  f"gpipe d{leaf} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_1f1b_matches_jax(worlds, world):
    loss, grads = worlds[1][world]["1f1b"]
    for rank, res in enumerate(worlds[0][world]):
        got = res["pipe"]["1f1b"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for leaf in ("w", "b"):
            close(got["grads"][leaf], grads[leaf],
                  f"1f1b d{leaf} rank {rank}")


def jax_train_moe(world, topk):
    """``examples/moe/train_moe.py``'s recipe on ``world`` devices: the
    losses and ``max_frac`` of each step."""
    from examples.moe.train_moe import make_dataset

    mesh = _mesh(world)
    params = cli_params(world)
    specs = {"w_in": JP(), "moe": moe_mlp_specs(AX), "w_head": JP()}

    def loss_fn(p, batch):
        xs, ys = batch
        h = jnp.tanh(xs @ p["w_in"])
        y, aux = moe_mlp(h, p["moe"], axis_name=AX, num_experts=world,
                         capacity_factor=CLI["capacity_factor"],
                         router_topk=topk)
        logp = jax.nn.log_softmax((y @ p["w_head"]).astype(jnp.float32))
        ce = -jnp.mean(jnp.take_along_axis(logp, ys[:, None], 1))
        probs = jax.nn.softmax(
            (h @ p["moe"]["router"]).astype(jnp.float32), -1)
        frac = jax.lax.pmean(
            jnp.mean(jax.nn.one_hot(probs.argmax(-1), world), 0), AX)
        return ce + CLI["aux_weight"] * aux, {"max_frac": frac.max()}

    opt = optax.adam(CLI["lr"])
    step = make_hybrid_shard_map_step(loss_fn, opt, mesh, params, specs,
                                      data_axis=AX, batch_spec=JP(AX),
                                      has_aux=True, donate=False)
    p = shard_pytree(params, mesh, specs)
    st = shard_pytree(opt.init(params), mesh,
                      state_specs_like(opt, params, specs))
    bs = CLI["batchsize"]
    xs, ys = make_dataset(np.random.RandomState(0), bs * 4, CLI["d_in"],
                          CLI["num_classes"])
    losses, fracs = [], []
    for i in range(CLI["steps"]):
        lo = (i * bs) % (len(xs) - bs + 1)
        batch = tuple(jax.device_put(a[lo:lo + bs],
                                     NamedSharding(mesh, JP(AX)))
                      for a in (xs, ys))
        p, st, loss, aux = step(p, st, batch)
        losses.append(float(loss))
        fracs.append(float(aux["max_frac"]))
    return losses, fracs


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("topk", [1, 2])
def test_train_moe_cli_matches_the_jax_example(worlds, world, topk):
    want_losses, want_fracs = worlds[1][world]["cli"][topk]
    for rank, res in enumerate(worlds[0][world]):
        losses, aux, printed = res["cli"][topk]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose([a["max_frac"] for a in aux], want_fracs,
                                   rtol=1e-4, err_msg=f"rank {rank}")
        assert (f"{world} experts on {world} devices" in printed) == \
            (rank == 0)


def jax_errors(world):
    """JAX's messages for the worker's :func:`moe_errors` cases."""
    mesh = _mesh(world)
    x = np.zeros((4 * world, 4), np.float32)
    w = np.zeros((world, 4, 4), np.float32)
    b = np.zeros((world, 4), np.float32)

    def moe(e):             # init_moe_mlp_params' shapes (d 4, hidden 8)
        return {"router": np.zeros((4, e), np.float32),
                "wi": np.zeros((e, 4, 8), np.float32),
                "bi": np.zeros((e, 8), np.float32),
                "wo": np.zeros((e, 8, 4), np.float32),
                "bo": np.zeros((e, 4), np.float32)}

    cases = {
        "topk": lambda: make_moe_mlp(world, mesh=mesh, axis_name=AX,
                                     router_topk=3)(x, moe(world)),
        "experts": lambda: make_moe_mlp(world + 1, mesh=mesh, axis_name=AX)(
            x, moe(world * (world + 1))),
        "microbatches": lambda: make_pipeline(
            jax_stage, mesh=mesh, axis_name=AX, num_microbatches=3)(
            {"w": w, "b": b}, np.zeros((8, 4), np.float32)),
        "stages": lambda: make_pipeline(jax_stage, mesh=mesh, axis_name=AX)(
            {"w": np.zeros((world + 1, 4, 4), np.float32),
             "b": np.zeros((world + 1, 4), np.float32)},
            np.zeros((8, 4), np.float32)),
        "squeeze": lambda: jax.jit(shard_map(
            partial(pipeline_apply, jax_stage, axis_name=AX,
                    num_microbatches=2),
            mesh=mesh, in_specs=(JP(), JP()), out_specs=JP(),
            check_vma=False))({"w": w[0], "b": b[0]},
                              np.zeros((8, 4), np.float32)),
    }
    out = {}
    for name, fn in cases.items():
        with pytest.raises(ValueError) as e:
            fn()
        out[name] = str(e.value)
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_value_errors_match_jax(worlds, world):
    want = worlds[1][world]["errors"]
    for r, res in enumerate(worlds[0][world]):
        assert res["errors"] == want, f"rank {r}"
