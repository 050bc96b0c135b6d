"""The port's model-parallel example (BASELINE config #5) vs the JAX example.

``train_model_parallel.run`` at world 2 over two gloo processes
(``tests/_torch_example_worker.py``) from the JAX example's initial
weights, against the JAX example's recipe built in-process on two virtual
CPU devices (``examples/model_parallel/train_model_parallel.py`` with
``--devices 2``): both faces' losses at every step at rtol 1e-4, and the
final weights at atol 1e-4 (face 1: each stage on the rank that owns it;
face 2: each rank's slab).  A world of 1 is refused, as by the example;
so is a missing card when the caller does not ask for the CPU.
"""

import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import chainermn_tpu as mn
from chainermn_tpu import functions as JF
from chainermn_tpu.links import MultiNodeChainList as JChain
from chainermn_tpu_torch import train_model_parallel
from chainermn_tpu_torch.communicators import create_communicator

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_functions import launch  # noqa: E402

ARGS = {"steps": 40, "hidden": 32}


def jax_dense(key, n_in, n_out):
    k = jax.random.PRNGKey(key)
    return {"w": jax.random.normal(k, (n_in, n_out)) * 0.3,
            "b": jnp.zeros((n_out,))}


def jax_example(steps, hidden):
    """The JAX example's two faces at world 2: per-step losses and the
    final weights."""
    comm = mn.create_communicator("xla", size=2)
    xs, ys = train_model_parallel.make_task()

    def stage0(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def stage1(p, h):
        return h @ p["w"] + p["b"]

    mnc = JChain(comm)
    mnc.add_link(stage0, jax_dense(0, 16, hidden), rank=0, rank_in=None,
                 rank_out=1)
    mnc.add_link(stage1, jax_dense(1, hidden, 1), rank=1, rank_in=0,
                 rank_out=None)

    def loss_chain(plist):
        logits = mnc(jnp.asarray(xs), params=plist)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, ys))

    opt = optax.adam(1e-2)
    plist = mnc.params()
    state = opt.init(plist)

    @jax.jit
    def step_chain(pl, st):
        l, g = jax.value_and_grad(loss_chain)(pl)
        up, st = opt.update(g, st, pl)
        return optax.apply_updates(pl, up), st, l

    chain = []
    for _ in range(steps):
        plist, state, loss = step_chain(plist, state)
        chain.append(float(loss))

    w0, w1 = jax_dense(0, 16, hidden), jax_dense(1, hidden, 1)

    def spmd_loss(w0_, b0_, w1_, b1_, x, y):
        h = jnp.tanh(x @ w0_[0] + b0_[0])
        h = JF.send(h, dest=1, source=0)
        logits = h @ w1_[0] + b1_[0]
        out = JF.send(logits, dest=0, source=1)
        per = optax.sigmoid_binary_cross_entropy(out, y)
        valid = jnp.where(jax.lax.axis_index("mn") == 0, per.mean(), 0.0)
        return jax.lax.psum(valid, "mn")

    smapped = jax.jit(jax.shard_map(
        jax.value_and_grad(spmd_loss, argnums=(0, 1, 2, 3)), mesh=comm.mesh,
        in_specs=(P("mn"), P("mn"), P("mn"), P("mn"), P(), P()),
        out_specs=(P(), (P("mn"), P("mn"), P("mn"), P("mn")))))
    stack = lambda a: jnp.broadcast_to(a[None], (2,) + a.shape)  # noqa: E731
    slabs = [stack(w0["w"]), stack(w0["b"]), stack(w1["w"]), stack(w1["b"])]
    spmd = []
    for _ in range(steps):
        loss, grads = smapped(*slabs, jnp.asarray(xs), jnp.asarray(ys))
        slabs = [a - 0.05 * g for a, g in zip(slabs, grads)]
        spmd.append(float(loss))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    init = {"w0": host(w0), "w1": host(w1)}
    return {"init": init, "chain_losses": chain, "spmd_losses": spmd,
            "chain_params": host(plist),
            "spmd_params": dict(zip(("w0", "b0", "w1", "b1"), host(slabs)))}


def launch_example(suite, world, tmp, params, argv):
    """``tests/_torch_example_worker.py``'s ``suite`` at ``world`` ranks from
    the initial weights ``params``: the results and output, rank by
    rank."""
    with open(tmp / "params.pkl", "wb") as fh:
        pickle.dump(params, fh)
    return launch("_torch_example_worker.py", suite, world, tmp, argv)


@pytest.fixture(scope="module")
def jax_run():
    return jax_example(**ARGS)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_run):
    argv = ["--device", "cpu"] + [f"--{k}={v}" for k, v in ARGS.items()]
    return launch_example("model_parallel", 2,
                          tmp_path_factory.mktemp("mp2"), jax_run["init"],
                          argv)


@pytest.mark.parametrize("face", ["chain", "spmd"])
def test_losses_match_the_jax_example_at_every_step(world2, jax_run, face):
    outs, _ = world2
    for out in outs:
        assert out["world"] == 2 and len(out[f"{face}_losses"]) == \
            ARGS["steps"]
        np.testing.assert_allclose(out[f"{face}_losses"],
                                   jax_run[f"{face}_losses"], rtol=1e-4)
    assert jax_run[f"{face}_losses"][-1] < jax_run[f"{face}_losses"][0]


def test_chain_list_weights_match_on_their_owners(world2, jax_run):
    outs, _ = world2
    for r, out in enumerate(outs):
        assert sorted(out["chain_params"]) == [r]
        for leaf in ("w", "b"):
            np.testing.assert_allclose(out["chain_params"][r][leaf],
                                       jax_run["chain_params"][r][leaf],
                                       atol=1e-4, err_msg=f"stage {r} {leaf}")


def test_spmd_slabs_match_rank_by_rank(world2, jax_run):
    """Each rank's slab, also the ones its rank never trains (rank 1's
    stage-0 weights, rank 0's stage-1 weights stay at the initial ones)."""
    outs, _ = world2
    for r, out in enumerate(outs):
        for k, v in out["spmd_params"].items():
            np.testing.assert_allclose(v, jax_run["spmd_params"][k][r],
                                       atol=1e-4, err_msg=f"rank {r} {k}")
    np.testing.assert_array_equal(outs[1]["spmd_params"]["w0"],
                                  jax_run["init"]["w0"]["w"])
    np.testing.assert_array_equal(outs[0]["spmd_params"]["w1"],
                                  jax_run["init"]["w1"]["w"])


def test_rank_0_prints_the_example_lines(world2):
    _, logs = world2
    assert "[chain-list] step 0" in logs[0] and "[spmd p2p]   step 39" \
        in logs[0]


def test_refuses_a_world_of_1():
    comm = create_communicator("xla", device="cpu")
    try:
        with pytest.raises(SystemExit, match="at least 2 ranks"):
            train_model_parallel.run(["--device", "cpu"])
    finally:
        dist.destroy_process_group()
    assert comm.size == 1


def test_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train_model_parallel.main([])
