"""The port's links and ``allreduce_persistent`` vs the JAX package's, on the CPU.

Ports JAX's ``tests/test_links.py``:

* ``MultiNodeChainList`` at world 4 and 2 over gloo, one process per rank
  (``tests/_torch_functions_worker.py``, one launch per world size): the
  pipeline (0 → 1 → 2), the branching graph (fan-out 0 → [1, 2], join on
  3), two stages (0 → 1) and a chain back to rank 0 (0 → 1 → 0): the output
  on its process and every stage's gradient of ``mean(out²)`` on the
  process that owns the stage, against ``jax.grad`` of JAX's chain list
  with the same weights (rtol 1e-5); the errors (rank out of range, a
  message that is not pending, no output stage) on every process; the
  naive communicator's face in one process (every edge the identity);
* ``MultiNodeBatchNormalization`` at world 2: the output, the gradients of
  the input, scale and bias (the ranks' scale / bias gradients summed),
  the running statistics after two calls and the running-average output,
  against JAX's module under ``shard_map`` and against the port's local
  BatchNorm over the gathered batch in one process (rtol 1e-5); the local
  fallback and ``use_running_average`` against JAX's;
* ``allreduce_persistent`` at world 2 (a tree of tensors, a module's
  buffers) and with the naive communicator against JAX's.
"""

import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import chainermn_tpu as mn
from chainermn_tpu.extensions import allreduce_persistent as j_persistent
from chainermn_tpu.links import MultiNodeBatchNormalization as JBN
from chainermn_tpu.links import MultiNodeChainList as JChain
from chainermn_tpu_torch.communicators import NaiveCommunicator
from chainermn_tpu_torch.extensions import (AllreducePersistent,
                                            allreduce_persistent)
from chainermn_tpu_torch.links import (MultiNodeBatchNormalization,
                                       MultiNodeChainList)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_functions_worker import (GRAPHS, bn_inputs,  # noqa: E402
                                     chain_input, dense_params)
from test_torch_functions import launch  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: launch("_torch_functions_worker.py", "links", w,
                      tmp_path_factory.mktemp(f"links{w}"))[0]
            for w in WORLDS}


def j_dense(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def j_join(p, xs):
    return j_dense(p, xs[0] + xs[1])


def jax_graph(name):
    """JAX's chain list on the graph: the output and each stage's
    gradient of ``mean(out²)``."""
    _, stages = GRAPHS[name]
    mnc = JChain(mn.create_communicator("xla"))
    for apply, key, rank, rank_in, rank_out in stages:
        mnc.add_link({"dense": j_dense, "join": j_join}[apply],
                     dense_params(key, 4, 4), rank=rank, rank_in=rank_in,
                     rank_out=rank_out)
    x = jnp.asarray(chain_input(7))
    plist = mnc.params()
    out = mnc(x, params=plist)
    grads = jax.grad(lambda pl: jnp.mean(mnc(x, params=pl) ** 2))(plist)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


CHAIN_CASES = [(w, name) for w in WORLDS for name, (least, _)
               in GRAPHS.items() if w >= least]


@pytest.mark.parametrize("world,name", CHAIN_CASES)
def test_chain_list_matches_jax_forward_and_backward(worlds, world, name):
    want_out, want_grads = jax_graph(name)
    _, stages = GRAPHS[name]
    out_rank = [s[2] for s in stages if s[4] is None][-1]
    for r, res in enumerate(worlds[world]):
        value, grads = res["graphs"][name]
        if r == out_rank:
            np.testing.assert_allclose(value, want_out, rtol=1e-5)
        else:
            assert value is None
        owned = sorted(i for i, s in enumerate(stages) if s[2] == r)
        assert sorted(grads) == owned
        for i in owned:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    grads[i][leaf], want_grads[i][leaf], rtol=1e-5,
                    atol=1e-7, err_msg=f"{name} stage {i} {leaf}")


@pytest.mark.parametrize("world", WORLDS)
def test_chain_list_errors_on_every_process(worlds, world):
    for res in worlds[world]:
        assert res["errors"] == {"rank_out_of_range": True,
                                 "missing_message": True, "no_output": True}


def _torch_dense(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _torch_join(p, xs):
    return _torch_dense(p, xs[0] + xs[1])


def test_naive_communicator_runs_every_stage_in_process():
    """One process owns every rank: the branching graph in process, the
    output and every stage's gradient equal to JAX's."""
    want_out, want_grads = jax_graph("branching")
    mnc = MultiNodeChainList(NaiveCommunicator(size=4))
    for apply, key, rank, rank_in, rank_out in GRAPHS["branching"][1]:
        mnc.add_link({"dense": _torch_dense, "join": _torch_join}[apply],
                     dense_params(key, 4, 4), rank=rank, rank_in=rank_in,
                     rank_out=rank_out)
    out = mnc(torch.from_numpy(chain_input(7)))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5)
    (out ** 2).mean().backward()
    for i, p in enumerate(mnc.params()):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(p[leaf].grad.numpy(),
                                       want_grads[i][leaf], rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_naive_chain_list_errors_match_jax(side):
    if side == "port":
        chain, apply = MultiNodeChainList(NaiveCommunicator(size=2)), \
            _torch_dense
        x = torch.ones(1, 2)
    else:
        chain, apply = JChain(mn.create_communicator("naive", size=2)), \
            j_dense
        x = np.ones((1, 2), np.float32)
    with pytest.raises(ValueError):
        chain.add_link(apply, {}, rank=2)
    chain.add_link(apply, dense_params(0, 2, 2), rank=0, rank_in=1)
    with pytest.raises(RuntimeError, match="none is pending"):
        chain(x)


# ---- MultiNodeBatchNormalization ----

SCALE = np.linspace(0.5, 1.5, 6).astype(np.float32)
BIAS = np.linspace(-0.2, 0.3, 6).astype(np.float32)


def jax_bn(world):
    """JAX's module under ``shard_map`` on ``world`` devices, as the worker
    calls the port's: the output, the gradients of ``sum(y · w)`` and the
    statistics after the two training calls, the running-average output."""
    x, w = bn_inputs(world)
    model = JBN(axis_name="mn")
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((4, 6)))
    variables = flax.core.unfreeze(variables)
    variables["params"] = {"scale": jnp.asarray(SCALE),
                           "bias": jnp.asarray(BIAS)}
    mesh = Mesh(np.array(jax.devices()[:world]), ("mn",))

    def body(v, xb, wb):
        def loss(params, xx):
            y, upd = model.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, xx,
                                 mutable=["batch_stats"])
            return jnp.sum(y * wb), (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(v["params"], xb)
        _, upd = model.apply({"params": v["params"], "batch_stats": stats},
                             xb * 0.5, mutable=["batch_stats"])
        y_ra = model.apply({"params": v["params"],
                            "batch_stats": upd["batch_stats"]}, xb,
                           use_running_average=True)
        return y, gx, gp, upd["batch_stats"], y_ra

    run = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P("mn"), P("mn")),
        out_specs=(P("mn"), P("mn"), P(), P(), P("mn"))))
    y, gx, gp, stats, y_ra = run(variables, x.reshape(-1, 6),
                                 w.reshape(-1, 6))
    to = lambda a: np.asarray(a).reshape(world, 4, 6)  # noqa: E731
    return {"y": to(y), "dx": to(gx), "dscale": np.asarray(gp["scale"]),
            "dbias": np.asarray(gp["bias"]), "mean": np.asarray(stats["mean"]),
            "var": np.asarray(stats["var"]), "y_ra": to(y_ra)}


def gathered_bn(world):
    """The port's local BatchNorm over the gathered batch in one process."""
    x, w = bn_inputs(world)
    bn = MultiNodeBatchNormalization(6, axis_name=None)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(SCALE))
        bn.bias.copy_(torch.from_numpy(BIAS))
    xb = torch.from_numpy(x.reshape(-1, 6)).requires_grad_(True)
    y = bn(xb)
    (y * torch.from_numpy(w.reshape(-1, 6))).sum().backward()
    bn(torch.from_numpy(x.reshape(-1, 6) * 0.5))
    y_ra = bn(torch.from_numpy(x.reshape(-1, 6)), use_running_average=True)
    to = lambda a: a.detach().numpy().reshape(world, 4, 6)  # noqa: E731
    return {"y": to(y), "dx": to(xb.grad), "dscale": bn.scale.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.mean.numpy(),
            "var": bn.var.numpy(), "y_ra": to(y_ra)}


@pytest.mark.parametrize("oracle", ["jax_shard_map", "gathered_batch"])
def test_sync_bn_world_2_matches(worlds, oracle):
    want = jax_bn(2) if oracle == "jax_shard_map" else gathered_bn(2)
    ranks = [res["bn"] for res in worlds[2]]
    for key in ("y", "dx", "y_ra"):
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[key], want[key][r], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} rank {r}")
    for key in ("dscale", "dbias"):      # each rank holds its own share
        np.testing.assert_allclose(sum(g[key] for g in ranks), want[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("mean", "var"):          # the same statistics everywhere
        for got in ranks:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_sync_bn_local_fallback_matches_jax():
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    model = JBN(axis_name=None)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((8, 4)))
    want, upd = model.apply(variables, x, mutable=["batch_stats"])
    bn = MultiNodeBatchNormalization(4, axis_name=None)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)


def test_sync_bn_running_average_mode_matches_jax():
    model = JBN(axis_name=None, use_running_average=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)))
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    want = np.asarray(model.apply(variables, x))
    bn = MultiNodeBatchNormalization(3, axis_name=None,
                                     use_running_average=True)
    got = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, x / np.sqrt(1 + 1e-5), rtol=1e-5)
    assert not bn.mean.any() and bool((bn.var == 1).all())


def test_sync_bn_bf16_output_dtype():
    bn = MultiNodeBatchNormalization(3, axis_name=None)
    y = bn(torch.randn(4, 3, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    bn32 = MultiNodeBatchNormalization(3, axis_name=None, dtype=torch.float32)
    assert bn32(torch.randn(4, 3, dtype=torch.bfloat16)).dtype == \
        torch.float32


# ---- allreduce_persistent ----

def test_allreduce_persistent_world_2(worlds):
    for res in worlds[2]:
        np.testing.assert_allclose(res["persistent"]["a"], 0.5)
        np.testing.assert_allclose(res["persistent"]["b"],
                                   np.arange(4.0) * 1.5)
        mean, var = res["persistent_module"]
        np.testing.assert_allclose(mean, 0.5)
        np.testing.assert_allclose(var, 1.0)


def test_allreduce_persistent_naive_matches_jax():
    stack = {"mean": np.arange(8, dtype=np.float32).reshape(4, 2),
             "var": [np.ones((4, 3), np.float32) * np.arange(4)[:, None]]}
    want = j_persistent(stack, mn.create_communicator("naive", size=4))
    got = allreduce_persistent(stack, NaiveCommunicator(size=4))
    np.testing.assert_allclose(got["mean"], np.asarray(want["mean"]))
    np.testing.assert_allclose(got["var"][0], np.asarray(want["var"][0]))


def test_allreduce_persistent_extension_sets_trainer_state():
    class T:
        persistent_state = {"m": np.arange(6, dtype=np.float32).reshape(2, 3)}

    AllreducePersistent(NaiveCommunicator(size=2))(T)
    np.testing.assert_allclose(T.persistent_state["m"], [[1.5, 2.5, 3.5]] * 2)
    t = T()
    t.persistent_state = None           # nothing to sync: left alone
    AllreducePersistent(NaiveCommunicator(size=2))(t)
    assert t.persistent_state is None
