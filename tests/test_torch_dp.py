"""The port's data-parallel training path vs the JAX package's, on the CPU.

* The multi-node optimizer: three steps of SGD with momentum and decayed
  weights against optax's chain under JAX's ``create_multi_node_optimizer``
  (plain, double-buffered: the zero-filled first step and the 1-step
  staleness, and with the bf16 wire), from the same numpy gradients.
* ``make_flax_train_step`` on ResNet-18 (16 x 16 images, 10 classes,
  global batch 8, 3 steps, SGD 0.1 / momentum 0.9 / wd 1e-4) at world 1
  (a one-rank gloo group in this process) and world 2 (two gloo processes,
  ``tests/_torch_dp_worker.py``, rendezvous through a ``FileStore`` in
  ``tmp_path``) against JAX's step over ``create_communicator("xla",
  size=1 | 2)`` on the virtual CPU devices.
* ``scatter_dataset``, the naive communicator and ``PrefetchIterator``'s
  batch order against JAX's for one seed.

Tolerances, fp32: losses rtol 1e-4, parameters and running statistics
atol 1e-4, optimizer steps atol 1e-6 (the same elementwise arithmetic).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chainermn_tpu as mn
from chainermn_tpu.datasets import scatter_dataset as jax_scatter
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce
from chainermn_tpu.models.resnet import ARCHS as JAX_ARCHS
from chainermn_tpu.runtime import PrefetchIterator as JaxPrefetch
from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                               create_communicator)
from chainermn_tpu_torch.convert import resnet_from_jax, resnet_to_numpy
from chainermn_tpu_torch.datasets import scatter_dataset, scatter_index
from chainermn_tpu_torch.models import ARCHS, MLP, cross_entropy_loss
from chainermn_tpu_torch.optimizers import (_bucket,
                                            create_multi_node_optimizer)
from chainermn_tpu_torch.runtime import PrefetchIterator
from chainermn_tpu_torch.train import (make_flax_train_step, make_train_step,
                                       shard_batch)

ROOT = Path(__file__).resolve().parents[1]
IMAGE, CLASSES, GLOBAL_BATCH, STEPS = 16, 10, 8, 3
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def comm1():
    """A one-rank gloo group in this process, torn down after the module."""
    comm = create_communicator("xla", device="cpu")
    yield comm
    dist.destroy_process_group()


def _jax_optimizer(double_buffering=False, wire=None):
    return mn.create_multi_node_optimizer(
        optax.chain(optax.add_decayed_weights(WD),
                    optax.sgd(LR, momentum=MOMENTUM)),
        None, double_buffering=double_buffering, allreduce_grad_dtype=wire)


@pytest.mark.parametrize("double_buffering", [False, True])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_optimizer_trajectory_matches_optax(comm1, double_buffering, wire):
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jopt = _jax_optimizer(double_buffering)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = create_multi_node_optimizer(
        torch.optim.SGD(list(tp.values()), lr=LR, momentum=MOMENTUM,
                        weight_decay=WD), comm1,
        double_buffering=double_buffering, allreduce_grad_dtype=wire)
    for i, g in enumerate(grads):
        # the wire's rounding: JAX means g.astype(wire) and casts back
        jg = {k: jnp.asarray(v).astype(wire or jnp.float32).astype(
            jnp.float32) for k, v in g.items()}
        updates, state = jopt.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        topt.step()
        topt.zero_grad()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       err_msg=f"step {i} {k}")
        if double_buffering and i == 0:   # zero-filled: only the decay moved
            for k in shapes:
                np.testing.assert_allclose(
                    tp[k].detach().numpy(), p0[k] * (1 - LR * WD), atol=1e-7)


def test_make_train_step_mlp_matches_jax(comm1):
    """The MNIST MLP through ``make_train_step`` with a plain
    ``torch.optim.SGD`` (the step means the gradient itself) against JAX's
    ``make_train_step`` with the multi-node optimizer, world 1, 3 steps."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 3, 4).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.int32)
    jm = JaxMLP(n_units=16, n_out=5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 4)))["params"])
    comm = mn.create_communicator("xla", size=1)
    jopt = mn.create_multi_node_optimizer(optax.sgd(LR, momentum=MOMENTUM),
                                          comm)
    jstep = mn.make_train_step(
        lambda p, b: jax_ce(jm.apply({"params": p}, b[0]), b[1]), jopt,
        mesh=comm.mesh, donate=False)
    jp, state = params, jopt.init(params)
    batch = mn.shard_batch((x, y), comm.mesh)
    want = []
    for _ in range(STEPS):
        jp, state, loss = jstep(jp, state, batch)
        want.append(float(loss))

    model = MLP(12, n_units=16, n_out=5)
    with torch.no_grad():
        for i in range(3):
            dense = getattr(model, f"Dense_{i}")
            dense.weight.copy_(torch.from_numpy(params[f"Dense_{i}"]["kernel"].T))
            dense.bias.copy_(torch.from_numpy(params[f"Dense_{i}"]["bias"]))
    step = make_train_step(
        lambda m, b: cross_entropy_loss(m(b[0]), b[1]),
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        mesh=comm1.mesh)
    tb = shard_batch((x, y), "cpu", comm1.mesh)
    got = [float(step(model, tb)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jp = jax.device_get(jp)
    for i in range(3):
        dense = getattr(model, f"Dense_{i}")
        np.testing.assert_allclose(dense.weight.detach().numpy(),
                                   np.asarray(jp[f"Dense_{i}"]["kernel"]).T,
                                   atol=1e-5)
        np.testing.assert_allclose(dense.bias.detach().numpy(),
                                   np.asarray(jp[f"Dense_{i}"]["bias"]),
                                   atol=1e-5)


def test_bucket_round_trips_shapes_and_dtypes():
    ts = [torch.randn(3, 4), torch.randn(5).bfloat16(), torch.randn(2, 1, 2)]
    flat, unbucket = _bucket(ts)
    assert flat.dtype == torch.float32 and flat.numel() == 12 + 5 + 4
    for a, b in zip(ts, unbucket(flat)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_int8_wire_and_error_feedback_name_the_roadmap(comm1):
    sgd = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
    for kw in ({"allreduce_grad_dtype": "int8"}, {"error_feedback": True}):
        with pytest.raises(NotImplementedError, match="queue A item 9"):
            create_multi_node_optimizer(sgd, comm1, **kw)


def _initial_variables():
    jm = JAX_ARCHS["resnet18"](num_classes=CLASSES, dtype=jnp.float32,
                               stem_strides=1, conv_impl="pallas")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)),
                train=False)
    rng = np.random.RandomState(1)

    def one(path, a):      # switch the zero-init block branches on
        if str(getattr(path[-1], "key", "")) == "scale":
            return (0.2 + 0.8 * np.asarray(a).any()
                    + 0.05 * rng.randn(*a.shape)).astype(np.float32)
        return np.asarray(a)

    v = {"params": jax.tree_util.tree_map_with_path(one, v["params"]),
         "batch_stats": jax.tree_util.tree_map(np.asarray, v["batch_stats"])}
    return jm, v


def _batch():
    rng = np.random.RandomState(2)
    return (rng.randn(GLOBAL_BATCH, IMAGE, IMAGE, 3).astype(np.float32),
            rng.randint(0, CLASSES, GLOBAL_BATCH).astype(np.int32))


def _jax_trajectory(world):
    jm, v = _initial_variables()
    comm = mn.create_communicator("xla", size=world)
    opt = mn.create_multi_node_optimizer(
        optax.chain(optax.add_decayed_weights(WD),
                    optax.sgd(LR, momentum=MOMENTUM)), comm)

    def loss_and_metrics(logits, batch):
        return jax_ce(logits, batch[1]), {}

    step = mn.make_flax_train_step(jm, loss_and_metrics, opt, mesh=comm.mesh)
    variables = mn.replicate(v, comm.mesh)
    state = mn.replicate(opt.init(variables["params"]), comm.mesh)
    batch = mn.shard_batch(_batch(), comm.mesh)
    losses = []
    for _ in range(STEPS):
        variables, state, loss, _ = step(variables, state, batch)
        losses.append(float(loss))
    return v, losses, _flat(jax.device_get(variables))


@pytest.fixture(scope="module")
def jax_runs():
    return {world: _jax_trajectory(world) for world in (1, 2)}


def _assert_same_run(losses, flat, want_losses, want_flat):
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert flat.keys() == want_flat.keys()
    for k, want in want_flat.items():
        np.testing.assert_allclose(flat[k], want, atol=1e-4, err_msg=k)


def test_flax_train_step_world_1_matches_jax(comm1, jax_runs):
    v, want_losses, want = jax_runs[1]
    model = ARCHS["resnet18"](num_classes=CLASSES, dtype=torch.float32,
                              stem_strides=1, conv_impl="pallas",
                              device="cpu")
    resnet_from_jax(v, model)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM,
                        weight_decay=WD), comm1)
    step = make_flax_train_step(
        model, lambda logits, b: (cross_entropy_loss(logits, b[1]), {}), opt,
        mesh=comm1.mesh)
    batch = shard_batch(_batch(), "cpu", comm1.mesh)
    losses = [float(step(model, batch)[0]) for _ in range(STEPS)]
    _assert_same_run(losses, _flat(resnet_to_numpy(model)), want_losses,
                     want)
    assert losses[-1] < losses[0]


def test_flax_train_step_world_2_gloo_matches_jax(tmp_path, jax_runs):
    v, want_losses, want = jax_runs[2]
    x, y = _batch()
    flat = {f"{c}/{k}": a for c in ("params", "batch_stats")
            for k, a in _flat(v[c]).items()}
    np.savez(tmp_path / "in.npz", x=x, y=y, **flat,
             **{"cfg/classes": CLASSES, "cfg/steps": STEPS})
    env = {k: val for k, val in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"     # two ranks share the CPU
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"),
         str(r), "2", str(tmp_path / "store"), str(tmp_path / "in.npz"),
         str(tmp_path / f"out{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    outs = []
    for r in range(2):
        with np.load(tmp_path / f"out{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    for out in outs:
        losses = out.pop("losses")
        _assert_same_run(list(losses), out, want_losses, want)
    for k in outs[0]:             # the replicas stayed equal
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_scatter_dataset_and_index_match_jax():
    jnaive = mn.create_communicator("naive", size=3)
    naive = NaiveCommunicator(size=3)
    data = list(range(10))
    for shuffle in (False, True):
        want = jax_scatter(data, jnaive, shuffle=shuffle, seed=3)
        got = scatter_dataset(data, naive, shuffle=shuffle, seed=3)
        for r in range(3):
            assert list(got.shard(r)) == list(want.shard(r))
    assert scatter_index(10, naive) == mn.datasets.scatter_index(10, jnaive)


def test_naive_communicator_matches_jax():
    jnaive = mn.create_communicator("naive", size=4)
    naive = NaiveCommunicator(size=4)
    x = np.random.RandomState(4).randn(4, 3, 2).astype(np.float32)
    for op in ("sum", "mean", "max", "min"):
        np.testing.assert_allclose(naive.allreduce(x, op),
                                   jnaive.allreduce(x, op), rtol=1e-6)
    np.testing.assert_array_equal(naive.bcast(x, 2), jnaive.bcast(x, 2))
    np.testing.assert_array_equal(naive.allgather(x), jnaive.allgather(x))


def test_prefetch_iterator_batch_order_matches_jax():
    x = np.arange(53 * 3, dtype=np.float32).reshape(53, 3)
    y = np.arange(53, dtype=np.int32)
    ours = PrefetchIterator((x, y), 8, seed=1, copy=True)
    ref = JaxPrefetch((x, y), 8, seed=1, copy=True)
    for _ in range(15):             # across two epoch boundaries
        a, b = next(ours), next(ref)
        for u, w in zip(a, b):
            np.testing.assert_array_equal(u, w)
        assert ours.epoch == ref.epoch
    ours.close()
    ref.close()


def test_communicator_aliases_and_unknown_names(comm1):
    for name in ("pure_nccl", "hierarchical", "flat", "single_node",
                 "two_dimensional", "non_cuda_aware"):
        c = create_communicator(name, device="cpu")
        assert (c.rank, c.size, c.intra_size, c.inter_size) == (0, 1, 1, 1)
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("mpi", device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        create_communicator("xla", size=4, device="cpu")
