"""``python -m chainermn_tpu_torch.train_mnist_checkpoint`` against the JAX
example (CPU, no card).

Killed at epoch 2 (exit 99, its checkpoints kept) and then resumed, the
port's run is held to ``examples/mnist/train_mnist_checkpoint.py`` run
without interruption from the same flax weights: every epoch's loss at
rtol 1e-4, at world 1 and at world 2 over gloo
(``tests/_torch_robustness_worker.py mnist``); the world-2 generations
also resume at world 1 (an elastic resume, the same global batch) to the
same losses.
"""

import concurrent.futures
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import chainermn_tpu as jmn
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.models.mlp import accuracy as jax_accuracy
from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_robustness_worker as worker  # noqa: E402

UNIT, EPOCHS, KILL_AT, BATCH, LR = 64, 3, 2, 128, 1e-3


def _synthetic(n, seed):
    """``examples/mnist/train_mnist.py :: make_synthetic_mnist``."""
    w_true = np.random.RandomState(42).randn(784, 10).astype(np.float32)
    xs = np.random.RandomState(seed).randn(n, 784).astype(np.float32)
    return list(zip(xs, (xs @ w_true).argmax(-1).astype(np.int32)))


def _jax_checkpoint_example(world):
    """The JAX example's loop at ``world`` ranks, uninterrupted: every
    epoch's mean loss, and the initial flax params."""
    comm = jmn.create_communicator("xla", size=world)
    it = JaxSerialIterator(_synthetic(4096, 0), BATCH * world, shuffle=True,
                           seed=1)
    model = JaxMLP(n_units=UNIT)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)))
    init = jax.tree_util.tree_map(np.asarray, params)
    optimizer = jmn.create_multi_node_optimizer(optax.adam(LR), comm)

    def loss_fn(p, batch):
        logits = model.apply(p, batch[0])
        return jax_ce(logits, batch[1]), jax_accuracy(logits, batch[1])

    step = jmn.make_train_step(loss_fn, optimizer, mesh=comm.mesh,
                               has_aux=True, donate=False)
    state = optimizer.init(params)
    per_epoch = 4096 // (BATCH * world)
    losses = []
    for _ in range(EPOCHS):
        ep = []
        for _ in range(per_epoch):
            items = it.next()
            batch = jmn.shard_batch((np.stack([x for x, _ in items]),
                                     np.asarray([y for _, y in items])),
                                    comm.mesh)
            params, state, loss, _ = step(params, state, batch)
            ep.append(float(loss))
        losses.append(float(np.mean(ep)))
    return losses, init


@pytest.mark.parametrize("world", [1, 2])
def test_mnist_checkpoint_kill_and_resume_matches_the_jax_example(
        tmp_path, world):
    want, init = _jax_checkpoint_example(world)
    np.savez(tmp_path / "mlp.npz", **{
        f"{k}/{leaf}": v[leaf] for k, v in init["params"].items()
        for leaf in ("kernel", "bias")})
    argv = ["--device", "cpu", "--unit", str(UNIT), "--epoch", str(EPOCHS),
            "--lr", str(LR), "--out", str(tmp_path / "run")]
    rcs, logs, _ = worker.launch("mnist", tmp_path, *argv,
                                 "--kill-at-epoch", str(KILL_AT),
                                 world=world)
    assert rcs == [99] * world, "\n".join(logs)[-4000:]
    assert "simulating crash at epoch 2" in logs[0]
    gens = sorted(f for f in os.listdir(tmp_path / "run" / "checkpoints")
                  if "manifest" not in f)
    assert len(gens) == 2 * world      # keep=2: epochs 1 and 2
    elastic = None
    if world == 2:
        # the same world-2 generations, resumed at world 1 with the same
        # global batch, beside the world-2 resume
        shutil.copytree(tmp_path / "run", tmp_path / "el" / "run")
        np.savez(tmp_path / "el" / "mlp.npz",
                 **dict(np.load(tmp_path / "mlp.npz")))
        el_argv = [a if a != str(tmp_path / "run") else
                   str(tmp_path / "el" / "run") for a in argv]
        elastic = concurrent.futures.ThreadPoolExecutor(1).submit(
            worker.launch, "mnist", tmp_path / "el", *el_argv,
            "--batchsize", str(BATCH * 2), world=1)
    rcs, logs, _ = worker.launch("mnist", tmp_path, *argv, world=world)
    assert rcs == [0] * world, "\n".join(logs)[-4000:]
    per_epoch = 4096 // (BATCH * world)
    for r in range(world):
        got = json.loads((tmp_path / f"mnist{r}.json").read_text())
        assert got["resumed_from"] == KILL_AT * per_epoch
        assert got["iterations"] == EPOCHS * per_epoch
        np.testing.assert_allclose(got["epoch_losses"], want, rtol=1e-4)
    if elastic is not None:
        rcs, logs, _ = elastic.result()
        assert rcs == [0], "\n".join(logs)[-4000:]
        assert "elastic resume: generation" in logs[0]
        got = json.loads((tmp_path / "el" / "mnist0.json").read_text())
        assert got["world"] == 1 and got["resumed_from"] == \
            KILL_AT * per_epoch
        np.testing.assert_allclose(got["epoch_losses"], want, rtol=1e-4)
