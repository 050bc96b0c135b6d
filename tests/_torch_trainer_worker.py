"""One rank of the port's Trainer stack at world 2, for tests/test_torch_trainer.py.

Run as ``python tests/_torch_trainer_worker.py RANK WORLD STORE_FILE
OUT_DIR``.  Joins a gloo group through a ``FileStore`` (no port), then:

* runs ``python -m chainermn_tpu_torch.train``'s ``run`` (10 steps, a
  log entry every step, the prefetch thread on) and keeps the
  per-iteration ``main/loss`` / ``main/accuracy`` and the final weights;
* runs ``train_mnist``'s ``run`` at :data:`MNIST_ARGS` from the flax
  weights in ``OUT_DIR/mlp.npz`` and keeps its result;
* evaluates :data:`N_VAL` examples scattered unequally with the
  multi-node evaluator, counting the evaluator calls this process makes;
* aggregates an observation with ``aggregate_observations``, and reads
  batches through the multi-node and the synchronized iterators;

and pickles it all to ``OUT_DIR/rank<r>.pkl``.  Imports no JAX.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch import train, train_mnist
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.datasets import scatter_dataset
from chainermn_tpu_torch.evaluators import create_multi_node_evaluator
from chainermn_tpu_torch.extensions import aggregate_observations
from chainermn_tpu_torch.iterators import (SerialIterator,
                                           create_multi_node_iterator,
                                           create_synchronized_iterator)
from chainermn_tpu_torch.topology import init_distributed

N_VAL = 7           # 4 + 3 examples over two ranks: unequal shards
DEMO_ARGS = ["--device", "cpu", "--steps", "10", "--log-every", "1",
             "--prefetch"]
MNIST_ARGS = {"unit": 32, "n_train": 1024, "n_val": 256, "batchsize": 32,
              "epoch": 2, "lr": 1e-3}


def val_set():
    return [(np.float32(i), np.int32(i % 3)) for i in range(N_VAL)]


def main(rank, world, store_file, out_dir):
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    comm = create_communicator("xla", device="cpu")
    out = {}

    result, trainer = train.run(
        DEMO_ARGS + ["--out", str(Path(out_dir) / f"demo{rank}")])
    log = trainer.get_extension("LogReport").log
    out["demo"] = {
        "result": result,
        "loss": [e["main/loss"] for e in log],
        "accuracy": [e["main/accuracy"] for e in log],
        "params": {k: v.detach().numpy().copy()
                   for k, v in trainer.updater.state[0].items()}}

    with np.load(Path(out_dir) / "mlp.npz") as z:
        params = {f"Dense_{i}": {"kernel": z[f"Dense_{i}/kernel"],
                                 "bias": z[f"Dense_{i}/bias"]}
                  for i in range(3)}
    out["mnist"] = train_mnist.run(
        ["--device", "cpu", "--prefetch",
         "--out", str(Path(out_dir) / f"mnist{rank}")]
        + [f"--{k.replace('_', '-')}={v}" for k, v in MNIST_ARGS.items()],
        params=params)[0]

    calls = []

    def evaluate_shard(shard):
        calls.append([float(x) for x, _ in shard])
        xs = np.asarray([x for x, _ in shard])
        return {"mean_x": float(xs.mean()), "n": float(len(shard))}

    evaluator = create_multi_node_evaluator(evaluate_shard, comm)
    out["evaluator"] = {
        "metrics": evaluator(scatter_dataset(val_set(), comm,
                                             force_equal_length=False)),
        "calls": calls}

    out["aggregate"] = aggregate_observations(
        {"loss": torch.tensor(rank + 1.0), "vec": np.array([rank, 2.0]),
         "status": f"rank {rank}"}, comm)

    ds = [(np.float32(i), np.int32(i % 3)) for i in range(12)]
    base = SerialIterator(ds, 4, shuffle=True, seed=1 if rank == 0 else 99)
    it = create_multi_node_iterator(base, comm, rank_master=0)
    out["multi_node"] = [[float(x) for x, _ in it.next()] for _ in range(5)]
    out["multi_node_epoch"] = (it.epoch, it.epoch_detail)
    sync = create_synchronized_iterator(
        SerialIterator(ds, 4, shuffle=True, seed=11 + rank), comm)
    out["synchronized"] = [[float(x) for x, _ in sync.next()]
                           for _ in range(5)]

    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5])
