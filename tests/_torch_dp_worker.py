"""One rank of the port's data-parallel ResNet step, for tests/test_torch_dp.py.

Run as ``python tests/_torch_dp_worker.py RANK WORLD STORE_FILE IN_NPZ
OUT_NPZ``.  Joins a gloo group through a ``FileStore`` (no port), checks
the communicator's collectives against the numpy oracle, trains the
ResNet in ``IN_NPZ`` for its steps on this rank's rows of the global
batch, and writes the cross-rank losses, the parameters and the running
statistics to ``OUT_NPZ``.  Imports no JAX.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                               create_communicator)
from chainermn_tpu_torch.convert import resnet_from_jax, resnet_to_numpy
from chainermn_tpu_torch.models import ARCHS, cross_entropy_loss
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.topology import init_distributed
from chainermn_tpu_torch.train import make_flax_train_step, shard_batch


def _nest(flat):
    root = {}
    for key, a in flat.items():
        node = root
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = a
    return root


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def check_collectives(comm):
    """Each rank's result equals the naive oracle's row for that rank."""
    naive = NaiveCommunicator(size=comm.size)
    stack = np.stack([np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
                      for r in range(comm.size)])
    mine = torch.from_numpy(stack[comm.rank])
    for op in ("sum", "mean", "max"):
        np.testing.assert_allclose(comm.allreduce(mine, op).numpy(),
                                   naive.allreduce(stack, op)[comm.rank])
    np.testing.assert_array_equal(comm.bcast(mine, root=1).numpy(),
                                  naive.bcast(stack, root=1)[comm.rank])
    np.testing.assert_array_equal(comm.allgather(mine).numpy(),
                                  naive.allgather(stack)[comm.rank])
    assert comm.bcast_obj({"from": comm.rank}, root=1) == {"from": 1}
    grads = [torch.from_numpy(stack[comm.rank]),
             torch.full((3,), comm.rank + 1.0)]
    means = comm.multi_node_mean_grad(grads)
    np.testing.assert_allclose(means[0].numpy(),
                               naive.allreduce(stack, "mean")[comm.rank])
    np.testing.assert_allclose(means[1].numpy(), np.full(3, 1.5))
    assert comm.owns_rank(comm.rank) and not comm.owns_rank(1 - comm.rank)


def main(rank, world, store_file, in_npz, out_npz):
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    comm = create_communicator("xla", device="cpu")
    assert (comm.rank, comm.size) == (rank, world)
    check_collectives(comm)

    with np.load(in_npz) as z:
        data = {k: z[k] for k in z.files}
    cfg = {k[4:]: int(data.pop(k)) for k in list(data) if k.startswith("cfg/")}
    x, y = data.pop("x"), data.pop("y")
    variables = _nest(data)
    model = ARCHS["resnet18"](num_classes=cfg["classes"], dtype=torch.float32,
                              stem_strides=1, conv_impl="pallas",
                              device="cpu")
    resnet_from_jax(variables, model)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                        weight_decay=1e-4), comm)

    def loss_and_metrics(logits, batch):
        return cross_entropy_loss(logits, batch[1]), {}

    step = make_flax_train_step(model, loss_and_metrics, opt, mesh=comm.mesh)
    batch = shard_batch((x, y), "cpu", comm.mesh)
    losses = [float(step(model, batch)[0]) for _ in range(cfg["steps"])]
    tree = resnet_to_numpy(model)
    out = {f"params/{k}": v for k, v in _flat(tree["params"]).items()}
    out.update({f"batch_stats/{k}": v
                for k, v in _flat(tree["batch_stats"]).items()})
    np.savez(out_npz, losses=np.asarray(losses), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
