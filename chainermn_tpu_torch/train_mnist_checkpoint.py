#!/usr/bin/env python
"""CLI: MNIST with fault-tolerant checkpoints and automatic resume.

The port of ``examples/mnist/train_mnist_checkpoint.py`` (reference:
ChainerMN's ``examples/mnist/train_mnist_checkpoint.py``): the MLP
trained with Adam through create_multi_node_optimizer, one checkpoint
generation a epoch (``keep=2``), and a killed and restarted job resumes
from the newest generation every process holds, with identical state
(parameters, optimizer moments, the data order).  The iterator runs over
the whole synthetic set (4,096 examples, ``RandomState(0)``) with a
GLOBAL batch of ``--batchsize`` x the world size, shuffled from seed 1,
and the updater gives each rank its rows, as the example does; so a
generation saved at one world size resumes at another with the same
global batch (``--batchsize`` scaled).

``--kill-at-epoch N`` simulates a crash after epoch N (``os._exit(99)``,
the checkpoints kept); run the same command without it to resume:

    python -m chainermn_tpu_torch.train_mnist_checkpoint --kill-at-epoch 2
    python -m chainermn_tpu_torch.train_mnist_checkpoint      # resumes

``--device`` (default ``cuda``) and ``--optimizer sgd`` (plain SGD, as in
``train_mnist``) are not flags of the example.
"""

import argparse
import json
import os
import sys


def _parse(argv):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: MNIST with checkpoint / "
                    "resume")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this process's card) or cpu")
    parser.add_argument("--batchsize", type=int, default=128,
                        help="per-rank batch")
    parser.add_argument("--epoch", type=int, default=4)
    parser.add_argument("--unit", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--optimizer", default="adam",
                        choices=("adam", "sgd"))
    parser.add_argument("--out", default="result_mnist_ckpt")
    parser.add_argument("--kill-at-epoch", type=int, default=0,
                        help="simulate a crash after this many epochs "
                             "(0 = off)")
    return parser.parse_args(argv)


def run(argv=None, params=None):
    """``(result, trainer)``; ``params`` (flax ``MLP`` params as numpy)
    replaces the seeded initial weights.  ``result`` holds every epoch's
    mean loss and accuracy as logged (the resumed epochs only, after a
    resume) and the iteration it resumed from."""
    import torch

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.convert import mlp_from_jax
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, cross_entropy_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_train_step
    from chainermn_tpu_torch.train_mnist import (init_mlp,
                                                 make_synthetic_mnist)
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.extensions import (LogReport,
                                                         PrintReport)

    args = _parse(argv)
    comm = create_communicator("xla", device=args.device)

    train = make_synthetic_mnist(4096, seed=0)
    it = SerialIterator(train, args.batchsize * comm.size, shuffle=True,
                        seed=1)

    model = MLP(784, n_units=args.unit)
    if params is None:
        init_mlp(model)
    else:
        mlp_from_jax(params, model)
    model.to(comm.device)
    comm.broadcast_data(model)
    actual = (torch.optim.Adam if args.optimizer == "adam"
              else torch.optim.SGD)(model.parameters(), lr=args.lr)
    optimizer = create_multi_node_optimizer(actual, comm)

    def loss_fn(module, batch):
        xs, ys = batch
        logits = module(xs)
        return cross_entropy_loss(logits, ys), {
            "acc": (logits.argmax(-1) == ys.long()).float().mean()}

    step = make_train_step(loss_fn, optimizer, mesh=comm.mesh, has_aux=True)

    def step_fn(state, batch):
        loss, aux = step(model, batch)
        return state, {"main/loss": loss, "main/acc": aux["acc"]}

    updater = StandardUpdater(it, step_fn, (model, optimizer),
                              mesh=comm.mesh, device=comm.device)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
    log = LogReport(trigger=(1, "epoch"))
    trainer.extend(log)
    # on every rank, as in the example: each process's checkpoint shard
    # then has the same structure, which an elastic resume requires
    trainer.extend(PrintReport(
        ["epoch", "iteration", "main/loss", "main/acc"], log))

    ckpt = create_multi_node_checkpointer(
        "mnist", comm, path=os.path.join(args.out, "checkpoints"), keep=2)
    trainer.extend(ckpt, trigger=(1, "epoch"))

    # ---- automatic resume (reference: maybe_load after a restart) ----
    snap, resumed_iter = ckpt.maybe_load()
    if resumed_iter is not None:
        trainer.load_checkpoint_state(snap)
        if comm.rank == 0:
            print(f"resumed from iteration {resumed_iter} "
                  f"(epoch {trainer.epoch})", flush=True)

    if args.kill_at_epoch:
        class _Killer:
            trigger = (args.kill_at_epoch, "epoch")

            def __call__(self, trainer):
                ckpt.flush()   # the epoch's generation is on disk
                print(f"simulating crash at epoch {trainer.epoch} "
                      f"(checkpoints retained)", flush=True)
                sys.stdout.flush()
                os._exit(99)

        trainer.extend(_Killer(), name="killer")

    try:
        trainer.run()
    finally:
        updater.close()
    result = {"epochs": trainer.epoch, "iterations": trainer.iteration,
              "world": comm.size, "resumed_from": resumed_iter,
              "epoch_losses": [e.get("main/loss") for e in log.log],
              "epoch_accuracies": [e.get("main/acc") for e in log.log]}
    return result, trainer


def main(argv=None) -> int:
    import torch.distributed as dist

    result, _ = run(argv)
    if dist.get_rank() == 0:
        if result["epoch_losses"]:
            print(f"done: epoch {result['epochs']}, final loss "
                  f"{result['epoch_losses'][-1]:.4f}", flush=True)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
