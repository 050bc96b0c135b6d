#!/usr/bin/env python
"""CLI: the data-parallel MNIST MLP (BASELINE config #1), one process per rank.

The port of ``examples/mnist/train_mnist.py``: create_communicator →
scatter_dataset(shuffle=True, seed=0) → the MLP → Adam through
create_multi_node_optimizer (``--double-buffering``) → make_train_step,
driven by Trainer / StandardUpdater (``--prefetch``: the background
input thread) with the ObservationAggregator, LogReport and PrintReport,
then the multi-node evaluator over ``scatter_dataset(val,
force_equal_length=False)``.  The same synthetic, learnable MNIST (a
``RandomState(42)`` linear map labels ``RandomState(0)`` / ``(1)``
images); each rank walks its shard in order, ``--batchsize`` rows a step,
as the example does.  The example's default ``--unit`` is 256; the MLP's
own default and the reference ChainerMN example's width is 1000.
``--optimizer sgd`` (not a flag of the example) trains with plain SGD.

Run:  python -m chainermn_tpu_torch.train_mnist --unit 1000
      torchrun --nproc-per-node 4 -m chainermn_tpu_torch.train_mnist
      python -m chainermn_tpu_torch.train_mnist --device cpu --epoch 1
"""

import argparse
import json

import numpy as np


def make_synthetic_mnist(n, seed=0):
    """Learnable stand-in: zero-mean images, labels from one fixed linear
    map shared by every split (so train and val measure the same task)."""
    w_true = np.random.RandomState(42).randn(784, 10).astype(np.float32)
    xs = np.random.RandomState(seed).randn(n, 784).astype(np.float32)
    ys = (xs @ w_true).argmax(-1).astype(np.int32)
    return list(zip(xs, ys))


def init_mlp(model):
    """Weights drawn with ``RandomState(0)`` on the host (N(0, 1/fan_in)
    kernels, zero biases), so every device starts from the same values."""
    import torch

    rng = np.random.RandomState(0)
    with torch.no_grad():
        for i in range(3):
            dense = getattr(model, f"Dense_{i}")
            fan_out, fan_in = dense.weight.shape
            w = rng.randn(fan_in, fan_out).astype(np.float32) / np.sqrt(fan_in)
            dense.weight.copy_(torch.from_numpy(w.T.copy()))
            dense.bias.zero_()
    return model


def _parse(argv):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: MNIST")
    parser.add_argument("--communicator", default="xla",
                        help="xla | pure_nccl | hierarchical | ... (every "
                             "name but naive runs the process group)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this process's card) or cpu")
    parser.add_argument("--batchsize", type=int, default=128,
                        help="per-rank batch")
    parser.add_argument("--epoch", type=int, default=3)
    parser.add_argument("--unit", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--optimizer", default="adam",
                        choices=("adam", "sgd"),
                        help="the example's Adam, or plain SGD (whose fp32 "
                             "trajectory does not amplify rounding as "
                             "Adam's does)")
    parser.add_argument("--n-train", type=int, default=8192)
    parser.add_argument("--n-val", type=int, default=1024)
    parser.add_argument("--double-buffering", action="store_true")
    parser.add_argument("--prefetch", action="store_true")
    parser.add_argument("--out", default="result")
    parser.add_argument("--trace-out", default=None,
                        help="write a Chrome-trace / Perfetto JSON here")
    parser.add_argument("--profile-out", default=None,
                        help="write a torch.profiler trace of iterations "
                             "10-19 here")
    args = parser.parse_args(argv)
    if args.communicator == "naive":
        parser.error("--communicator naive is the one-process numpy oracle; "
                     "it cannot carry a training step here")
    return args


def run(argv=None, params=None):
    """``(result, trainer)``; ``params`` (flax ``MLP`` params as numpy)
    replaces the seeded initial weights."""
    import torch

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.convert import mlp_from_jax
    from chainermn_tpu_torch.datasets import scatter_dataset
    from chainermn_tpu_torch.evaluators import (accuracy_evaluator,
                                                create_multi_node_evaluator)
    from chainermn_tpu_torch.extensions import ObservationAggregator
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, cross_entropy_loss
    from chainermn_tpu_torch.observability import trace
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_train_step
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.extensions import (EvaluatorExtension,
                                                         LogReport,
                                                         PrintReport,
                                                         TorchProfiler)
    from chainermn_tpu_torch.training.trainer import PRIORITY_EDITOR

    args = _parse(argv)
    if args.trace_out:
        trace.reset()
        trace.enable()
    comm = create_communicator(args.communicator, device=args.device)
    if comm.rank == 0:
        print(f"communicator: {type(comm).__name__}  size: {comm.size}",
              flush=True)

    train = make_synthetic_mnist(args.n_train, seed=0)
    val = make_synthetic_mnist(args.n_val, seed=1)
    shard = scatter_dataset(train, comm, shuffle=True, seed=0).local()

    model = MLP(784, n_units=args.unit)
    if params is None:
        init_mlp(model)
    else:
        mlp_from_jax(params, model)
    model.to(comm.device)
    comm.broadcast_data(model)
    actual = (torch.optim.Adam if args.optimizer == "adam"
              else torch.optim.SGD)(model.parameters(), lr=args.lr)
    optimizer = create_multi_node_optimizer(
        actual, comm, double_buffering=args.double_buffering)

    def loss_fn(module, batch):
        xs, ys = batch
        logits = module(xs)
        return cross_entropy_loss(logits, ys), {
            "accuracy": (logits.argmax(-1) == ys.long()).float().mean()}

    step = make_train_step(loss_fn, optimizer, mesh=comm.mesh, has_aux=True)

    def step_fn(state, batch):
        loss, aux = step(model, batch)
        return state, {"main/loss": loss, "main/accuracy": aux["accuracy"]}

    def predict(xs):
        model.eval()
        with torch.no_grad():
            return model(torch.from_numpy(xs).to(comm.device)).float().cpu()

    evaluator = create_multi_node_evaluator(accuracy_evaluator(predict), comm)
    # eval shards stay unequal (no wrap padding): the evaluator's
    # example-weighted mean handles that, padding would double-count
    val_shards = scatter_dataset(val, comm, force_equal_length=False)

    updater = StandardUpdater(
        SerialIterator(shard, args.batchsize, shuffle=False), step_fn,
        (model, optimizer), shard=False, prefetch=args.prefetch,
        device=comm.device)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)
    trainer.extend(ObservationAggregator(comm), trigger=(1, "iteration"),
                   priority=PRIORITY_EDITOR)
    trainer.extend(EvaluatorExtension(evaluator, val_shards,
                                      trigger=(args.epoch, "epoch"),
                                      prefix=""))
    if args.profile_out:
        trainer.extend(TorchProfiler(args.profile_out, start=10, stop=20))
    log = LogReport(trigger=(1, "epoch"))
    trainer.extend(log)
    if comm.rank == 0:
        trainer.extend(PrintReport(
            ["epoch", "iteration", "main/loss", "main/accuracy",
             "validation/loss", "validation/accuracy", "elapsed_time"], log))
    try:
        trainer.run()
    finally:
        updater.close()

    final = log.log[-1] if log.log else {}
    result = {"epochs": trainer.epoch, "iterations": trainer.iteration,
              "world": comm.size,
              "epoch_losses": [e.get("main/loss") for e in log.log],
              "epoch_accuracies": [e.get("main/accuracy") for e in log.log],
              "validation/loss": final.get("validation/loss"),
              "validation/accuracy": final.get("validation/accuracy")}
    if args.trace_out:
        rank = comm.rank if comm.size > 1 else None
        trace.export_chrome_trace(args.trace_out, rank=rank)
        result["trace_out"] = (args.trace_out if rank is None
                               else trace.shard_path(args.trace_out, rank))
        trace.disable()
    return result, trainer


def main(argv=None) -> int:
    result, _ = run(argv)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
