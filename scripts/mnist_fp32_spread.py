#!/usr/bin/env python3
"""How far fp32 rounding alone moves the MNIST example's trajectory.

Runs ``python -m chainermn_tpu_torch.train_mnist`` on the CPU (``--unit
1000 --batchsize 128 --epoch 1`` by default: 64 Adam steps; ``--optimizer
sgd --lr 0.1`` for plain SGD) once as is and then ``--runs`` times with
additive noise of ``--scale`` x max|g| drawn into every gradient before
each step, standing in for a device that
sums the same products in another order (fp32's unit roundoff is
6e-8).  Prints one JSON line per noisy run: the epoch loss's relative
difference from the clean run, the largest per-iteration relative
difference, and the validation loss's relative and accuracy's absolute
differences.  These say what a
card-vs-CPU comparison of this recipe can hold; they are CPU arithmetic,
not device measurements.

    python3 scripts/mnist_fp32_spread.py --runs 4 --scale 1e-7
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=4)
    parser.add_argument("--scale", type=float, default=1e-7)
    parser.add_argument("--unit", type=int, default=1000)
    parser.add_argument("--optimizer", default="adam", choices=("adam", "sgd"))
    parser.add_argument("--lr", type=float, default=None,
                        help="default: train_mnist's")
    parser.add_argument("--out", default="build/mnist_fp32_spread")
    args = parser.parse_args(argv)

    import torch

    import chainermn_tpu_torch.training.extensions as ext
    from chainermn_tpu_torch import train_mnist

    log_report = ext.LogReport
    ext.LogReport = lambda trigger=None, **kw: log_report(
        trigger=(1, "iteration"))          # one log entry per iteration
    name = {"adam": "Adam", "sgd": "SGD"}[args.optimizer]
    base = getattr(torch.optim, name)

    def run(scale, seed):
        gen = torch.Generator().manual_seed(seed)

        class Noisy(base):
            def step(self, closure=None):
                for group in self.param_groups:
                    for p in group["params"]:
                        if p.grad is not None and scale:
                            p.grad.add_(scale * p.grad.abs().max()
                                        * torch.randn(p.grad.shape,
                                                      generator=gen))
                return super().step(closure)

        setattr(torch.optim, name, Noisy)
        result, _ = train_mnist.run(
            ["--device", "cpu", "--unit", str(args.unit), "--epoch", "1",
             "--out", args.out, "--optimizer", args.optimizer]
            + ([] if args.lr is None else ["--lr", str(args.lr)]))
        return result

    clean = run(0.0, 0)
    losses = clean["epoch_losses"]
    mean = sum(losses) / len(losses)
    for seed in range(1, args.runs + 1):
        noisy = run(args.scale, seed)
        other = noisy["epoch_losses"]
        print(json.dumps({
            "scale": args.scale, "seed": seed, "unit": args.unit,
            "optimizer": args.optimizer,
            "epoch_loss_rel_diff": abs(sum(other) / len(other) - mean) / mean,
            "max_iteration_rel_diff": max(abs(a - b) / a
                                          for a, b in zip(losses, other)),
            "val_loss_rel_diff": abs(noisy["validation/loss"]
                                     - clean["validation/loss"])
            / clean["validation/loss"],
            "val_accuracy_diff": abs(noisy["validation/accuracy"]
                                     - clean["validation/accuracy"])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
