#!/usr/bin/env python
"""CLI: hybrid DP x TP training of the tensor-parallel MLP over a ('data', 'model') mesh.

The port of ``examples/hybrid_parallel/train_hybrid.py`` with the same
flags, minus ``--devices`` and plus ``--device``: the ranks (one process
each, ``torchrun``) form a ``(world/tp, tp)`` mesh, the MLP's hidden
dimension is sharded over ``'model'`` (``tensor_parallel.tp_mlp``: one
sum over the model axis a step) and the global batch over ``'data'`` (the
gradient mean over the data axis), in one step
(``make_hybrid_train_step``).  It regresses a fixed linear map with Adam
and prints the loss every 10 steps and the step rate.

Run:  torchrun --nproc-per-node 4 -m chainermn_tpu_torch.train_hybrid --tp 2
      python -m chainermn_tpu_torch.train_hybrid --device cpu --tp 1
"""

import argparse
import time


def run(argv=None, params=None):
    """Train; returns ``{"mesh", "losses" (each step after the first),
    "final_loss", "steps_per_s", "params" (this rank's shards)}``.
    ``params``: global initial MLP params (numpy or tensors); default:
    ``init_tp_mlp_params`` from seed 0."""
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: hybrid DP x TP")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tp", type=int, default=1,
                        help="model-axis size (the JAX example's default, "
                             "2, assumes its 8 virtual devices)")
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--d-hidden", type=int, default=1024)
    parser.add_argument("--batchsize", type=int, default=64,
                        help="global batch")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-2)
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (init_tp_mlp_params,
                                              make_hybrid_train_step,
                                              param_leaves, tp_mlp,
                                              tp_mlp_specs)
    from chainermn_tpu_torch.topology import dp_tp_mesh, init_distributed

    device = resolve_device(args.device)
    init_distributed(device)
    mesh = dp_tp_mesh(args.tp, "device count {n} not divisible by --tp {tp}")
    dp = mesh.shape["data"]
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"mesh {dp}x{args.tp} (data x model)  "
        f"global_batch={args.batchsize}")
    if params is None:
        params = init_tp_mlp_params(0, args.d_model, args.d_hidden)
    local = shard_from_jax(params, tp_mlp_specs("model"), mesh,
                           device=device, dtype=torch.float32)
    optimizer = torch.optim.Adam(param_leaves(local), lr=args.lr)

    def loss_fn(p, batch):
        y = tp_mlp(batch[0], p, axis_name="model")
        return ((y - batch[1]) ** 2).mean()

    step = make_hybrid_train_step(loss_fn, optimizer, local, mesh)
    rng = np.random.RandomState(0)
    xs = rng.randn(args.batchsize, args.d_model).astype(np.float32)
    w_true = (rng.randn(args.d_model, args.d_model).astype(np.float32)
              / args.d_model)
    batch = (torch.as_tensor(xs, device=device),
             torch.as_tensor(xs @ w_true, device=device))

    step(local, batch)                       # the first step, as JAX's compile
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        losses.append(float(step(local, batch)))
        if (i + 1) % 10 == 0:
            say(f"step {i + 1}  loss {losses[-1]:.6f}")
    dt = time.time() - t0
    say(f"{args.steps / dt:.1f} steps/sec  final loss {losses[-1]:.6f}")
    return {"mesh": (dp, args.tp), "losses": losses,
            "final_loss": losses[-1], "steps_per_s": args.steps / dt,
            "params": local}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
