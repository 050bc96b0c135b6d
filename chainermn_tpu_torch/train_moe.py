#!/usr/bin/env python
"""CLI: train a classifier whose middle layer is the expert-parallel MoE MLP.

The port of ``examples/moe/train_moe.py`` with the same flags, minus
``--devices`` and plus ``--device`` and ``--dtype``.  The ranks (one
process each, ``torchrun``) form one axis that carries both data
parallelism (the tokens of the global batch split over the ranks) and
expert parallelism (``--experts-per-device`` experts a rank); tokens ride
two all-to-alls a step (``parallel.moe_mlp``, Switch top-1 or GShard
top-2 routing by ``--router-topk``).  In the step
(``make_hybrid_shard_map_step`` with the params' specs) the experts'
gradients stay local and the replicated leaves' are averaged, as in JAX.
The load-balancing loss (``--aux-weight``) keeps the routing from
collapsing onto one expert (``max_expert_frac`` → 1 at ``--aux-weight
0``).

Run:  python -m chainermn_tpu_torch.train_moe
      torchrun --nproc-per-node 4 -m chainermn_tpu_torch.train_moe \\
          --router-topk 2
      python -m chainermn_tpu_torch.train_moe --device cpu --steps 20
"""

import argparse
import time


def parse(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: expert-parallel MoE training")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--d-in", type=int, default=16)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--d-hidden", type=int, default=64)
    parser.add_argument("--num-classes", type=int, default=8)
    parser.add_argument("--experts-per-device", type=int, default=1)
    parser.add_argument("--batchsize", type=int, default=256,
                        help="global tokens per step")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--lr", type=float, default=3e-2)
    parser.add_argument("--aux-weight", type=float, default=0.01)
    parser.add_argument("--capacity-factor", type=float, default=1.5)
    parser.add_argument("--router-topk", type=int, default=1, choices=[1, 2],
                        help="1 = Switch top-1, 2 = GShard top-2 routing")
    return parser.parse_args(argv)


def make_dataset(rng, n, d_in, num_classes):
    """Clustered synthetic data: class = nearest of C random centroids, so
    a router has real structure to specialise experts on."""
    centroids = rng.randn(num_classes, d_in).astype("float32") * 2.0
    labels = rng.randint(0, num_classes, n)
    xs = centroids[labels] + rng.randn(n, d_in).astype("float32")
    return xs.astype("float32"), labels.astype("int64")


def init_params(seed, d_in, d_model, d_hidden, num_classes, experts):
    """The example's GLOBAL params: ``w_in``, the MoE layer, ``w_head``."""
    import torch

    from chainermn_tpu_torch.parallel import init_moe_mlp_params

    gen = torch.Generator().manual_seed(seed)
    return {"w_in": torch.randn(d_in, d_model, generator=gen) * 0.3,
            "moe": init_moe_mlp_params(gen, d_model, d_hidden, experts),
            "w_head": torch.randn(d_model, num_classes, generator=gen) * 0.3}


def run(argv=None, params=None):
    """Train; returns ``{"experts", "losses", "aux" (each step's ce, aux,
    accuracy and max_frac), "seconds", "params" (this rank's shards)}``.
    ``params``: global initial params (the JAX example's numpy tree, or
    the port's tensors); default: :func:`init_params` from seed 0."""
    args = parse(argv)

    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.ops import collective as col
    from chainermn_tpu_torch.parallel import (P, make_hybrid_train_step,
                                              moe_mlp, moe_mlp_specs,
                                              param_leaves)
    from chainermn_tpu_torch.topology import (DEFAULT_AXIS_NAME,
                                              init_distributed, make_nd_mesh)

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    init_distributed(device)
    n_dev = dist.get_world_size()
    ax = DEFAULT_AXIS_NAME
    mesh = make_nd_mesh((ax,), (n_dev,))
    e = args.experts_per_device * n_dev
    if params is None:
        params = init_params(0, args.d_in, args.d_model, args.d_hidden,
                             args.num_classes, e)
    specs = {"w_in": P(), "moe": moe_mlp_specs(ax), "w_head": P()}
    local = shard_from_jax(params, specs, mesh, device=device, dtype=dtype)
    moe = partial(moe_mlp, axis_name=ax, num_experts=e,
                  capacity_factor=args.capacity_factor,
                  router_topk=args.router_topk)

    def loss_fn(p, batch):
        xs, ys = batch
        h = torch.tanh(xs.to(dtype) @ p["w_in"])
        y, aux = moe(h, p["moe"])
        logits = y @ p["w_head"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(1, ys[:, None]).mean()
        acc = (logits.argmax(-1) == ys).float().mean()
        # the routing fractions, for observability (max → 1: collapse)
        with torch.no_grad():
            probs = torch.softmax((h @ p["moe"]["router"]).float(), -1)
            frac = col.pmean(torch.nn.functional.one_hot(
                probs.argmax(-1), e).float().mean(0), mesh.axis(ax))
        return ce + args.aux_weight * aux, {
            "ce": ce, "aux": aux, "accuracy": acc, "max_frac": frac.max()}

    optimizer = torch.optim.Adam(param_leaves(local), lr=args.lr)
    step = make_hybrid_train_step(loss_fn, optimizer, local, mesh,
                                  data_axis=ax, param_specs=specs,
                                  has_aux=True)

    xs, ys = make_dataset(np.random.RandomState(0), args.batchsize * 4,
                          args.d_in, args.num_classes)
    xs, ys = torch.as_tensor(xs, device=device), torch.as_tensor(
        ys, device=device)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    losses, auxes = [], []
    t0 = time.time()
    for i in range(args.steps):
        lo = (i * args.batchsize) % (len(xs) - args.batchsize + 1)
        loss, aux = step(local, (xs[lo:lo + args.batchsize],
                                 ys[lo:lo + args.batchsize]))
        losses.append(float(loss))
        auxes.append({k: float(v) for k, v in aux.items()})
        if i % 10 == 0 or i == args.steps - 1:
            a = auxes[-1]
            say(f"step {i:3d}  loss {losses[-1]:.4f}  ce {a['ce']:.4f}  "
                f"acc {a['accuracy']:.3f}  aux {a['aux']:.3f}  "
                f"max_expert_frac {a['max_frac']:.3f}")
    seconds = time.time() - t0
    say(f"{e} experts on {n_dev} devices, {args.steps} steps in "
        f"{seconds:.1f}s")
    return {"experts": e, "losses": losses, "aux": auxes,
            "seconds": seconds, "params": local}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
