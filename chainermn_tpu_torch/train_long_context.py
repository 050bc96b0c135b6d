#!/usr/bin/env python
"""CLI: train the LM with the sequence sharded over every rank (ring attention or Ulysses).

The port of ``examples/long_context/train_long_context.py`` with the same
flags, minus ``--devices`` and plus ``--device``, ``--dtype`` and
``--sp-impl``.  The ranks (one process each, ``torchrun``) form one
``'sp'`` axis: each holds ``S/P`` tokens of every layer's activations and
keys / values, and attention runs over ``--sp-impl``: ``ring`` (K/V
blocks rotate around the ring, ``parallel.ring_attention``) or
``ulysses`` (two all-to-alls, ``parallel.ulysses_attention``).  Params are
replicated; the gradients are meaned over the axis as in data
parallelism (``make_hybrid_shard_map_step``).  The model memorises a
fixed random token batch with Adam; the first step's loss is printed as
the initial loss, as in the JAX example.

Run:  python -m chainermn_tpu_torch.train_long_context --seq-len 512
      torchrun --nproc-per-node 2 -m chainermn_tpu_torch.train_long_context \\
          --seq-len 8192 --attn-impl flash --dtype bfloat16
      python -m chainermn_tpu_torch.train_long_context --device cpu \\
          --seq-len 64 --steps 5
"""

import argparse
import time


def parse(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: sequence-parallel long-context LM")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--batchsize", type=int, default=2)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--attn-impl", default="xla", choices=["xla", "flash"],
                        help="flash = the flash kernels; xla is exact too")
    parser.add_argument("--sp-impl", default="ring",
                        choices=["ring", "ulysses"],
                        help="ring attention or Ulysses' all-to-alls")
    return parser.parse_args(argv)


def run(argv=None, params=None):
    """Train; returns ``{"initial_loss", "losses" (each later step),
    "final_loss", "step_ms" (each later step, synchronised),
    "tokens_per_s", "params"}``.  ``params``: global initial params (the
    JAX package's numpy tree, or the port's tensors); default:
    ``init_tp_transformer_lm`` from seed 0 with ``max_len = --seq-len``."""
    args = parse(argv)

    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (P, init_tp_transformer_lm,
                                              make_hybrid_shard_map_step,
                                              param_leaves,
                                              sp_transformer_lm_loss)
    from chainermn_tpu_torch.parallel._factory import local_block
    from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    init_distributed(device)
    n = dist.get_world_size()
    if args.seq_len % n:
        raise SystemExit(f"--seq-len {args.seq_len} not divisible by {n} "
                         f"ranks")
    mesh = make_nd_mesh(("sp",), (n,))
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"{n} ranks, {args.seq_len} tokens → {args.seq_len // n} "
        f"tokens/rank  attn={args.attn_impl}  sp={args.sp_impl}")
    if params is None:
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(0), args.vocab, args.d_model,
            args.n_heads, args.n_layers, max_len=args.seq_len, device="cpu")
    local = shard_from_jax(params, P(), mesh, device=device, dtype=dtype)
    optimizer = torch.optim.Adam(param_leaves(local), lr=args.lr)
    loss_fn = partial(sp_transformer_lm_loss,
                      head_dim=args.d_model // args.n_heads, axis_name="sp",
                      attn_impl=args.attn_impl, sp_impl=args.sp_impl)
    step = make_hybrid_shard_map_step(loss_fn, optimizer, local, mesh,
                                      data_axis="sp")

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, args.vocab,
                         (args.batchsize, args.seq_len + 1)).astype(np.int64)
    # shift BEFORE sharding, so each rank's targets follow its inputs
    batch = tuple(local_block(torch.as_tensor(t, device=device),
                              P(None, "sp"), mesh).contiguous()
                  for t in (tokens[:, :-1], tokens[:, 1:]))

    first = float(step(local, batch))
    say(f"initial loss {first:.4f}  (log V = {np.log(args.vocab):.4f})")
    losses, ms = [], []
    t0 = time.time()
    for i in range(args.steps):
        t1 = time.perf_counter()
        losses.append(float(step(local, batch)))    # waits for the device
        ms.append((time.perf_counter() - t1) * 1e3)
        if (i + 1) % 10 == 0:
            say(f"step {i + 1}  loss {losses[-1]:.4f}")
    dt = time.time() - t0
    tok_s = args.steps * args.batchsize * args.seq_len / dt
    final = losses[-1] if losses else first
    say(f"{tok_s:,.0f} tokens/sec  final loss {final:.4f}")
    return {"initial_loss": first, "losses": losses, "final_loss": final,
            "step_ms": ms, "tokens_per_s": tok_s, "params": local}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
