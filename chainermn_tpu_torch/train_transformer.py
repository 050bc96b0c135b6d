#!/usr/bin/env python
"""CLI: train the decoder-only transformer LM with DP x TP over a ('data', 'model') mesh.

The port of ``examples/transformer/train_transformer.py`` with the same
flags, minus ``--devices`` and plus ``--device`` and ``--dtype``.  The
ranks (one process each, ``torchrun``) form a ``(world/tp, tp)`` mesh:
heads, MLP columns and the vocabulary sharded over ``'model'``
(Megatron-style, ``parallel.transformer``), the global batch over
``'data'``, in one step (``make_hybrid_train_step``).  The model memorises
a fixed random token batch with Adam; ``--attn-impl flash`` runs the flash
kernels (forward and fused backward) and ``--ce-impl fused`` the fused
cross-entropy kernels.  Prints the mesh, the initial loss, the loss every
20 steps and the throughput.  Without torchrun the world is this one
process, hence the default ``--tp 1``.

Run:  python -m chainermn_tpu_torch.train_transformer --tp 1
      torchrun --nproc-per-node 2 -m chainermn_tpu_torch.train_transformer \\
          --tp 2 --dtype bfloat16 --attn-impl flash --ce-impl fused
      python -m chainermn_tpu_torch.train_transformer --device cpu --tp 1 \\
          --steps 20
"""

import argparse
import time


def parse(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: DP x TP transformer LM")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--tp", type=int, default=1,
                        help="model-axis size (the JAX example's default, "
                             "2, assumes its 8 virtual devices)")
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="GQA: fewer KV heads than Q heads (must stay "
                             "divisible by --tp)")
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--batchsize", type=int, default=32,
                        help="global batch")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--attn-impl", default="auto",
                        choices=["auto", "xla", "flash"])
    parser.add_argument("--ce-impl", default="auto",
                        choices=["auto", "xla", "fused"],
                        help="LM-head loss path; 'fused' = the fused "
                             "cross-entropy kernels (big-vocab heads)")
    return parser.parse_args(argv)


def run(argv=None, params=None):
    """Train; returns ``{"mesh", "initial_loss", "losses" (each step),
    "final_loss", "tokens_per_s", "params" (this rank's shards)}``.
    ``params``: global initial params (the JAX package's numpy tree, or the
    port's tensors); default: ``init_tp_transformer_lm`` from seed 0."""
    args = parse(argv)

    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_train_step,
                                              param_leaves,
                                              tp_transformer_lm_loss,
                                              transformer_lm_specs)
    from chainermn_tpu_torch.topology import dp_tp_mesh, init_distributed

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    init_distributed(device)
    mesh = dp_tp_mesh(args.tp, "device count {n} not divisible by --tp {tp}")
    dp = mesh.shape["data"]
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"mesh {dp}x{args.tp} (data x model)  "
        f"LM: V={args.vocab} D={args.d_model} H={args.n_heads} "
        f"L={args.n_layers} S={args.seq_len}  attn={args.attn_impl}")
    if params is None:
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(0), args.vocab, args.d_model,
            args.n_heads, args.n_layers, max_len=args.seq_len,
            n_kv_heads=args.kv_heads, device="cpu")
    local = shard_from_jax(params, transformer_lm_specs(params, "model"),
                           mesh, device=device, dtype=dtype)
    optimizer = torch.optim.Adam(param_leaves(local), lr=args.lr)
    loss_fn = partial(tp_transformer_lm_loss,
                      head_dim=args.d_model // args.n_heads,
                      axis_name="model", attn_impl=args.attn_impl,
                      ce_impl=args.ce_impl)
    step = make_hybrid_train_step(loss_fn, optimizer, local, mesh)

    # tiny synthetic corpus: fixed random token sequences to memorize
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, args.vocab,
                         (args.batchsize, args.seq_len + 1)).astype(np.int64)
    batch = (torch.as_tensor(tokens, device=device),)

    first = float(step(local, batch))
    say(f"initial loss {first:.4f}  (log V = {np.log(args.vocab):.4f})")
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        losses.append(float(step(local, batch)))   # waits for the device
        if (i + 1) % 20 == 0:
            say(f"step {i + 1}  loss {losses[-1]:.4f}")
    dt = time.time() - t0
    tok_s = args.steps * args.batchsize * args.seq_len / dt
    final = losses[-1] if losses else first
    say(f"{tok_s:,.0f} tokens/sec  final loss {final:.4f}")
    return {"mesh": (dp, args.tp), "initial_loss": first, "losses": losses,
            "final_loss": final, "tokens_per_s": tok_s, "params": local}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
