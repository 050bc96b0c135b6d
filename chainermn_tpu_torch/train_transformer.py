#!/usr/bin/env python
"""CLI: train the decoder-only transformer LM on one device.

The port of ``examples/transformer/train_transformer.py`` with the same
flags, minus ``--devices`` and ``--tp`` (the port runs at DP = TP = 1 on
one card) and plus ``--device`` and ``--dtype``.  The model memorises a
fixed random token batch with Adam; ``--attn-impl flash`` runs the flash
kernels (forward and fused backward) and ``--ce-impl fused`` the fused
cross-entropy kernels.  Prints the initial loss, the loss every 20 steps
and the throughput.

Run:  python -m chainermn_tpu_torch.train_transformer --device cuda
      python -m chainermn_tpu_torch.train_transformer --device cuda \\
          --dtype bfloat16 --attn-impl flash --ce-impl fused
      python -m chainermn_tpu_torch.train_transformer --device cpu --steps 20
"""

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: transformer LM training on one "
                    "device")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="GQA: fewer KV heads than Q heads")
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--attn-impl", default="auto",
                        choices=["auto", "xla", "flash"])
    parser.add_argument("--ce-impl", default="auto",
                        choices=["auto", "xla", "fused"],
                        help="LM-head loss path; 'fused' = the fused "
                             "cross-entropy kernels (big-vocab heads)")
    args = parser.parse_args(argv)

    from functools import partial

    import numpy as np
    import torch

    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_shard_map_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    print(f"device {args.device} {args.dtype}  LM: V={args.vocab} "
          f"D={args.d_model} H={args.n_heads} L={args.n_layers} "
          f"S={args.seq_len}  attn={args.attn_impl} ce={args.ce_impl}")
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(0), args.vocab, args.d_model,
        args.n_heads, args.n_layers, max_len=args.seq_len,
        dtype=getattr(torch, args.dtype), n_kv_heads=args.kv_heads,
        device=args.device)
    optimizer = torch.optim.Adam(param_leaves(params), lr=args.lr)
    loss_fn = partial(tp_transformer_lm_loss,
                      head_dim=args.d_model // args.n_heads,
                      attn_impl=args.attn_impl, ce_impl=args.ce_impl)
    step = make_hybrid_shard_map_step(loss_fn, optimizer, params)

    # tiny synthetic corpus: fixed random token sequences to memorize
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, args.vocab,
                         (args.batchsize, args.seq_len + 1)).astype(np.int64)
    batch = (torch.as_tensor(tokens, device=params["embed"].device),)

    loss = step(params, batch)
    print(f"initial loss {float(loss):.4f}  (log V = {np.log(args.vocab):.4f})")
    t0 = time.time()
    for i in range(args.steps):
        loss = step(params, batch)
        if (i + 1) % 20 == 0:
            print(f"step {i + 1}  loss {float(loss):.4f}")
    final = float(loss)            # waits for the device
    dt = time.time() - t0
    tok_s = args.steps * args.batchsize * args.seq_len / dt
    print(f"{tok_s:,.0f} tokens/sec  final loss {final:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
