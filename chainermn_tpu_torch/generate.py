#!/usr/bin/env python
"""CLI: train a tiny LM on a toy corpus over a ('data', 'model') mesh, then decode from it with the KV cache.

The port of ``examples/generate/generate.py`` with the same flags, minus
``--devices`` and plus ``--device``: DP x TP training
(``make_hybrid_train_step`` on the ``(world/tp, tp)`` mesh) into
tensor-parallel KV-cache decoding (``make_lm_generator(mesh, 'model')``:
each rank caches its heads and picks tokens on its vocabulary rows).  The
corpus is arithmetic progressions mod V (each token = previous + step), so
a trained model with a correct cache continues them visibly; ``--pos-impl
rope``, ``--kv-heads`` and ``--temperature`` (sampled with
``PRNGKey(1)``) as in JAX.  Every rank decodes; rank 0 prints.

Run:  torchrun --nproc-per-node 2 -m chainermn_tpu_torch.generate --tp 2
      python -m chainermn_tpu_torch.generate --device cpu --tp 1
"""

import argparse


def run(argv=None, params=None):
    """Train and decode; returns ``{"mesh", "losses" (each step),
    "prompts", "tokens", "want", "accuracy"}``.  ``params``: global initial
    params (the JAX package's numpy tree, or the port's tensors); default:
    ``init_tp_transformer_lm`` from seed 0."""
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: LM training + KV-cache decoding")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tp", type=int, default=1,
                        help="model-axis size (the JAX example's default, "
                             "2, assumes its 8 virtual devices)")
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--kv-heads", type=int, default=None)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=24)
    parser.add_argument("--pos-impl", default="learned",
                        choices=["learned", "rope"])
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--prompt-len", type=int, default=6)
    parser.add_argument("--max-new-tokens", type=int, default=10)
    parser.add_argument("--temperature", type=float, default=0.0)
    args = parser.parse_args(argv)

    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_train_step,
                                              make_lm_generator, param_leaves,
                                              tp_transformer_lm_loss,
                                              transformer_lm_specs)
    from chainermn_tpu_torch.serve import make_corpus
    from chainermn_tpu_torch.topology import dp_tp_mesh, init_distributed

    device = resolve_device(args.device)
    init_distributed(device)
    mesh = dp_tp_mesh(args.tp, "device count {n} not divisible by --tp {tp}")
    dp = mesh.shape["data"]
    head_dim = args.d_model // args.n_heads
    eval_len = max(args.seq_len, args.prompt_len + args.max_new_tokens)
    if params is None:
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(0), args.vocab, args.d_model,
            args.n_heads, args.n_layers, max_len=eval_len,
            pos_impl=args.pos_impl, n_kv_heads=args.kv_heads, device="cpu")
    local = shard_from_jax(params, transformer_lm_specs(params, "model"),
                           mesh, device=device, dtype=torch.float32)
    optimizer = torch.optim.Adam(param_leaves(local), lr=args.lr)
    step = make_hybrid_train_step(
        partial(tp_transformer_lm_loss, head_dim=head_dim,
                axis_name="model"), optimizer, local, mesh)
    say = dist.get_rank() == 0

    rng = np.random.RandomState(0)
    losses = []
    for i in range(args.steps):
        tokens = make_corpus(rng, 8 * dp, args.seq_len, args.vocab)
        losses.append(float(step(local, (torch.as_tensor(
            tokens.astype(np.int64), device=device),))))
        if say and (i % 30 == 0 or i == args.steps - 1):
            print(f"step {i:3d}  loss {losses[-1]:.4f}")

    gen = make_lm_generator(mesh, "model", head_dim=head_dim,
                            max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature)
    test = make_corpus(np.random.RandomState(99), 4, eval_len, args.vocab)
    prompts = test[:, : args.prompt_len]
    want = test[:, args.prompt_len: args.prompt_len + args.max_new_tokens]
    out = gen(local, prompts, prng.PRNGKey(1)).cpu().numpy()
    correct = float((out == want).mean())
    if say:
        for i in range(len(prompts)):
            print(f"prompt {prompts[i].tolist()} -> {out[i].tolist()} "
                  f"(true continuation {want[i].tolist()})")
        print(f"continuation accuracy: {correct:.2f}"
              + ("  (sampled; exactness not expected)"
                 if args.temperature > 0 else ""))
    return {"mesh": (dp, args.tp), "losses": losses, "prompts": prompts,
            "tokens": out, "want": want, "accuracy": correct}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
