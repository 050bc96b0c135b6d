#!/usr/bin/env python
"""CLI: train the toy LM, then serve it with continuous batching.

``python -m chainermn_tpu.serve``'s single-engine path with the same flags:
train the LM on the arithmetic-progression corpus (``--train-steps``,
default 60, Adam at ``--lr`` on ``--seq-len`` tokens; the loss goes to
stderr every 30 steps), then stand up a
:class:`chainermn_tpu_torch.serving.ServingEngine` and push a
STAGGERED request schedule through it (the first wave fills the slot pool,
later requests arrive every ``--stagger-every`` engine steps while it is
still decoding).  Prompts come from the same arithmetic-progression corpus
as the JAX CLI.  Prints one ``chainermn_tpu.serve.v1`` summary JSON line
on stdout (per-request outcomes + the serving metrics).

The model is random-init from ``--seed`` (or loaded with ``--params`` from
a ``convert.save_npz`` file) before training; ``--train-steps 0`` serves
it untrained.  ``--kv-heads`` makes it a GQA model.  ``--temperature T``
samples every request at ``T``, request ``i`` with the key
``fold_in(PRNGKey(seed + 1), i)`` (the JAX CLI's keys, so both CLIs draw
the same noise).

Run:  python -m chainermn_tpu_torch.serve --device cuda
      python -m chainermn_tpu_torch.serve --device cuda --dtype bfloat16 \\
          --vocab 32768 --d-model 1024 --n-heads 16 --n-layers 8 \\
          --n-slots 8 --max-total 1024 --requests 16 --prompt-len 512 \\
          --max-new-tokens 64
      python -m chainermn_tpu_torch.serve --device cpu --requests 4
"""

import argparse
import json
import sys


def make_corpus(rng, n, seq_len, vocab):
    """Arithmetic progressions mod vocab (the JAX CLI's corpus)."""
    import numpy as np

    starts = rng.randint(0, vocab, n)
    steps = rng.randint(1, 4, n)
    pos = np.arange(seq_len + 1)
    return ((starts[:, None] + steps[:, None] * pos[None]) % vocab
            ).astype("int32")


def train(params, args, head_dim, vocab):
    """The JAX CLI's recipe at world 1: Adam at ``args.lr``, batches of 8
    corpus sequences of ``args.seq_len + 1`` tokens from
    ``RandomState(0)``.  Returns the trained params, detached."""
    from functools import partial

    import numpy as np
    import torch

    from chainermn_tpu_torch.convert import tree_map
    from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    optimizer = torch.optim.Adam(param_leaves(params), lr=args.lr)
    step = make_hybrid_shard_map_step(
        partial(tp_transformer_lm_loss, head_dim=head_dim), optimizer,
        params)
    rng = np.random.RandomState(0)
    device = params["embed"].device
    for i in range(args.train_steps):
        tokens = make_corpus(rng, 8, args.seq_len, vocab)
        loss = step(params, (torch.as_tensor(tokens, device=device),))
        if i % 30 == 0 or i == args.train_steps - 1:
            print(f"train step {i:3d}  loss {float(loss):.4f}",
                  file=sys.stderr)
    return tree_map(params, lambda t: t.detach())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch serving demo: continuous-batching "
                    "inference over a slot-managed KV-cache pool")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--params", default=None,
                        help="load params from a convert.save_npz file "
                             "instead of a random init")
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="KV heads (GQA); default: one per query head")
    parser.add_argument("--seq-len", type=int, default=24)
    parser.add_argument("--pos-impl", default="learned",
                        choices=["learned", "rope"])
    parser.add_argument("--train-steps", type=int, default=60,
                        help="toy-LM training steps before serving")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random init")
    parser.add_argument("--n-slots", type=int, default=4)
    parser.add_argument("--max-total", type=int, default=None,
                        help="per-slot capacity (default: fits prompt + "
                             "max-new)")
    parser.add_argument("--queue-capacity", type=int, default=16)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--prompt-len", type=int, default=6)
    parser.add_argument("--max-new-tokens", type=int, default=8)
    parser.add_argument("--stagger-every", type=int, default=2,
                        help="submit one later-wave request every N engine "
                             "steps after the first wave")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="per-request sampling temperature (0 = greedy); "
                             "request i samples with fold_in(PRNGKey(seed + "
                             "1), i)")
    parser.add_argument("--steps-budget", type=int, default=None,
                        help="hard cap on engine iterations (the run exits "
                             "cleanly with whatever finished)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch.convert import load_npz
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serving import AdmissionError, ServingEngine

    dtype = getattr(torch, args.dtype)
    total_len = args.prompt_len + args.max_new_tokens
    max_total = args.max_total or max(total_len, 8)
    if args.params:
        params = load_npz(args.params, device=args.device, dtype=dtype)
    else:
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(args.seed), args.vocab,
            args.d_model, args.n_heads, args.n_layers,
            max_len=max(max_total, args.seq_len), dtype=dtype,
            n_kv_heads=args.kv_heads, pos_impl=args.pos_impl,
            device=args.device)
    head_dim = params["embed"].shape[1] // args.n_heads
    vocab = params["embed"].shape[0]
    if args.train_steps > 0:
        params = train(params, args, head_dim, vocab)
    eng = ServingEngine(params, head_dim=head_dim, n_slots=args.n_slots,
                        max_total=max_total,
                        queue_capacity=args.queue_capacity,
                        device=args.device)

    test = make_corpus(np.random.RandomState(99), args.requests, total_len,
                       vocab)
    prompts = test[:, : args.prompt_len]
    want = test[:, args.prompt_len: args.prompt_len + args.max_new_tokens]

    handles, rejected = {}, {}
    sample_kw = {}
    if args.temperature > 0:
        base_key = prng.PRNGKey(args.seed + 1)
        sample_kw = {i: {"temperature": args.temperature,
                         "rng": prng.fold_in(base_key, i)}
                     for i in range(args.requests)}

    def submit(i):
        try:
            handles[i] = eng.submit(prompts[i], args.max_new_tokens,
                                    **sample_kw.get(i, {}))
        except AdmissionError as e:
            rejected[i] = e.to_dict()
            print(f"request {i} rejected: {e}", file=sys.stderr)

    first_wave = min(args.n_slots, args.requests)
    for i in range(first_wave):
        submit(i)
    steps, nxt = 0, first_wave
    budget = args.steps_budget

    def busy():
        return eng.scheduler.queue_depth > 0 or eng.pool.busy_count > 0

    while (budget is None or steps < budget) and (nxt < args.requests
                                                  or busy()):
        eng.step()
        steps += 1
        if nxt < args.requests and steps % max(args.stagger_every, 1) == 0:
            submit(nxt)
            nxt += 1

    per_request, correct = [], []
    for i in range(args.requests):
        if i in rejected:
            per_request.append(dict({"id": i, "status": "rejected"},
                                    **rejected[i]))
            continue
        h = handles.get(i)
        if h is None:
            per_request.append({"id": i, "status": "not_submitted"})
            continue
        toks = h.tokens
        row = {"id": h.id, "status": h.status,
               "finish_reason": h.finish_reason, "n_tokens": len(toks),
               "ttft_ms": (round(h.ttft_ms, 2)
                           if h.ttft_ms is not None else None)}
        if h.status == "done" and len(toks) == args.max_new_tokens:
            acc = float((np.asarray(toks) == want[i]).mean())
            row["continuation_accuracy"] = round(acc, 3)
            correct.append(acc)
        per_request.append(row)

    metrics = eng.metrics()
    eng.close()
    summary = {
        "schema": "chainermn_tpu.serve.v1",
        "engine_steps": steps,
        "device": str(torch.device(args.device)),
        "dtype": args.dtype,
        "requests": per_request,
        "mean_continuation_accuracy": (
            round(float(np.mean(correct)), 3) if correct else None),
        "metrics": {k: round(float(v), 3) for k, v in metrics.items()},
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
