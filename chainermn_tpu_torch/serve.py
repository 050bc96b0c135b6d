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

``--tp N`` (launched by ``torchrun``; N must divide the world size) trains
on the ``(world/N, N)`` ``('data', 'model')`` mesh and serves on the first
N ranks with the model sharded over them (``ServingEngine(mesh=...)``):
rank 0 runs the queue and the scheduler and prints the summary, ranks 1 to
N-1 follow its plan, and the other ranks stop after training.

The model is random-init from ``--seed`` (or loaded with ``--params`` from
a ``convert.save_npz`` file) before training; ``--train-steps 0`` serves
it untrained.  ``--kv-heads`` makes it a GQA model.  ``--temperature T``
samples every request at ``T``, request ``i`` with the key
``fold_in(PRNGKey(seed + 1), i)`` (the JAX CLI's keys, so both CLIs draw
the same noise).

Run:  python -m chainermn_tpu_torch.serve --device cuda
      torchrun --nproc-per-node 2 -m chainermn_tpu_torch.serve --tp 2
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


def train(params, args, head_dim, vocab, mesh):
    """The JAX CLI's recipe on the ``('data', 'model')`` mesh: Adam at
    ``args.lr``, global batches of ``8 · dp`` corpus sequences of
    ``args.seq_len + 1`` tokens from ``RandomState(0)``, each data rank
    taking its 8.  Returns this rank's trained shards, detached."""
    from functools import partial

    import numpy as np
    import torch

    from chainermn_tpu_torch.convert import tree_map
    from chainermn_tpu_torch.parallel import (make_hybrid_train_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    optimizer = torch.optim.Adam(param_leaves(params), lr=args.lr)
    step = make_hybrid_train_step(
        partial(tp_transformer_lm_loss, head_dim=head_dim,
                axis_name="model"), optimizer, params, mesh)
    rng = np.random.RandomState(0)
    device = params["embed"].device
    dp = mesh.shape["data"]
    for i in range(args.train_steps):
        tokens = make_corpus(rng, 8 * dp, args.seq_len, vocab)
        loss = step(params, (torch.as_tensor(tokens, device=device),))
        if i % 30 == 0 or i == args.train_steps - 1:
            print(f"train step {i:3d}  loss {float(loss):.4f}",
                  file=sys.stderr)
    return tree_map(params, lambda t: t.detach())


def run(argv=None, params=None):
    """Train, then serve; returns the ``chainermn_tpu.serve.v1`` summary on
    model rank 0 of the serving ranks, None on the others.  ``params``:
    global initial params (the JAX package's numpy tree, or the port's
    tensors) in place of the random init or ``--params``."""
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch serving demo: continuous-batching "
                    "inference over a slot-managed KV-cache pool")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--tp", type=int, default=1,
                        help="model-axis width for serving (and training)")
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
    import torch.distributed as dist

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import load_npz, shard_from_jax
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              transformer_lm_specs)
    from chainermn_tpu_torch.serving import AdmissionError, ServingEngine
    from chainermn_tpu_torch.topology import (dp_tp_mesh, init_distributed,
                                              make_nd_mesh)

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    init_distributed(device)
    train_mesh = dp_tp_mesh(args.tp, "--tp {tp} does not divide {n} devices")
    total_len = args.prompt_len + args.max_new_tokens
    max_total = args.max_total or max(total_len, 8)
    if params is None and args.params:
        params = load_npz(args.params, device="cpu", dtype=dtype)
    elif params is None:
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(args.seed), args.vocab,
            args.d_model, args.n_heads, args.n_layers,
            max_len=max(max_total, args.seq_len), dtype=dtype,
            n_kv_heads=args.kv_heads, pos_impl=args.pos_impl, device="cpu")
    head_dim = params["embed"].shape[1] // args.n_heads
    vocab = params["embed"].shape[0]
    params = shard_from_jax(params, transformer_lm_specs(params, "model"),
                            train_mesh, device=device, dtype=dtype)
    if args.train_steps > 0:
        params = train(params, args, head_dim, vocab, train_mesh)
    # serving on the first tp ranks: their model coordinates on the
    # training mesh are the serving mesh's, so their shards carry over
    serve_mesh = make_nd_mesh(("model",), (args.tp,), range(args.tp))
    if serve_mesh.coords is None:
        return None
    eng = ServingEngine(params, head_dim=head_dim, n_slots=args.n_slots,
                        max_total=max_total,
                        queue_capacity=args.queue_capacity,
                        mesh=serve_mesh, device=device)
    if not eng.engine.leader:
        eng.follow()
        return None

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

    try:     # the followers wait in follow() until the leader closes
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
    finally:
        eng.close()

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
               "tokens": toks,
               "ttft_ms": (round(h.ttft_ms, 2)
                           if h.ttft_ms is not None else None)}
        if h.status == "done" and len(toks) == args.max_new_tokens:
            acc = float((np.asarray(toks) == want[i]).mean())
            row["continuation_accuracy"] = round(acc, 3)
            correct.append(acc)
        per_request.append(row)

    metrics = eng.metrics()
    summary = {
        "schema": "chainermn_tpu.serve.v1",
        "engine_steps": steps,
        "device": str(device),
        "dtype": args.dtype,
        "tp": args.tp,
        "world": dist.get_world_size(),
        "requests": per_request,
        "mean_continuation_accuracy": (
            round(float(np.mean(correct)), 3) if correct else None),
        "metrics": {k: round(float(v), 3) for k, v in metrics.items()},
    }
    return summary


def main(argv=None):
    summary = run(argv)
    if summary is not None:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
