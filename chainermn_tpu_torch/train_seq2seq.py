#!/usr/bin/env python
"""CLI: distributed seq2seq translation (BASELINE config #3), one process per rank.

The port of ``examples/seq2seq/seq2seq.py`` (the package's
``models/seq2seq.py`` holds the model): rank 0 owns the corpus and the
vocabulary → ``bcast_obj`` of both → ``scatter_dataset(shuffle=True,
seed=0)`` → ``Seq2seq`` → Adam through ``create_multi_node_optimizer`` →
``make_train_step(has_aux=True)``, driven by Trainer / StandardUpdater
with LogReport, PrintReport and the per-epoch validation
``EvaluatorExtension``; then four greedy translations and corpus BLEU
through ``bleu_evaluator``.  The corpus is the JAX example's synthetic
reversal task (ragged source, reversed target).

Batches follow the JAX example: one global ``SerialIterator(shuffle=True,
seed=0)`` walks the union of every rank's shard, and rank ``r`` takes
rows ``[r·B/P, (r+1)·B/P)`` of each global batch (``train.local_rows``),
so the trajectory at any world size is JAX's.  The compute dtype is bf16
on the card and fp32 on the CPU, as the example picks bf16 on its
accelerator (``--dtype`` overrides it).

Run:  python -m chainermn_tpu_torch.train_seq2seq
      torchrun --nproc-per-node 2 -m chainermn_tpu_torch.train_seq2seq
      python -m chainermn_tpu_torch.train_seq2seq --device cpu --epoch 1
"""

import argparse
import json

import numpy as np


def make_corpus(n, vocab, seed, min_len=2, max_len=10):
    """Ragged (source, reversed-source) token pairs, ids >= N_SPECIAL."""
    from chainermn_tpu_torch.models.seq2seq import N_SPECIAL

    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        k = rng.randint(min_len, max_len + 1)
        s = rng.randint(N_SPECIAL, vocab, size=k).tolist()
        pairs.append((s, s[::-1]))
    return pairs


def _parse(argv):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: seq2seq")
    parser.add_argument("--communicator", default="xla",
                        help="xla | pure_nccl | hierarchical | ... (every "
                             "name but naive runs the process group)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this process's card) or cpu")
    parser.add_argument("--batchsize", type=int, default=64,
                        help="global batch")
    parser.add_argument("--epoch", type=int, default=8)
    parser.add_argument("--unit", type=int, default=128)
    parser.add_argument("--layer", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--vocab", type=int, default=32)
    parser.add_argument("--n-train", type=int, default=4096)
    parser.add_argument("--n-val", type=int, default=256)
    parser.add_argument("--bucket", type=int, default=12,
                        help="padded length")
    parser.add_argument("--max-len", type=int, default=10,
                        help="longest source sentence of the corpus")
    parser.add_argument("--dtype", default="auto",
                        choices=("auto", "float32", "bfloat16"),
                        help="compute dtype (auto: bf16 on the card, fp32 "
                             "on the CPU)")
    parser.add_argument("--out", default="result_seq2seq")
    parser.add_argument("--trace-out", default=None,
                        help="write a Chrome-trace / Perfetto JSON here")
    parser.add_argument("--profile-out", default=None,
                        help="write a torch.profiler trace of iterations "
                             "10-14 here")
    args = parser.parse_args(argv)
    if args.communicator == "naive":
        parser.error("--communicator naive is the one-process numpy oracle; "
                     "it cannot carry a training step here")
    return args


def run(argv=None, params=None):
    """``(result, trainer)``: every iteration's loss, the epoch losses and
    accuracies, the validation metrics, four translations and the BLEU
    score.  ``params`` (flax ``Seq2seq`` params as numpy) replaces the
    seeded initial weights."""
    import torch

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.convert import seq2seq_from_jax
    from chainermn_tpu_torch.datasets import scatter_dataset
    from chainermn_tpu_torch.evaluators import bleu_evaluator
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models.seq2seq import (EOS, PAD, Seq2seq,
                                                    encode_pairs,
                                                    masked_cross_entropy,
                                                    token_accuracy)
    from chainermn_tpu_torch.observability import trace
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_train_step
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    from chainermn_tpu_torch.training.extensions import (EvaluatorExtension,
                                                         LogReport,
                                                         PrintReport,
                                                         TorchProfiler)

    args = _parse(argv)
    if args.trace_out:
        trace.reset()
        trace.enable()
    comm = create_communicator(args.communicator, device=args.device)
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} must divide by the "
                         f"world size {comm.size}")
    if comm.rank == 0:
        print(f"communicator={args.communicator} size={comm.size} "
              f"device={comm.device}", flush=True)

    # rank 0 owns the corpus and the vocabulary; the others receive them
    # over the object lane (reference: bcast of the vocabularies)
    if comm.rank == 0:
        vocab = {"size": args.vocab}
        train_pairs = make_corpus(args.n_train, args.vocab, seed=1,
                                  max_len=args.max_len)
        val_pairs = make_corpus(args.n_val, args.vocab, seed=2,
                                max_len=args.max_len)
    else:
        vocab, train_pairs, val_pairs = None, None, None
    vocab = comm.bcast_obj(vocab, root=0)
    train_scattered = scatter_dataset(comm.bcast_obj(train_pairs, root=0),
                                      comm, shuffle=True, seed=0)
    val_pairs = comm.bcast_obj(val_pairs, root=0)

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        args.dtype, torch.bfloat16 if comm.device.type == "cuda"
        else torch.float32)
    model = Seq2seq(vocab["size"], vocab["size"], n_units=args.unit,
                    n_layers=args.layer, dtype=dtype, device=comm.device)
    if params is not None:
        seq2seq_from_jax(params, model)
    comm.broadcast_data(model)
    optimizer = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr), comm)

    def loss_fn(module, batch):
        src, tin, tout = batch
        logits = module(src, tin)
        return masked_cross_entropy(logits, tout), {
            "accuracy": token_accuracy(logits, tout)}

    step = make_train_step(loss_fn, optimizer, mesh=comm.mesh, has_aux=True)
    losses = []         # every iteration's loss, read once at the end

    def step_fn(state, batch):
        loss, aux = step(model, batch)
        losses.append(loss)
        return state, {"main/loss": loss, "main/accuracy": aux["accuracy"]}

    def converter(batch):
        return encode_pairs(batch, args.bucket, args.bucket)

    # the union of every rank's shard, walked by one global iterator; the
    # updater gives this rank its rows of each global batch
    flat = [shard[i] for shard in train_scattered
            for i in range(len(shard))]
    it = SerialIterator(flat, args.batchsize, shuffle=True, seed=0)
    updater = StandardUpdater(it, step_fn, (model, optimizer),
                              converter=converter, mesh=comm.mesh,
                              device=comm.device)
    trainer = Trainer(updater, (args.epoch, "epoch"), out=args.out)

    def on_device(arrays):
        return [torch.from_numpy(a).to(comm.device) for a in arrays]

    vsrc, vtin, vtout = on_device(encode_pairs(val_pairs, args.bucket,
                                               args.bucket))

    # each process scores its strided slice of the validation pairs and the
    # sums pool across processes, so the metrics are the whole set's
    mine = slice(comm.rank, None, comm.size)

    def evaluate(_):
        model.eval()
        with torch.no_grad():
            tout = vtout[mine]
            logits = model(vsrc[mine], vtin[mine])
            n = int((tout != PAD).sum())
            nll = float(masked_cross_entropy(logits, tout)) * n
            hits = round(float(token_accuracy(logits, tout)) * n)
        nll, hits, n = comm.allreduce_obj(
            (nll, hits, n), op=lambda a, b: tuple(x + y for x, y in zip(a, b)))
        return {"loss": nll / max(n, 1), "accuracy": hits / max(n, 1)}

    log = LogReport(trigger=(1, "epoch"))
    trainer.extend(EvaluatorExtension(evaluate, None, trigger=(1, "epoch")))
    if args.profile_out:
        trainer.extend(TorchProfiler(args.profile_out, start=10, stop=15))
    trainer.extend(log)
    if comm.rank == 0:
        trainer.extend(PrintReport(
            ["epoch", "iteration", "main/loss", "main/accuracy",
             "validation/loss", "validation/accuracy", "elapsed_time"], log))
    try:
        trainer.run()
    finally:
        updater.close()

    def strip(row):
        return [int(t) for t in row if t not in (PAD, EOS)]

    # greedy translation samples (the reference printed some)
    toks = model.translate(vsrc[:4], max_len=args.bucket).cpu().numpy()
    translations = []
    for i in range(min(4, len(toks))):
        src_toks = [int(t) for t in vsrc[i].cpu() if t != PAD]
        out_toks = strip(toks[i])
        translations.append((src_toks, out_toks))
        if comm.rank == 0:
            ok = out_toks == src_toks[::-1]
            print(f"src={src_toks} → out={out_toks} {'✓' if ok else '✗'}",
                  flush=True)

    def translate_fn(srcs):
        src_arr, _, _ = encode_pairs([(list(s), list(s)) for s in srcs],
                                     args.bucket, args.bucket)
        out = model.translate(torch.from_numpy(src_arr).to(comm.device),
                              max_len=args.bucket).cpu().numpy()
        return [strip(row) for row in out]

    # each process scores its strided slice; the evaluator pools the
    # n-gram counts, so BLEU is the same at any world size
    local_pairs = [ex for i, ex in enumerate(val_pairs)
                   if i % comm.size == comm.rank]
    bleu = bleu_evaluator(translate_fn, comm)([local_pairs])["bleu"]
    if comm.rank == 0:
        print(f"validation BLEU: {bleu:.4f}", flush=True)

    final = log.log[-1] if log.log else {}
    result = {"epochs": trainer.epoch, "iterations": trainer.iteration,
              "world": comm.size, "dtype": str(dtype).replace("torch.", ""),
              "iteration_losses": [float(v) for v in losses],
              "epoch_losses": [e.get("main/loss") for e in log.log],
              "epoch_accuracies": [e.get("main/accuracy") for e in log.log],
              "validation/loss": final.get("validation/loss"),
              "validation/accuracy": final.get("validation/accuracy"),
              "translations": translations, "bleu": bleu}
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
