"""Distributed evaluation.

Counterpart of ``chainermn_tpu/evaluators.py`` (reference:
``chainermn/evaluators :: create_multi_node_evaluator``): each rank
evaluates its dataset shard, then the results are combined so every rank
reports the global, example-weighted metrics; ``accuracy_evaluator``,
``corpus_bleu`` and ``bleu_evaluator`` as in the JAX package.

One guard differs.  The JAX package combines across processes when
``communicator.inter_size > 1``: one process per host owns every rank of
its host.  Here one process owns one rank, and two processes on one host
have ``inter_size == 1``; that guard would make every process evaluate
EVERY shard and combine nothing (the right answer at P times the work).
So the guard is "the ranks span more than one process": each process
evaluates the shards it owns and ``allreduce_obj`` combines them.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np

from .communicators.base import CommunicatorBase, _host
from .datasets import ScatteredDataset


def _multi_process(communicator) -> bool:
    """Whether the communicator's ranks run in more than one process."""
    return not all(communicator.owns_rank(r)
                   for r in range(communicator.size))


def _as_shards(scattered, communicator) -> Sequence:
    """Normalize evaluator input to the list of shards THIS process should
    evaluate: every shard in one process; across processes, the shards of
    the ranks this process owns, so the cross-process combine pools each
    shard exactly once and nobody re-evaluates the whole corpus P times."""
    if isinstance(scattered, ScatteredDataset):
        if _multi_process(communicator):
            owned = [r for r in range(min(len(scattered), communicator.size))
                     if communicator.owns_rank(r)]
            # owned may be empty when len(scattered) < communicator.size
            # (more processes than shards): contribute NOTHING rather than
            # re-evaluating another process's shard — the allreduce_obj
            # combine tolerates zero local shards, and a fallback to
            # ``scattered.local()`` would double-count that shard's
            # statistics (its owner evaluates it too).
            return [scattered.shard(r) for r in owned]
        return [scattered.shard(r) for r in range(len(scattered))]
    return list(scattered)


def create_multi_node_evaluator(actual_evaluator: Callable, communicator: CommunicatorBase):
    """Wrap ``actual_evaluator`` for multi-rank evaluation.

    ``actual_evaluator(shard) -> Mapping[str, float]`` evaluates one rank's
    data.  The returned wrapper accepts a :class:`ScatteredDataset` (or a
    sequence of per-rank shards) and returns the cross-rank weighted mean of
    every metric — what each reference rank would see after
    ``allreduce_obj`` averaging.
    """

    def evaluate(scattered) -> Dict[str, float]:
        shards = _as_shards(scattered, communicator)
        totals: Dict[str, float] = {}
        weights: Dict[str, float] = {}
        for shard in shards:
            result: Mapping[str, float] = actual_evaluator(shard)
            w = float(len(shard)) if hasattr(shard, "__len__") else 1.0
            for k, v in result.items():
                totals[k] = totals.get(k, 0.0) + float(v) * w
                weights[k] = weights.get(k, 0.0) + w
        # Cross-process combine: ship (weighted-sum, weight) pairs so the
        # global mean stays example-weighted even when processes hold
        # unequal shards.  Identity in one process (all shards local).
        if _multi_process(communicator):
            # Union of keys with (0, 0) identity: a process that owns no
            # shard (more processes than shards) contributes an empty dict
            # and must not erase everyone else's metrics.
            def combine(a, b):
                zero = (0.0, 0.0)
                return {k: (a.get(k, zero)[0] + b.get(k, zero)[0],
                            a.get(k, zero)[1] + b.get(k, zero)[1])
                        for k in set(a) | set(b)}

            summed = communicator.allreduce_obj(
                {k: (totals[k], weights[k]) for k in totals}, op=combine)
            return {k: s / w for k, (s, w) in summed.items()}
        return {k: totals[k] / weights[k] for k in totals}

    return evaluate


def accuracy_evaluator(predict_fn: Callable, batch_size: int = 256):
    """Convenience: classification loss/accuracy evaluator over a shard.

    ``predict_fn(xs) -> logits`` (numpy or a tensor on any device).  Shard
    items must be ``(x, label)`` pairs.
    """

    def evaluate(shard) -> Dict[str, float]:
        n = len(shard)
        correct, total, loss_sum = 0, 0, 0.0
        for start in range(0, n, batch_size):
            items = [shard[i] for i in range(start, min(start + batch_size, n))]
            xs = np.stack([x for x, _ in items])
            ys = np.asarray([y for _, y in items])
            logits = _host(predict_fn(xs))
            shifted = logits - logits.max(axis=-1, keepdims=True)
            logp = shifted - np.log(np.exp(shifted).sum(axis=-1, keepdims=True))
            loss_sum += float(-logp[np.arange(len(ys)), ys].sum())
            correct += int((logits.argmax(-1) == ys).sum())
            total += len(ys)
        return {"validation/loss": loss_sum / max(total, 1),
                "validation/accuracy": correct / max(total, 1)}

    return evaluate


def _bleu_counts(references, hypotheses, max_n):
    """Sufficient statistics for corpus BLEU: clipped n-gram matches,
    totals, and lengths — these POOL ADDITIVELY across data shards, which
    is what lets the distributed evaluator combine processes exactly."""
    from collections import Counter

    hyp_len = ref_len = 0
    match = [0] * max_n
    total = [0] * max_n
    for ref, hyp in zip(references, hypotheses):
        ref, hyp = list(ref), list(hyp)
        hyp_len += len(hyp)
        ref_len += len(ref)
        for n in range(1, max_n + 1):
            h_ngrams = Counter(tuple(hyp[i:i + n])
                               for i in range(len(hyp) - n + 1))
            r_ngrams = Counter(tuple(ref[i:i + n])
                               for i in range(len(ref) - n + 1))
            total[n - 1] += max(len(hyp) - n + 1, 0)
            match[n - 1] += sum((h_ngrams & r_ngrams).values())
    return match, total, hyp_len, ref_len


def _bleu_from_counts(match, total, hyp_len, ref_len, max_n, smooth):
    import math

    log_p = 0.0
    for n in range(max_n):
        m, t = match[n], total[n]
        if smooth and n > 0:
            m, t = m + 1, t + 1
        if m == 0 or t == 0:
            return 0.0
        log_p += math.log(m / t)
    bp = (1.0 if hyp_len >= ref_len
          else math.exp(1.0 - ref_len / max(hyp_len, 1)))
    return bp * math.exp(log_p / max_n)


def corpus_bleu(references: Sequence[Sequence[int]],
                hypotheses: Sequence[Sequence[int]],
                max_n: int = 4, smooth: bool = True) -> float:
    """Corpus-level BLEU over token-id sequences (no nltk dependency).

    The reference's seq2seq example scored translations with BLEU through
    an nltk-backed trainer extension.  Standard Papineni BLEU:
    clipped modified n-gram precision up to ``max_n``, geometric mean,
    brevity penalty; ``smooth`` adds +1 smoothing on n>1 precisions so one
    missing 4-gram doesn't zero a short corpus.
    """
    if len(references) != len(hypotheses):
        raise ValueError(f"{len(references)} references vs "
                         f"{len(hypotheses)} hypotheses")
    counts = _bleu_counts(references, hypotheses, max_n)
    return _bleu_from_counts(*counts, max_n, smooth)


def bleu_evaluator(translate_fn: Callable, communicator: CommunicatorBase,
                   max_n: int = 4, smooth: bool = True):
    """Distributed BLEU: each rank translates its shard, n-gram COUNT
    statistics pool across processes (BLEU does not decompose into a
    per-shard mean), one corpus score comes back everywhere.

    ``translate_fn(sources) -> list of token-id lists``.  Returns a
    callable ``(scattered_pairs) -> {"bleu": float}`` where each example is
    ``(source_tokens, reference_tokens)``.
    """

    def evaluate(scattered) -> Dict[str, float]:
        shards = _as_shards(scattered, communicator)
        refs: list = []
        hyps: list = []
        for shard in shards:
            srcs = [ex[0] for ex in shard]
            outs = [list(h) for h in translate_fn(srcs)]
            if len(outs) != len(srcs):
                raise ValueError(
                    f"translate_fn returned {len(outs)} hypotheses for "
                    f"{len(srcs)} sources — a silent zip would misalign "
                    f"every later pair")
            refs.extend([list(ex[1]) for ex in shard])
            hyps.extend(outs)
        match, total, hyp_len, ref_len = _bleu_counts(refs, hyps, max_n)
        if _multi_process(communicator):
            # Pool the additive statistics across processes (same combine
            # pattern as create_multi_node_evaluator).
            match, total, hyp_len, ref_len = communicator.allreduce_obj(
                (match, total, hyp_len, ref_len),
                op=lambda a, b: (
                    [x + y for x, y in zip(a[0], b[0])],
                    [x + y for x, y in zip(a[1], b[1])],
                    a[2] + b[2], a[3] + b[3]),
            )
        return {"bleu": _bleu_from_counts(match, total, hyp_len, ref_len,
                                          max_n, smooth)}

    return evaluate
