"""Ulysses sequence parallelism: a head ↔ sequence all-to-all around local attention.

Counterpart of ``chainermn_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses).
To attend over a sequence sharded across ``P`` ranks, one all-to-all
swaps the sharded axis from the sequence to the heads, every rank runs
attention over the whole sequence on its ``H/P`` heads (the flash
kernels, or the materialising path), and one all-to-all swaps back.  The
all-to-alls are ``functions.all_to_all`` (differentiable: the backward is
the all-to-all with the axes swapped), so autograd runs the same
collectives in the same order on every rank.

Constraint: ``heads % axis_size == 0``, and under GQA ``kv_heads %
axis_size == 0``; otherwise use ``ring_attention``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from ..functions.collective import all_to_all
from ..ops.flash_attention import flash_attention, resolve_attn_impl
from ._factory import make_sp_attention, model_axis
from .transformer import _attend_local_heads


def ulysses_attention(q, k, v, axis_name, causal: bool = False,
                      attn_impl: str = "auto"):
    """Exact attention over a sequence-sharded axis via two all-to-alls.

    ``q (B, S_local, H, D)``, ``k, v (B, S_local, H_kv, D)``: this rank's
    shards, ``H`` (and ``H_kv``) divisible by the axis size; returns this
    rank's output shard.  ``attn_impl``: ``"flash"``, ``"xla"`` or
    ``"auto"`` (flash on a CUDA device at a GLOBAL sequence the kernels
    take: the attention after the all-to-all sees the whole sequence)."""
    axis = model_axis(axis_name)
    p = 1 if axis is None else axis.size
    impl = resolve_attn_impl(attn_impl, q.shape[1] * p, q.shape[-1],
                             q.device)
    h, h_kv = q.shape[2], k.shape[2]
    if h % p:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by axis size ({p}); "
            "use ring_attention for small head counts")
    if h % h_kv or h_kv % p:
        raise ValueError(
            f"GQA under Ulysses needs q heads ({h}) a multiple of kv heads "
            f"({h_kv}) and kv heads divisible by the axis size ({p}); "
            "use ring_attention otherwise")

    def seq_to_heads(x):
        # (B, S_local, H, D) → (B, S, H/P, D): the whole sequence of this
        # rank's heads
        if axis is None:
            return x
        return all_to_all(x, axis, split_axis=2, concat_axis=1, tiled=True)

    def heads_to_seq(x):
        if axis is None:
            return x
        return all_to_all(x, axis, split_axis=1, concat_axis=2, tiled=True)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if impl == "flash":
        out = flash_attention(qg.contiguous(), kg.contiguous(),
                              vg.contiguous(), causal=causal)
    else:
        out = _attend_local_heads(qg, kg, vg, causal=causal, attn_impl="xla",
                                  head_dim=q.shape[-1])
    return heads_to_seq(out)


def make_ulysses_attention(mesh=None, axis_name: Optional[str] = None,
                           causal: bool = False, attn_impl: str = "auto"):
    """Global face over GLOBAL sequence-sharded tensors (see
    ``_factory.make_sp_attention``)."""
    return make_sp_attention(partial(ulysses_attention, attn_impl=attn_impl), mesh,
                             axis_name, causal)


__all__ = ["make_ulysses_attention", "ulysses_attention"]
