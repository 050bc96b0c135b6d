"""Differentiable point-to-point communication.

Counterpart of ``chainermn_tpu/functions/point_to_point.py`` (reference:
``chainermn/functions/point_to_point_communication.py :: Send / Recv``).
Each rank is a process that calls the function on its own block: the
forward is ``ppermute`` over the ``(source, dest)`` pairs, so ``dest``
gets ``source``'s block and a rank no pair sends to gets zeros; the
backward is the inverse permutation, so the cotangent at ``dest`` goes
back to ``source`` (ChainerMN's ``Send.backward == recv``).  Every send
and receive of one call, forward or backward, is posted as one
``batch_isend_irecv`` (a ring of blocking sends deadlocks on NCCL).

A rank that takes part in no pair of a call need not make it; a rank that
does must make it in the same order as its peers, and so must its
backward, which autograd runs in the reverse order of the forward (see
:func:`~chainermn_tpu_torch.functions.pseudo_connect`).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..ops import collective as col
from ..topology import DEFAULT_AXIS_NAME

Ranks = Union[int, Sequence[int]]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, perm):
        ctx.mesh, ctx.perm = mesh, perm
        return col.ppermute(x, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return col.ppermute(g, inverse, ctx.mesh), None, None


def _ppermute(x, perm, axis_name):
    return _PPermute.apply(x, col._mesh(axis_name),
                           [(int(s), int(d)) for s, d in perm])


def send(x, dest: Ranks, source: Ranks, axis_name=DEFAULT_AXIS_NAME):
    """Move rank ``source``'s block to rank ``dest``: ``dest`` gets it,
    every other rank zeros.  ``dest`` / ``source`` may be equal-length
    lists for several transfers at once."""
    dests = [dest] if isinstance(dest, int) else list(dest)
    sources = [source] if isinstance(source, int) else list(source)
    if len(dests) != len(sources):
        raise ValueError(f"{len(sources)} sources vs {len(dests)} dests")
    return _ppermute(x, list(zip(sources, dests)), axis_name)


def recv(x, source: Ranks, dest: Ranks, axis_name=DEFAULT_AXIS_NAME):
    """:func:`send` named from the receiver's side (one wire operation)."""
    return send(x, dest=dest, source=source, axis_name=axis_name)


def ring_exchange(x, shift: int = 1, axis_name=DEFAULT_AXIS_NAME):
    """Every rank sends to ``(rank + shift) % size``; the backward is the
    reverse ring."""
    size = col.axis_size(axis_name)
    return _ppermute(x, [(i, (i + shift) % size) for i in range(size)],
                     axis_name)


__all__ = ["recv", "ring_exchange", "send"]
