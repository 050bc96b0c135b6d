"""Ordering edges for communication graphs.

Counterpart of ``chainermn_tpu/functions/pseudo_connect.py`` (reference:
``chainermn/functions/pseudo_connect.py :: PseudoConnect``).  With one
process per rank the graph of a model-parallel step is split over
processes, and a send's backward (the receive of its gradient) belongs to
no loss on the sending rank.  ``pseudo_connect`` grafts the send's
delegate output into the graph of the tensors that are used, so a
``backward()`` from them also runs the delegate's graph: the pending
sends' backward receives, after everything created later, as ChainerMN's
did.  Without it the peer waits for a gradient no one sends.
"""

from __future__ import annotations

import torch


class _PseudoConnect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delegate, *actual):
        ctx.delegate_meta = (delegate.shape, delegate.dtype, delegate.device)
        return tuple(a.view_as(a) for a in actual)

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.delegate_meta
        return (torch.zeros(shape, dtype=dtype, device=device), *grads)


def pseudo_connect(delegate_variable, *actual_variables):
    """``actual_variables`` unchanged in value (one is returned bare,
    several as a tuple), tied to ``delegate_variable`` by an autograd edge
    that carries it a zero gradient."""
    if not actual_variables:
        raise ValueError("pseudo_connect needs at least one actual variable")
    out = _PseudoConnect.apply(delegate_variable, *actual_variables)
    return out[0] if len(out) == 1 else out


__all__ = ["pseudo_connect"]
