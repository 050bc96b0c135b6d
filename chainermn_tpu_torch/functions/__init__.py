"""Differentiable communication (reference: ``chainermn/functions/``).

Counterpart of ``chainermn_tpu/functions/``: the same seven names, each a
``torch.autograd.Function`` over the port's collectives, called by every
rank's process on its own block.
"""

from .collective import all_to_all, allgather, bcast, gather, scatter
from .point_to_point import recv, send
from .pseudo_connect import pseudo_connect

__all__ = ["all_to_all", "allgather", "bcast", "gather", "pseudo_connect",
           "recv", "scatter", "send"]
