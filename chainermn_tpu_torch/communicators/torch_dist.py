"""The process-group communicator: collectives over ``torch.distributed``.

Counterpart of ``chainermn_tpu/communicators/xla.py :: XlaCommunicator``
(reference: ``PureNcclCommunicator``): one process per rank, NCCL between
cards (gloo on the CPU), so every collective is a collective of the
process group, also at world size 1.  Each rank passes its own tensor and
gets its own result (ChainerMN's face; the JAX package's rank-major
stacks are its one-process stand-in for the same thing).  Gradients cross
the wire as one flat bucket (:func:`chainermn_tpu_torch.optimizers
.compressed_mean`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..optimizers import compressed_mean
from ..topology import DEFAULT_AXIS_NAME, Topology, init_distributed, make_mesh
from .base import CommunicatorBase

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


class TorchDistCommunicator(CommunicatorBase):
    """Collectives of the default process group (created by
    :func:`~chainermn_tpu_torch.topology.init_distributed` if there is
    none) on ``device``: this process's card by default."""

    def __init__(self, device="cuda", axis_name: str = DEFAULT_AXIS_NAME):
        dev = resolve_device(device)
        init_distributed(dev)
        self._topo = Topology.detect()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dev.type == "cuda" else dev)
        self.axis_name = axis_name
        self.mesh = make_mesh(axis_name)

    @property
    def rank(self) -> int:
        return self._topo.rank

    @property
    def size(self) -> int:
        return self._topo.size

    @property
    def intra_rank(self) -> int:
        return self._topo.intra_rank

    @property
    def intra_size(self) -> int:
        return self._topo.intra_size

    @property
    def inter_rank(self) -> int:
        return self._topo.inter_rank

    @property
    def inter_size(self) -> int:
        return self._topo.inter_size

    def owns_rank(self, r: int) -> bool:
        return r == self.rank

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device).clone()

    def allreduce(self, x, op: str = "sum"):
        """This rank's tensor reduced over every rank (``"mean"`` is the
        sum over the size, as ``pmean`` is)."""
        out = self._tensor(x)
        dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op])
        return out / self.size if op == "mean" else out

    def bcast(self, x, root: int = 0):
        out = self._tensor(x)
        dist.broadcast(out, src=root)
        return out

    def allgather(self, x):
        """``(size, *s)``: every rank's tensor, rank-major."""
        x = self._tensor(x)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.stack(parts)

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=root)
        return box[0]

    def broadcast_data(self, params):
        """Overwrite every tensor of ``params`` (a module: its parameters
        and buffers; or an iterable of tensors) with rank 0's, in place."""
        tensors = (list(params.parameters()) + list(params.buffers())
                   if isinstance(params, torch.nn.Module) else list(params))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
        return params

    def multi_node_mean_grad(self, grads, allreduce_grad_dtype=None):
        """The cross-rank mean of a list of gradient tensors, one bucket."""
        return compressed_mean(list(grads), self, allreduce_grad_dtype)
