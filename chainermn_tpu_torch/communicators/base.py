"""The communicator interface.

Counterpart of ``chainermn_tpu/communicators/base.py :: CommunicatorBase``
(reference: ``chainermn/communicators/communicator_base.py``): the rank
properties, the array collectives ``allreduce`` / ``bcast`` /
``allgather``, the object broadcast ``bcast_obj``, ``owns_rank`` and the
model helpers ``broadcast_data`` / ``multi_node_mean_grad`` (older name
``allreduce_grad``).

Two data faces, as in ChainerMN and the JAX package:

* :class:`~.torch_dist.TorchDistCommunicator` is multi-process SPMD, one
  process per rank (ChainerMN's own face): every rank passes its own
  tensor and gets its own result;
* :class:`~.naive.NaiveCommunicator` is the one-process numpy oracle over
  rank-major stacks ``(size, *s)``, slab ``r`` being rank ``r``'s value,
  exactly as the JAX package's naive communicator.

Not ported yet (ROADMAP.md, queue A item 3): ``gather``, ``scatter``,
``alltoall``, ``send``/``recv`` and their object variants, ``split``, and
the lanes (``lane_call``, ``DcnLaneError``, the KV lane transport).
"""

from __future__ import annotations

from typing import Any


class CommunicatorBase:
    """API contract shared by the port's communicator backends."""

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def intra_rank(self) -> int:
        raise NotImplementedError

    @property
    def intra_size(self) -> int:
        raise NotImplementedError

    @property
    def inter_rank(self) -> int:
        raise NotImplementedError

    @property
    def inter_size(self) -> int:
        raise NotImplementedError

    def allreduce(self, x, op: str = "sum"):
        raise NotImplementedError

    def bcast(self, x, root: int = 0):
        raise NotImplementedError

    def allgather(self, x):
        raise NotImplementedError

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def broadcast_data(self, params):
        """Replicate parameters from rank 0 to every rank (reference:
        ``broadcast_data(model)``)."""
        raise NotImplementedError

    def multi_node_mean_grad(self, grads):
        """Mean gradients across ranks (reference: ``multi_node_mean_grad``)."""
        raise NotImplementedError

    def allreduce_grad(self, grads):
        return self.multi_node_mean_grad(grads)

    def owns_rank(self, r: int) -> bool:
        """Whether this process runs rank ``r``'s host-side work."""
        return True

    def finalize(self) -> None:
        pass
