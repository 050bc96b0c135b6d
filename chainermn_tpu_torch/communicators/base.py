"""The communicator interface.

Counterpart of ``chainermn_tpu/communicators/base.py :: CommunicatorBase``
(reference: ``chainermn/communicators/communicator_base.py``): the rank
properties, the array collectives ``allreduce`` / ``bcast`` / ``gather`` /
``allgather`` / ``alltoall`` / ``scatter`` / ``send`` / ``recv``, the
object transport ``bcast_obj`` / ``gather_obj`` / ``allgather_obj`` /
``allreduce_obj`` / ``send_obj`` / ``recv_obj``, ``split``, ``device_of``,
``owns_rank``, ``stack`` / ``unstack`` and the model helpers
``broadcast_data`` / ``multi_node_mean_grad`` (older name
``allreduce_grad``).

Two data faces, as in ChainerMN and the JAX package:

* :class:`~.torch_dist.TorchDistCommunicator` is multi-process SPMD, one
  process per rank (ChainerMN's own face): every rank passes its own
  tensor and gets its own result;
* :class:`~.naive.NaiveCommunicator` is the one-process numpy oracle over
  rank-major stacks ``(size, *s)``, slab ``r`` being rank ``r``'s value,
  exactly as the JAX package's naive communicator.

Not ported yet: ``allgather_obj_eventual``, the lanes (``lane_call``,
``DcnLaneError``, ``kv_lane_transport``) and ``gang_lease_store``
(ROADMAP.md, queue A items A7 and A11).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np


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

    # ---- array collectives ----
    def allreduce(self, x, op: str = "sum"):
        raise NotImplementedError

    def bcast(self, x, root: int = 0):
        raise NotImplementedError

    def gather(self, x, root: int = 0):
        raise NotImplementedError

    def allgather(self, x):
        raise NotImplementedError

    def alltoall(self, x):
        raise NotImplementedError

    def scatter(self, x, root: int = 0):
        raise NotImplementedError

    def send(self, x, dest: int, source: int):
        """Move rank ``source``'s value to rank ``dest`` (one-shot p2p)."""
        raise NotImplementedError

    def recv(self, x, source: int, dest: int):
        return self.send(x, dest=dest, source=source)

    # ---- object (pickle) transport: the setup path, never hot ----
    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        raise NotImplementedError

    def allgather_obj(self, obj: Any) -> List[Any]:
        raise NotImplementedError

    def allreduce_obj(self, obj: Any, op: Optional[Callable] = None) -> Any:
        """Every rank's ``obj`` folded by ``op`` (default ``a + b``) in
        rank order."""
        op = op or (lambda a, b: a + b)
        gathered = self.allgather_obj(obj)
        out = gathered[0]
        for o in gathered[1:]:
            out = op(out, o)
        return out

    def send_obj(self, obj: Any, dest: int) -> None:
        raise NotImplementedError

    def recv_obj(self, source: int) -> Any:
        raise NotImplementedError

    # ---- placement ----
    def device_of(self, rank: int):
        """The device that runs ``rank``, or None when the communicator has
        no device (the naive loopback)."""
        return None

    # ---- model helpers ----
    def broadcast_data(self, params):
        """Replicate parameters from rank 0 to every rank (reference:
        ``broadcast_data(model)``)."""
        raise NotImplementedError

    def multi_node_mean_grad(self, grads):
        """Mean gradients across ranks (reference: ``multi_node_mean_grad``)."""
        raise NotImplementedError

    def allreduce_grad(self, grads):
        return self.multi_node_mean_grad(grads)

    # ---- structure ----
    def split(self, color, key: int = 0):
        """Partition the ranks into sub-communicators (reference:
        ``mpi_comm.Split(color, key)``); see each backend for its face."""
        raise NotImplementedError

    def owns_rank(self, r: int) -> bool:
        """Whether this process runs rank ``r``'s host-side work."""
        return True

    def finalize(self) -> None:
        pass

    # ---- conveniences shared by all backends ----
    def stack(self, per_rank: Sequence[Any]):
        """A rank-major stack ``(size, *s)`` from one array per rank."""
        if len(per_rank) != self.size:
            raise ValueError(f"need {self.size} per-rank arrays, got "
                             f"{len(per_rank)}")
        return self._place(np.stack([_host(a) for a in per_rank]))

    def unstack(self, x) -> List[np.ndarray]:
        """A rank-major stack back into one numpy array per rank."""
        x = _host(x)
        return [x[r] for r in range(x.shape[0])]

    def _place(self, x):
        """Backend hook: a host array into the backend's native layout."""
        return x

    def _check_leading(self, x):
        if x.shape[0] != self.size:
            raise ValueError(f"rank-major stack must have leading dim "
                             f"{self.size}, got {tuple(x.shape)}")
        return x


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a torch tensor anywhere, or array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
