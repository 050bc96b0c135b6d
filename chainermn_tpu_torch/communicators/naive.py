"""Pure-host reference communicator: ``size`` logical ranks in one process.

Counterpart of ``chainermn_tpu/communicators/naive.py``: numpy math over
rank-major stacks ``(size, *s)`` (slab ``r`` is rank ``r``'s value), no
device and no process group, the oracle the process-group backend is
tested against.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np

from .base import CommunicatorBase

_REDUCERS = {
    "sum": lambda x: x.sum(axis=0),
    "mean": lambda x: x.mean(axis=0),
    "max": lambda x: x.max(axis=0),
    "min": lambda x: x.min(axis=0),
    "prod": lambda x: x.prod(axis=0),
}


class NaiveCommunicator(CommunicatorBase):
    """Loopback communicator over rank-major numpy stacks."""

    def __init__(self, size: Optional[int] = None):
        self._size = int(size) if size else 1

    @property
    def rank(self) -> int:
        return 0

    @property
    def size(self) -> int:
        return self._size

    @property
    def intra_rank(self) -> int:
        return 0

    @property
    def intra_size(self) -> int:
        return self._size

    @property
    def inter_rank(self) -> int:
        return 0

    @property
    def inter_size(self) -> int:
        return 1

    def _check(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.shape[0] != self._size:
            raise ValueError(f"rank-major stack must have leading dim "
                             f"{self._size}, got {x.shape}")
        return x

    def allreduce(self, x, op: str = "sum"):
        x = self._check(x)
        return np.broadcast_to(_REDUCERS[op](x), x.shape).copy()

    def bcast(self, x, root: int = 0):
        x = self._check(x)
        return np.broadcast_to(x[root], x.shape).copy()

    def allgather(self, x):
        x = self._check(x)
        return np.broadcast_to(x[None], (self._size,) + x.shape).copy()

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        return pickle.loads(pickle.dumps(obj))

    def broadcast_data(self, params):
        return {k: np.asarray(v) for k, v in params.items()} \
            if isinstance(params, dict) else [np.asarray(v) for v in params]

    def multi_node_mean_grad(self, grads):
        if isinstance(grads, dict):
            return {k: self.allreduce(g, op="mean") for k, g in grads.items()}
        return [self.allreduce(g, op="mean") for g in grads]
