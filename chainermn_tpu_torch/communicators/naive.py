"""Pure-host reference communicator: ``size`` logical ranks in one process.

Counterpart of ``chainermn_tpu/communicators/naive.py``: numpy math over
rank-major stacks ``(size, *s)`` (slab ``r`` is rank ``r``'s value), no
device and no process group, the oracle the process-group backend is
tested against.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, List, Optional

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
        self._mailbox: List[bytes] = []  # FIFO for send_obj/recv_obj loopback

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

    # ---- array collectives ----
    def _check(self, x) -> np.ndarray:
        return self._check_leading(np.asarray(x))

    def allreduce(self, x, op: str = "sum"):
        x = self._check(x)
        return np.broadcast_to(_REDUCERS[op](x), x.shape).copy()

    def bcast(self, x, root: int = 0):
        x = self._check(x)
        return np.broadcast_to(x[root], x.shape).copy()

    def gather(self, x, root: int = 0):
        return self._check(x).copy()

    def allgather(self, x):
        x = self._check(x)
        return np.broadcast_to(x[None], (self._size,) + x.shape).copy()

    def alltoall(self, x):
        x = self._check(x)
        if x.ndim < 2 or x.shape[1] != self._size:
            raise ValueError(f"alltoall needs shape (size, size, ...), got "
                             f"{x.shape}")
        return np.swapaxes(x, 0, 1).copy()

    def scatter(self, x, root: int = 0):
        # root's (size, *s) payload, slab r to rank r: for a rank-major
        # stack that is the identity layout
        return self._check(x).copy()

    def send(self, x, dest: int, source: int):
        x = self._check(x).copy()
        x[dest] = x[source]
        return x

    # ---- object transport ----
    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        return pickle.loads(pickle.dumps(obj))

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        return [pickle.loads(pickle.dumps(obj)) for _ in range(self._size)]

    def allgather_obj(self, obj: Any) -> List[Any]:
        return self.gather_obj(obj)

    def allreduce_obj(self, obj: Any, op: Optional[Callable] = None) -> Any:
        op = op or (lambda a, b: a + b)
        out = obj
        for _ in range(self._size - 1):
            out = op(out, obj)
        return out

    def send_obj(self, obj: Any, dest: int) -> None:
        self._mailbox.append(pickle.dumps(obj))

    def recv_obj(self, source: int) -> Any:
        return pickle.loads(self._mailbox.pop(0))

    # ---- model helpers ----
    def broadcast_data(self, params):
        return {k: np.asarray(v) for k, v in params.items()} \
            if isinstance(params, dict) else [np.asarray(v) for v in params]

    def multi_node_mean_grad(self, grads):
        if isinstance(grads, dict):
            return {k: self.allreduce(g, op="mean") for k, g in grads.items()}
        return [self.allreduce(g, op="mean") for g in grads]

    def split(self, color, key: int = 0):
        """A scalar color puts every rank in one group (the whole world);
        a sequence of per-rank colors gives ``{color: communicator}`` sized
        by each group's membership.  ``key`` is accepted and ignored, as in
        the JAX package."""
        if isinstance(color, int):
            return NaiveCommunicator(size=self._size)
        if len(color) != self._size:
            raise ValueError(f"need {self._size} colors, got {len(color)}")
        groups = {}
        for c in color:
            groups[int(c)] = groups.get(int(c), 0) + 1
        return {c: NaiveCommunicator(size=n) for c, n in sorted(groups.items())}
