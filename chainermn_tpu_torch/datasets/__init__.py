"""Dataset scattering.

A copy of ``chainermn_tpu/datasets/__init__.py`` (reference:
``chainermn/datasets/``): ``scatter_dataset`` draws the permutation at the
root, broadcasts it with the communicator's ``bcast_obj`` and splits it
into per-rank index sets (``SubDataset`` views, wrap-padded to equal
length); ``scatter_index`` and ``create_empty_dataset`` as in the
reference.  Nothing here touches a device.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..communicators.base import CommunicatorBase


class SubDataset:
    """A view of ``dataset`` through an index array, wrap-padded to
    ``virtual_length`` (reference: chainer SubDataset equal-length trick so
    every rank runs the same number of iterations)."""

    def __init__(self, dataset, indices: np.ndarray, virtual_length: Optional[int] = None):
        self._dataset = dataset
        self._indices = np.asarray(indices, dtype=np.int64)
        self._virtual_length = int(virtual_length or len(self._indices))

    def __len__(self) -> int:
        return self._virtual_length

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        i %= len(self)  # normalize negatives against the VIRTUAL length
        return self._dataset[int(self._indices[i % len(self._indices)])]

    @property
    def indices(self) -> np.ndarray:
        return self._indices


class ScatteredDataset:
    """All ranks' shards at once (single-controller owns every rank).

    ``shard(r)`` is what reference rank ``r`` would have received from
    ``scatter_dataset``; ``local()`` is this process's shard (parity face
    under multi-controller).
    """

    def __init__(self, dataset, shards: Sequence[np.ndarray], equal_length: bool,
                 local_rank: int = 0):
        vlen = max(len(s) for s in shards) if equal_length else None
        self._subs = [SubDataset(dataset, s, vlen) for s in shards]
        self._local_rank = local_rank

    def __len__(self) -> int:
        return len(self._subs)

    def shard(self, rank: int) -> SubDataset:
        return self._subs[rank]

    def local(self) -> SubDataset:
        """This process's shard (rank-parity face under multi-controller)."""
        return self._subs[self._local_rank]

    def __iter__(self):
        return iter(self._subs)


def scatter_dataset(
    dataset,
    comm: CommunicatorBase,
    root: int = 0,
    shuffle: bool = False,
    seed: Optional[int] = None,
    force_equal_length: bool = True,
) -> ScatteredDataset:
    """Partition ``dataset`` across ranks (reference: ``scatter_dataset`` [uv]).

    The root draws the permutation and broadcasts it object-wise so every
    rank agrees on the split (the reference scattered pickled SubDatasets;
    we scatter indices — same contract, no payload duplication).
    """
    n = len(dataset)
    if n == 0:
        raise ValueError("cannot scatter an empty dataset")
    if shuffle:
        order = np.random.RandomState(seed).permutation(n)
    else:
        order = np.arange(n)
    order = np.asarray(comm.bcast_obj(order, root=root))

    size = comm.size
    # Reference split: first (n % size) ranks get one extra element.
    base, extra = divmod(n, size)
    maxlen = base + (1 if extra else 0)
    shards, start, wrap = [], 0, 0
    for r in range(size):
        ln = base + (1 if r < extra else 0)
        shard = order[start:start + ln]
        if force_equal_length and ln < maxlen:
            # Pad short/empty shards by round-robining the permutation circle
            # (reference: SubDataset wrap-padding so every rank runs the same
            # number of iterations).  The rotating cursor keeps pad elements
            # DISTINCT across ranks — padding every short shard from the same
            # position would oversample one element.
            pad = order[[(wrap + k) % n for k in range(maxlen - ln)]]
            wrap += maxlen - ln
            shard = np.concatenate([shard, pad]) if ln else pad
        shards.append(shard)
        start += ln
    return ScatteredDataset(dataset, shards, force_equal_length,
                            local_rank=comm.rank)


def scatter_index(n_total: int, comm: CommunicatorBase, root: int = 0):
    """Scatter just an index range (reference: ``scatter_index`` [uv])."""
    base, extra = divmod(n_total, comm.size)
    out = []
    start = 0
    for r in range(comm.size):
        ln = base + (1 if r < extra else 0)
        out.append((start, start + ln))
        start += ln
    return out


class _Empty:
    def __init__(self, length: int):
        self._length = length

    def __len__(self):
        return self._length

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [()] * len(range(*i.indices(self._length)))
        if not -self._length <= i < self._length:
            raise IndexError(i)
        return ()


def create_empty_dataset(dataset) -> _Empty:
    """Length-preserving, payload-free dataset (reference:
    ``create_empty_dataset`` [uv]) — feeds non-input ranks in model-parallel
    graphs so every rank's iterator agrees on epoch boundaries."""
    return _Empty(len(dataset))
