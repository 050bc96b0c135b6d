"""Dataset iterators (multi-node aware).

A copy of ``chainermn_tpu/iterators/__init__.py`` (reference:
``chainermn/iterators/``): :class:`SerialIterator` (Chainer's, with the
same ``RandomState`` permutations, the ragged tail padded from the next
epoch and the ``state_dict`` resume contract),
``create_multi_node_iterator`` (every rank sees the master rank's batch
stream: the master pulls and ``bcast_obj`` carries ``(stop, payload)``
to every process) and ``create_synchronized_iterator`` (the master's
iterator state installed into every rank's iterator).  Nothing here
touches a device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..communicators.base import CommunicatorBase


class SerialIterator:
    """Sequential/shuffled minibatch iterator with epoch accounting.

    Standalone analog of Chainer's ``SerialIterator``.  Supports
    ``state_dict``/``load_state_dict`` so a run can resume it mid-epoch.
    """

    def __init__(self, dataset, batch_size: int, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.repeat = repeat
        self.shuffle = shuffle
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.epoch = 0
        self.current_position = 0
        self.is_new_epoch = False
        self._order = self._new_order()

    def _new_order(self) -> np.ndarray:
        n = len(self.dataset)
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    @property
    def epoch_detail(self) -> float:
        return self.epoch + self.current_position / max(len(self.dataset), 1)

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.dataset)
        if not self.repeat and self.epoch > 0 and self.current_position == 0:
            raise StopIteration
        i, stop = self.current_position, min(self.current_position + self.batch_size, n)
        batch = [self.dataset[int(j)] for j in self._order[i:stop]]
        if stop >= n:
            self.epoch += 1
            self.is_new_epoch = True
            self.current_position = 0
            self._order = self._new_order()
            if self.repeat:
                # Pad from subsequent epoch(s) — looping so batch_size > n
                # still yields full, fixed-shape batches (no recompiles).
                while len(batch) < self.batch_size:
                    take = min(self.batch_size - len(batch), n)
                    batch.extend(self.dataset[int(j)] for j in self._order[:take])
                    self.current_position = take % n
                    if take == n:
                        self.epoch += 1
                        self._order = self._new_order()
        else:
            self.is_new_epoch = False
            self.current_position = stop
        return batch

    next = __next__

    def reset(self) -> None:
        self._rng = np.random.RandomState(self._seed)
        self.epoch = 0
        self.current_position = 0
        self.is_new_epoch = False
        self._order = self._new_order()

    # ---- resume contract (consumed by extensions/checkpoint.py) ----
    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "current_position": self.current_position,
            "is_new_epoch": self.is_new_epoch,
            "order": np.asarray(self._order),
            "rng_state": self._rng.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.current_position = int(state["current_position"])
        self.is_new_epoch = bool(state["is_new_epoch"])
        self._order = np.asarray(state["order"])
        self._rng.set_state(state["rng_state"])


class _MultiNodeIterator:
    """All ranks observe the master rank's batch stream (bcast per batch)."""

    def __init__(self, actual_iterator, communicator: CommunicatorBase,
                 rank_master: int):
        self.actual_iterator = actual_iterator
        self.communicator = communicator
        self.rank_master = rank_master
        self.epoch = 0
        self.is_new_epoch = False
        self._epoch_detail = 0.0

    @property
    def _is_master(self) -> bool:
        return self.communicator.owns_rank(self.rank_master)

    def __iter__(self):
        return self

    def __next__(self):
        # Only the process owning the master rank drives the underlying
        # iterator (the others skip their input pipeline); bcast_obj
        # carries (batch, epoch bookkeeping) to everyone (reference:
        # _MultiNodeIterator's master sends (batch, is_new_epoch) via MPI).
        stop = False
        payload = None
        if self._is_master:
            try:
                batch = self.actual_iterator.next()
                payload = (
                    batch,
                    getattr(self.actual_iterator, "epoch", 0),
                    getattr(self.actual_iterator, "is_new_epoch", False),
                    getattr(self.actual_iterator, "epoch_detail", 0.0),
                )
            except StopIteration:
                stop = True
        stop, payload = self.communicator.bcast_obj(
            (stop, payload), root=self.rank_master)
        if stop:
            raise StopIteration
        batch, self.epoch, self.is_new_epoch, self._epoch_detail = payload
        return batch

    next = __next__

    @property
    def epoch_detail(self) -> float:
        # Reflects the MASTER stream (synced each batch), so epoch triggers
        # fire identically on every process regardless of local shard sizes.
        return self._epoch_detail

    def reset(self) -> None:
        if self._is_master and hasattr(self.actual_iterator, "reset"):
            self.actual_iterator.reset()
        self.epoch = 0
        self.is_new_epoch = False
        self._epoch_detail = 0.0

    def state_dict(self) -> dict:
        # The master's state is authoritative; broadcast it so every process
        # checkpoints an identical, resumable copy.
        local = (self.actual_iterator.state_dict()
                 if self._is_master else None)
        return self.communicator.bcast_obj(local, root=self.rank_master)

    def load_state_dict(self, state: dict) -> None:
        if self._is_master:
            self.actual_iterator.load_state_dict(state)


def create_multi_node_iterator(actual_iterator, communicator: CommunicatorBase,
                               rank_master: int = 0):
    """Replicate one rank's batch stream to all ranks (reference:
    ``create_multi_node_iterator``: model-parallel input replication)."""
    return _MultiNodeIterator(actual_iterator, communicator, rank_master)


def create_synchronized_iterator(actual_iterator, communicator: CommunicatorBase):
    """Synchronize the iterator's RNG across ranks so every rank draws the
    same shuffle order (reference: ``create_synchronized_iterator``).

    The master rank's full iterator state (RNG, shuffle order, position) is
    broadcast and installed into every rank's iterator before use; thereafter
    all ranks step identical streams.  At one process this is an identity
    (the master's own stream is left untouched).
    """
    if not hasattr(actual_iterator, "state_dict"):
        raise ValueError(
            "synchronized iterator needs an iterator with state_dict/"
            "load_state_dict (e.g. chainermn_tpu_torch.iterators"
            ".SerialIterator)")
    state = communicator.bcast_obj(actual_iterator.state_dict(), root=0)
    actual_iterator.load_state_dict(state)
    return actual_iterator


__all__ = [
    "SerialIterator",
    "create_multi_node_iterator",
    "create_synchronized_iterator",
]
