"""Slot-managed KV-cache pool for continuous-batching decode.

Counterpart of ``chainermn_tpu/serving/cache_pool.py``: ONE set of
per-layer flat K/V buffers ``(n_slots, max_total, H_kv·head_dim)`` on the
device, allocated once, plus a host-side per-slot write position.  A
prefill writes its slab into a free slot's rows ``[0, s_p)`` and sets
``pos[slot] = s_p``; every tick appends one row per slot at its own
``pos`` and advances it; eviction returns the slot to the free list.

Under tensor parallelism every model rank holds its own pool of its
``H_kv/P`` heads: ``kv_dim`` is this rank's ``H_kv/P · head_dim``
(``ServingEngine`` sizes it from the rank's shard of the params), which
is what JAX's pool holds on each device through its cache sharding.

Recycling without zeroing is safe: a slot's rows ``> pos`` may hold a
previous occupant's K/V, but attention reads only ``[0, pos]``, and the
occupant writes row ``p`` before its ``pos`` reaches ``p``.

This slice carries the free/busy states only; the JAX allocator's journal
hooks, transfer reservations and prefix-cache states come with their
slices.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch


class SlotAllocator:
    """Free/busy slot bookkeeping, lowest index first; double or foreign
    release raises (a slot leak is silent capacity loss)."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self._free: List[int] = list(range(self.n_slots))
        self._busy: set = set()
        self._lock = threading.Lock()

    def acquire(self) -> Optional[int]:
        """Lowest free slot index, or None when the pool is saturated."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._busy.add(slot)
        return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot not in self._busy:
                raise ValueError(
                    f"slot {slot} is not busy (double release or "
                    f"foreign slot); busy={sorted(self._busy)}")
            self._busy.remove(slot)
            self._free.append(slot)
            self._free.sort()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def busy_count(self) -> int:
        return len(self._busy)

    def check_invariants(self) -> None:
        """free ∪ busy is exactly {0..n_slots-1}, disjoint."""
        free, busy = set(self._free), set(self._busy)
        if free & busy or free | busy != set(range(self.n_slots)):
            raise AssertionError(f"slot leak or alias: free={sorted(free)} "
                                 f"busy={sorted(busy)}")


class CachePool:
    """Device buffers + per-slot positions.  ``caches`` is a list of
    ``(k, v)`` per layer, each ``(n_slots, max_total, kv_dim)`` on
    ``device``; the decode engine updates them in place.  ``pos`` is host
    numpy: a free slot's position keeps advancing with every tick until the
    next prefill resets it, and its garbage writes land (clamped) inside its
    own row."""

    def __init__(self, n_slots: int, max_total: int, n_layers: int,
                 kv_dim: int, dtype, device):
        if max_total < 2:
            raise ValueError(f"max_total must be >= 2, got {max_total}")
        self.allocator = SlotAllocator(n_slots)
        self.n_slots = int(n_slots)
        self.max_total = int(max_total)
        self.n_layers = int(n_layers)
        self.kv_dim = int(kv_dim)
        self.device = torch.device(device)
        shape = (self.n_slots, self.max_total, self.kv_dim)
        self.caches = [
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(self.n_layers)]
        self.pos = np.zeros(self.n_slots, np.int32)

    def acquire(self) -> Optional[int]:
        return self.allocator.acquire()

    def release(self, slot: int) -> None:
        self.pos[slot] = 0
        self.allocator.release(slot)

    @property
    def free_count(self) -> int:
        return self.allocator.free_count

    @property
    def busy_count(self) -> int:
        return self.allocator.busy_count
