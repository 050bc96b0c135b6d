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

A slot is ``free``, ``busy`` (a live request's K/V), ``reserved`` (held
for an in-flight transfer) or ``cached`` (a finished request's K/V donated
to the prefix cache as a read-only shared prefix, refcounted by the
requests built on it), as in JAX's allocator.  A cached slot keeps
ticking: its ``pos`` drifts upward above the donated prefix (the tick
advances every slot), and its garbage writes land there, clamped to
``max_total - 1`` by the append, inside its own row; the rows below the
prefix length stay intact.  ``cache`` leaves ``pos`` alone and
``uncache`` resets it.  The allocator's journal emits come with
``health.py``'s (ROADMAP.md's A12).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch


class SlotAllocator:
    """Free/busy/cached slot bookkeeping: acquire → busy, release →
    recycled, cache → read-only prefix slot (refcounted) until evicted.

    Slots are handed out lowest-index-first (deterministic for tests);
    double-release, foreign releases, and refcount underflow raise — a
    slot leak in a serving loop is silent capacity loss, so the
    invariants are hard errors.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self._free: List[int] = list(range(self.n_slots))
        self._busy: set = set()
        self._cached: Dict[int, int] = {}   # slot -> refcount
        self._reserved: set = set()         # in-flight transfer dests
        # every state transition is a compound read-then-write, and
        # admission races donation across the driver and caller threads
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
            # keep the free list sorted so acquisition order is
            # deterministic
            self._free.append(slot)
            self._free.sort()

    # ---- transfer-destination reservations: free -> reserved -> busy ----
    def reserve(self) -> Optional[int]:
        """Hold the lowest free slot for an in-flight KV transfer, or
        None when the pool is saturated.  A reserved slot is invisible
        to ``acquire``/``free_count`` — admission can never race the
        arriving slab for it."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._reserved.add(slot)
        return slot

    def commit_reservation(self, slot: int) -> None:
        """The slab landed: promote the reservation to a busy slot."""
        with self._lock:
            if slot not in self._reserved:
                raise ValueError(
                    f"slot {slot} is not reserved (commit "
                    f"without reserve, or double commit); "
                    f"reserved={sorted(self._reserved)}")
            self._reserved.remove(slot)
            self._busy.add(slot)

    def cancel_reservation(self, slot: int) -> None:
        """The transfer failed: return the held slot to the free list."""
        with self._lock:
            if slot not in self._reserved:
                raise ValueError(
                    f"slot {slot} is not reserved (cancel "
                    f"without reserve, or double cancel); "
                    f"reserved={sorted(self._reserved)}")
            self._reserved.remove(slot)
            self._free.append(slot)
            self._free.sort()

    # ---- prefix-cache faces: busy -> cached(rc) -> free ----
    def cache(self, slot: int) -> None:
        """Donate a busy slot to the prefix cache (read-only, rc=0)."""
        with self._lock:
            if slot not in self._busy:
                raise ValueError(f"slot {slot} is not busy (only a live "
                                 f"request's slot can be donated); "
                                 f"busy={sorted(self._busy)}")
            self._busy.remove(slot)
            self._cached[slot] = 0

    def retain(self, slot: int) -> int:
        """Pin a cached slot for one more in-flight reader."""
        with self._lock:
            if slot not in self._cached:
                raise ValueError(f"slot {slot} is not cached; "
                                 f"cached={sorted(self._cached)}")
            self._cached[slot] += 1
            rc = self._cached[slot]
        return rc

    def unretain(self, slot: int) -> int:
        with self._lock:
            if slot not in self._cached:
                raise ValueError(f"slot {slot} is not cached; "
                                 f"cached={sorted(self._cached)}")
            if self._cached[slot] <= 0:
                raise ValueError(f"slot {slot} refcount underflow "
                                 f"(double unretain)")
            self._cached[slot] -= 1
            rc = self._cached[slot]
        return rc

    def uncache(self, slot: int) -> None:
        """Evict a cached slot back to the free list (rc must be 0: an
        entry someone is still built on must never be recycled)."""
        with self._lock:
            rc = self._cached.get(slot)
            if rc is None:
                raise ValueError(f"slot {slot} is not cached; "
                                 f"cached={sorted(self._cached)}")
            if rc != 0:
                raise ValueError(f"slot {slot} still has {rc} reader(s); "
                                 f"refusing to evict a pinned prefix")
            del self._cached[slot]
            self._free.append(slot)
            self._free.sort()

    def refcount(self, slot: int) -> Optional[int]:
        return self._cached.get(slot)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def busy_count(self) -> int:
        return len(self._busy)

    @property
    def cached_count(self) -> int:
        return len(self._cached)

    @property
    def reserved_count(self) -> int:
        return len(self._reserved)

    def check_invariants(self) -> None:
        """No leak, no alias: free ∪ busy ∪ cached ∪ reserved is exactly
        {0..n_slots-1}, pairwise disjoint, and every refcount >= 0."""
        free, busy = set(self._free), set(self._busy)
        cached, reserved = set(self._cached), set(self._reserved)
        assert not (free & busy), (free, busy)
        assert not (free & cached), (free, cached)
        assert not (busy & cached), (busy, cached)
        assert not (reserved & (free | busy | cached)), \
            (reserved, free, busy, cached)
        assert free | busy | cached | reserved \
            == set(range(self.n_slots)), (free, busy, cached, reserved)
        assert all(rc >= 0 for rc in self._cached.values()), self._cached


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

    # thin faces over the allocator (the frontend talks to the pool)
    def acquire(self) -> Optional[int]:
        return self.allocator.acquire()

    def release(self, slot: int) -> None:
        self.pos[slot] = 0
        self.allocator.release(slot)

    # transfer-destination reservations: the committing caller sets
    # ``pos[slot]`` itself (the landed slab's length is its metadata)
    def reserve(self) -> Optional[int]:
        return self.allocator.reserve()

    def commit_reservation(self, slot: int) -> None:
        self.allocator.commit_reservation(slot)

    def cancel_reservation(self, slot: int) -> None:
        self.pos[slot] = 0
        self.allocator.cancel_reservation(slot)

    # prefix-cache faces: ``cache`` keeps ``pos`` (the cached slot's
    # garbage writes land above the donated prefix), ``uncache`` resets it
    def cache(self, slot: int) -> None:
        self.allocator.cache(slot)

    def uncache(self, slot: int) -> None:
        self.pos[slot] = 0
        self.allocator.uncache(slot)

    def retain(self, slot: int) -> int:
        return self.allocator.retain(slot)

    def unretain(self, slot: int) -> int:
        return self.allocator.unretain(slot)

    @property
    def free_count(self) -> int:
        return self.allocator.free_count

    @property
    def busy_count(self) -> int:
        return self.allocator.busy_count

    @property
    def cached_count(self) -> int:
        return self.allocator.cached_count

    @property
    def reserved_count(self) -> int:
        return self.allocator.reserved_count
