"""Host-RAM spill tier for evicted prefix-cache slabs.

A copy of ``chainermn_tpu/serving/spill.py`` (pure host Python).

The radix-trie prefix cache (``prefix_cache.py``) borrows DEVICE slots;
under admission pressure the LRU rc==0 entry is scavenged and its K/V —
often a hot shared system prompt that will be asked for again within
seconds — was simply freed.  This module is the middle rung of the KV
economy: on eviction the slab is packed (``transfer.py::pack``, the
same CRC-stamped ``chainermn_tpu.kv_transfer.v1`` payload the
cross-process transfer plane ships) into a BOUNDED host-RAM LRU store,
and a later prompt that prefixes a spilled sequence re-lands it through
the pool-lifetime compiled inject program
(``KvTransferPlane.unpack_into``) instead of re-prefilling.

Failure-domain discipline (the robustness contract):

* the store is **bounded** (``capacity_bytes``): inserting past the
  budget evicts LRU-first, and a payload larger than the whole budget
  is refused — the spill tier degrades, it never OOMs the host;
* every payload carries the pack-time **CRC32**; verification happens
  at restore (inside ``unpack_into``), and a corrupt slab is refused,
  counted, and the request falls back to a normal prefill — wrong KV
  is never served;
* the store holds opaque BYTES keyed by token sequences — host-only,
  fuzzable standalone, and a lost/cleared store is always safe (the
  engine just re-prefills).

``match`` follows the trie's semantics: longest spilled sequence that
prefixes the prompt, capped at ``len(prompt) - 1`` (the last prompt
token must run live to produce the first generated token) and at the
spilled slab's own length.  Entry count is bounded by
``capacity_bytes / slab size``, so the linear scan is cheap (tens of
entries, host microseconds) — a trie would only complicate eviction.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


class SpillEntry:
    """One spilled slab: ``seq[:length]``'s packed K/V payload."""

    __slots__ = ("seq", "length", "payload", "nbytes")

    def __init__(self, seq: Tuple[int, ...], length: int,
                 payload: bytes):
        self.seq = tuple(int(t) for t in seq)[: int(length)]
        self.length = int(length)
        self.payload = bytes(payload)
        self.nbytes = len(self.payload)


class HostSpillStore:
    """Bounded LRU host-RAM store of packed prefix slabs.

    ``on_evict(seq, length)`` fires when a spilled entry falls out of
    the budget (capacity pressure or explicit :meth:`drop`) — the fleet
    worker uses it to announce the FINAL eviction so the router's
    global index stops advertising a prefix nobody holds anymore.
    """

    def __init__(self, capacity_bytes: int = 64 << 20,
                 on_evict: Optional[Callable[[Tuple[int, ...], int],
                                             None]] = None):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be positive, got {capacity_bytes} "
                f"(pass spill_bytes=0 at the ENGINE to disable the tier)")
        self.capacity_bytes = int(capacity_bytes)
        self.on_evict = on_evict
        self._lock = threading.Lock()
        # seq tuple -> entry, LRU order (oldest first)
        self._entries: "OrderedDict[Tuple[int, ...], SpillEntry]" = \
            OrderedDict()
        self._bytes = 0
        # counters (the lease/metrics/introspect surface)
        self.spills = 0
        self.restores = 0
        self.hits = 0
        self.misses = 0
        self.crc_refusals = 0
        self.evictions = 0
        self.rejected_oversize = 0

    # ---- insertion (the eviction path's spill) ----
    def put(self, seq, length: int, payload: bytes) -> bool:
        """Spill one packed slab; returns False when the payload alone
        exceeds the whole budget (refused, counted) — the caller frees
        the slot either way."""
        entry = SpillEntry(tuple(seq), length, payload)
        if entry.nbytes > self.capacity_bytes:
            with self._lock:
                self.rejected_oversize += 1
            return False
        evicted: List[SpillEntry] = []
        with self._lock:
            old = self._entries.pop(entry.seq, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.seq] = entry
            self._bytes += entry.nbytes
            self.spills += 1
            while self._bytes > self.capacity_bytes:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1
                evicted.append(victim)
        if self.on_evict is not None:
            for victim in evicted:
                self.on_evict(victim.seq, victim.length)
        return True

    # ---- lookup ----
    @staticmethod
    def _common_len(a, b) -> int:
        n = min(len(a), len(b))
        for i in range(n):
            if a[i] != b[i]:
                return i
        return n

    def match(self, prompt, min_len: int = 2
              ) -> Optional[Tuple[Tuple[int, ...], int]]:
        """Longest spilled prefix of ``prompt``: ``(seq, match_len)``
        with ``seq[:match_len] == prompt[:match_len]``, capped at
        ``len(prompt) - 1`` and the entry's own length — or None.
        Counts hit/miss and refreshes the winner's LRU position."""
        prompt = tuple(int(t) for t in prompt)
        cap = len(prompt) - 1
        best: Optional[SpillEntry] = None
        best_len = 0
        with self._lock:
            for entry in self._entries.values():
                m = min(self._common_len(entry.seq, prompt), cap,
                        entry.length)
                if m > best_len:
                    best, best_len = entry, m
            if best is None or best_len < max(int(min_len), 1):
                self.misses += 1
                return None
            self.hits += 1
            self._entries.move_to_end(best.seq)
            return best.seq, best_len

    def covering(self, seq) -> Optional[bytes]:
        """Payload of a spilled entry whose sequence COVERS ``seq``
        (``entry.seq[:len(seq)] == seq``) — the remote-pull serving
        face: an owner whose device cache scavenged an announced prefix
        can still serve the pull from the spill tier."""
        seq = tuple(int(t) for t in seq)
        with self._lock:
            for entry in self._entries.values():
                if entry.length >= len(seq) \
                        and entry.seq[: len(seq)] == seq:
                    self._entries.move_to_end(entry.seq)
                    return entry.payload
        return None

    def get(self, seq) -> Optional[bytes]:
        """Exact-sequence payload lookup (the restore path re-reads the
        winner :meth:`match` named)."""
        seq = tuple(int(t) for t in seq)
        with self._lock:
            entry = self._entries.get(seq)
            if entry is None:
                return None
            self._entries.move_to_end(seq)
            return entry.payload

    def drop(self, seq) -> None:
        """Remove one entry (a restore that failed CRC must never be
        retried from the same corrupt bytes)."""
        seq = tuple(int(t) for t in seq)
        with self._lock:
            entry = self._entries.pop(seq, None)
            if entry is not None:
                self._bytes -= entry.nbytes
        if entry is not None and self.on_evict is not None:
            self.on_evict(entry.seq, entry.length)

    # ---- introspection ----
    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_held(self) -> int:
        with self._lock:
            return self._bytes

    def entries(self) -> List[Tuple[Tuple[int, ...], int]]:
        with self._lock:
            return [(e.seq, e.length) for e in self._entries.values()]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": float(len(self._entries)),
                "bytes": float(self._bytes),
                "capacity_bytes": float(self.capacity_bytes),
                "spills": float(self.spills),
                "restores": float(self.restores),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "crc_refusals": float(self.crc_refusals),
                "evictions": float(self.evictions),
                "rejected_oversize": float(self.rejected_oversize),
            }

    def state(self) -> Dict[str, Any]:
        out = self.stats()
        out["lru"] = [list(seq[:8]) for seq, _ in self.entries()]
        return out
