"""Radix-trie prefix cache: shared prompt prefixes reuse KV slots.

A copy of ``chainermn_tpu/serving/prefix_cache.py`` (pure host Python).

Production prompt traffic is prefix-heavy — the same system prompt (or
the same conversation history) fronts thousands of requests — and the
engine's prefill recomputes it every time.  This module is the
SGLang-RadixAttention idea adapted to the repo's slot-granular pool
(``cache_pool.py``): finished requests DONATE their slot to the cache
instead of freeing it, a compressed radix trie indexes the token
sequences those slots hold, and a new request's prompt is matched
against the trie for its longest cached prefix.  On a hit the engine
copies the cached slot's K/V rows into the request's own slot (ONE
compiled slab-copy program, ``DecodeEngine.copy_prefix``) and only the
un-cached suffix is computed — the shared prefix is never re-prefilled.

Why one slot can serve EVERY prefix of its sequence: causal attention
makes row ``i`` of a slot's K/V depend only on tokens ``[0, i]``, so a
slot holding the K/V of sequence ``S`` holds, in rows ``[0, k)``, the
exact K/V of any prefix ``S[:k]``.  The trie therefore needs no
per-token granularity bookkeeping — matching walks edges and any entry
below the deepest matched point supplies the slot.

Matches are capped at ``len(prompt) - 1``: the FIRST GENERATED token
comes from the last prompt position's hidden state, which is not
cached — at least one prompt token always runs through the engine, and
its tick output IS the first token (token-exactness needs no replay).

Lifecycle and refcounts (the ``cache_pool.SlotAllocator`` extension):

* **donate** — a finishing request's slot moves busy → cached (rc=0)
  keyed by ``prompt + generated[:-1]`` (every K/V row actually written:
  each decode tick writes the CONSUMED token's row, and the final
  emitted token was never consumed).  Sequences already covered by an
  existing entry are dropped (dedup); entries subsumed by a longer
  donation are evicted when unpinned.
* **retain/release** — a request admitted on a hit pins its source
  entry for its whole lifetime; all refcounts return to zero at drain
  (the fuzz invariant) and a pinned entry can never be evicted under it.
* **evict** — admission pressure reclaims cached slots LRU-first among
  rc==0 entries; the cache is scavengeable capacity, never a reserve
  that could starve decoding.

Pure host Python (fuzzable without a device); the device copy lives in
``engine.py`` and the policy wiring in ``frontend.py``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple


class PrefixEntry:
    """One cached sequence: ``seq[:length]``'s K/V lives in ``slot``."""

    _ids = itertools.count()

    def __init__(self, seq: Tuple[int, ...], slot: int, length: int):
        self.id = next(PrefixEntry._ids)
        self.seq = tuple(int(t) for t in seq)
        self.slot = int(slot)
        self.length = int(length)      # valid K/V rows: [0, length)
        self.node: Optional["_Node"] = None   # terminal trie node
        self.last_used = 0             # logical LRU clock

    def __repr__(self):
        return (f"PrefixEntry(id={self.id}, slot={self.slot}, "
                f"len={self.length})")


class _Node:
    """Compressed-trie node: ``edges`` maps first token → (label,
    child); at most one entry terminates at a node."""

    __slots__ = ("edges", "entry", "parent")

    def __init__(self, parent: Optional["_Node"] = None):
        self.edges: Dict[int, Tuple[Tuple[int, ...], "_Node"]] = {}
        self.entry: Optional[PrefixEntry] = None
        self.parent = parent


def _locked(fn):
    """Hold the cache's reentrant lock across a public method (trie
    reads race donations/evictions from other threads otherwise)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._lock:
            return fn(self, *a, **k)
    return wrapper


def _common_len(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """Radix-trie index over donated read-only prefix slots.

    The cache OWNS no device memory: slots belong to the pool's
    allocator and move busy → cached → free through the
    ``SlotAllocator.cache/retain/unretain/uncache`` faces the frontend
    wires in via ``retain_slot``/``release_slot``/``evict_slot``
    callbacks.  Keeping it callback-based leaves the trie and refcount
    policy standalone-fuzzable.

    ``min_prefix_len``: hits shorter than this are treated as misses —
    copying a 1-token prefix saves one embedding lookup and costs a
    slab copy; the knob keeps the trade explicit.
    """

    def __init__(self, retain_slot=None, release_slot=None,
                 evict_slot=None, min_prefix_len: int = 2,
                 on_insert=None, on_evict=None):
        # one reentrant lock around every trie/entry mutation AND read:
        # with Replica.start() the engine's driver thread donates and
        # evicts while the router's caller thread peeks for affinity —
        # an unlocked dict iteration mid-edge-split would raise (or
        # match an entry being evicted).  Host-side microseconds; the
        # device path never holds it.  RLock because insert() evicts
        # subsumed entries through the same public face.
        self._lock = threading.RLock()
        self._root = _Node()
        self._entries: Dict[int, PrefixEntry] = {}      # id -> entry
        self._by_slot: Dict[int, PrefixEntry] = {}      # slot -> entry
        self._pins: Dict[int, int] = {}                 # entry id -> rc
        self._clock = 0
        self.min_prefix_len = max(int(min_prefix_len), 1)
        self._retain_slot = retain_slot or (lambda slot: None)
        self._release_slot = release_slot or (lambda slot: None)
        self._evict_slot = evict_slot or (lambda slot: None)
        # lifecycle hooks: ``on_insert(entry)`` after a
        # donation lands, ``on_evict(entry)`` BEFORE the slot is handed
        # back (the spill tier must pack the rows while they still
        # exist; the fleet worker announces both over the mailbox wire
        # so the router's global index tracks this cache).  Hooks run
        # UNDER the cache lock by design — the pre-evict spill has to
        # read the slab before the slot frees, and that ordering only
        # exists inside the eviction.  The cost is bounded (one slab's
        # device→host copy + small lane writes) but it does extend the
        # lock hold on the eviction path; hooks must never take a lock
        # that can be held while calling INTO this cache (deadlock).
        self.on_insert = on_insert
        self.on_evict = on_evict
        # counters (the frontend's metrics() / introspect surface)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.insertions = 0
        self.rejected_insertions = 0
        self.evictions = 0

    # ---- matching ----
    def _walk(self, seq) -> Tuple["_Node", int, Optional["_Node"]]:
        """Deepest match of ``seq`` along the trie: returns ``(node,
        matched_len, partial_child)`` where ``partial_child`` is the
        edge child when the walk died MID-edge (its subtree still
        shares the matched prefix)."""
        node, depth = self._root, 0
        while depth < len(seq):
            edge = node.edges.get(seq[depth])
            if edge is None:
                return node, depth, None
            label, child = edge
            k = _common_len(label, seq[depth:])
            depth += k
            if k < len(label):
                return node, depth, child
            node = child
        return node, depth, None

    def _subtree_entry(self, node: "_Node") -> Optional[PrefixEntry]:
        """Most-recently-used entry in ``node``'s subtree (entry count
        is bounded by n_slots, so the DFS is trivially cheap)."""
        best: Optional[PrefixEntry] = None
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None and (best is None
                                        or n.entry.last_used
                                        > best.last_used):
                best = n.entry
            stack.extend(child for _, child in n.edges.values())
        return best

    @_locked
    def match(self, prompt) -> Tuple[Optional[PrefixEntry], int]:
        """Longest cached prefix of ``prompt``: ``(entry, match_len)``
        with ``entry.seq[:match_len] == prompt[:match_len]`` and K/V
        rows ``[0, match_len)`` valid in ``entry.slot`` — or
        ``(None, 0)``.  Capped at ``len(prompt) - 1`` (the last prompt
        token must run live to produce the first generated token) and
        at the entry's own valid length."""
        prompt = tuple(int(t) for t in prompt)
        if len(prompt) < 2:
            self.misses += 1
            return None, 0
        node, depth, partial = self._walk(prompt[:len(prompt) - 1])
        entry = self._subtree_entry(partial if partial is not None
                                    else node)
        if entry is None or depth < self.min_prefix_len:
            self.misses += 1
            return None, 0
        match_len = min(depth, entry.length, len(prompt) - 1)
        if match_len < self.min_prefix_len:
            self.misses += 1
            return None, 0
        self.hits += 1
        self.tokens_reused += match_len
        self._clock += 1
        entry.last_used = self._clock
        return entry, match_len

    @_locked
    def peek_len(self, prompt) -> int:
        """Length the next :meth:`match` of ``prompt`` would return,
        WITHOUT touching hit/miss counters or the LRU clock — the
        router's affinity scorer probes every replica and must not
        distort the stats or eviction order of the ones it rejects."""
        prompt = tuple(int(t) for t in prompt)
        if len(prompt) < 2:
            return 0
        node, depth, partial = self._walk(prompt[:len(prompt) - 1])
        entry = self._subtree_entry(partial if partial is not None
                                    else node)
        if entry is None or depth < self.min_prefix_len:
            return 0
        match_len = min(depth, entry.length, len(prompt) - 1)
        return match_len if match_len >= self.min_prefix_len else 0

    @_locked
    def pin_covering(self, seq) -> Optional[PrefixEntry]:
        """Entry whose K/V rows COVER ``seq`` exactly (``entry.seq[:
        len(seq)] == seq`` and ``entry.length >= len(seq)``), RETAINED
        atomically — the remote-pull serving face: the owner
        must pin the entry across the pack so a concurrent eviction
        cannot free the slot mid-read.  Returns None (no pin taken)
        when nothing covers the sequence anymore — the announced claim
        went stale and the pull degrades to re-prefill."""
        seq = tuple(int(t) for t in seq)
        if not seq:
            return None
        node, depth, partial = self._walk(seq)
        if depth < len(seq):
            return None
        entry = self._subtree_entry(partial if partial is not None
                                    else node)
        if entry is None or entry.length < len(seq) \
                or entry.seq[: len(seq)] != seq:
            return None
        self.retain(entry)
        return entry

    # ---- pinning (request lifetime) ----
    @_locked
    def retain(self, entry: PrefixEntry) -> None:
        if entry.id not in self._entries:
            raise ValueError(f"unknown entry {entry!r}")
        self._pins[entry.id] = self._pins.get(entry.id, 0) + 1
        self._retain_slot(entry.slot)

    @_locked
    def release(self, entry: PrefixEntry) -> None:
        rc = self._pins.get(entry.id, 0)
        if rc <= 0:
            raise ValueError(f"refcount underflow on {entry!r}")
        if rc == 1:
            self._pins.pop(entry.id)
        else:
            self._pins[entry.id] = rc - 1
        self._release_slot(entry.slot)

    @_locked
    def refcount(self, entry: PrefixEntry) -> int:
        return self._pins.get(entry.id, 0)

    # ---- insertion (donation) ----
    @_locked
    def insert(self, seq, slot: int, length: int
               ) -> Optional[PrefixEntry]:
        """Index ``seq[:length]``'s K/V (already in ``slot``) — or
        return None when the donation adds nothing: an existing entry
        already covers the sequence (dedup), or it is too short to ever
        produce a usable hit.  The CALLER keeps slot ownership on
        rejection (and releases it to the free list)."""
        seq = tuple(int(t) for t in seq)[: int(length)]
        if len(seq) < self.min_prefix_len:
            self.rejected_insertions += 1
            return None
        node, depth, partial = self._walk(seq)
        if depth == len(seq):
            # every entry in the subtree below the matched point passes
            # through all of seq — rows [0, len(seq)) of its slot
            # already hold this exact K/V, so the donation adds nothing
            covering = self._subtree_entry(
                partial if partial is not None else node)
            if covering is not None:
                self.rejected_insertions += 1
                return None
        entry = PrefixEntry(seq, slot, len(seq))
        self._clock += 1
        entry.last_used = self._clock
        self._insert_node(entry)
        self._entries[entry.id] = entry
        self._by_slot[slot] = entry
        self.insertions += 1
        if self.on_insert is not None:
            self.on_insert(entry)   # holds-lock: _lock
        # a strictly-shorter entry whose seq prefixes the new one is
        # subsumed: every hit it could serve, the new entry serves
        # better.  Evict the unpinned ones now (their slot frees up).
        for other in list(self._entries.values()):
            if other.id != entry.id and other.length < entry.length \
                    and entry.seq[: other.length] == other.seq \
                    and self._pins.get(other.id, 0) == 0:
                self.evict_entry(other)
        return entry

    def _insert_node(self, entry: PrefixEntry) -> None:
        seq = entry.seq
        node, depth = self._root, 0
        while True:
            if depth == len(seq):
                entry.node = node
                if node.entry is None:
                    node.entry = entry
                # else: duplicate terminal (same seq twice) — keep the
                # older one as terminal; both remain in _entries
                return
            edge = node.edges.get(seq[depth])
            if edge is None:
                child = _Node(parent=node)
                node.edges[seq[depth]] = (seq[depth:], child)
                child.entry = entry
                entry.node = child
                return
            label, child = edge
            k = _common_len(label, seq[depth:])
            if k == len(label):
                node, depth = child, depth + k
                continue
            # split the edge at k: node -[label[:k]]-> mid -[label[k:]]->
            mid = _Node(parent=node)
            node.edges[seq[depth]] = (label[:k], mid)
            mid.edges[label[k]] = (label[k:], child)
            child.parent = mid
            node, depth = mid, depth + k

    # ---- eviction ----
    @_locked
    def evictable_count(self) -> int:
        return sum(1 for e in self._entries.values()
                   if self._pins.get(e.id, 0) == 0)

    @_locked
    def evict_entry(self, entry: PrefixEntry) -> int:
        """Remove one entry and hand its slot back via ``evict_slot``;
        returns the freed slot.  Pinned entries are a hard error (the
        allocator would refuse the uncache anyway)."""
        if self._pins.get(entry.id, 0) > 0:
            raise ValueError(f"{entry!r} is pinned; refusing eviction")
        if self.on_evict is not None:
            # BEFORE the slot goes back: the spill tier packs the rows
            # while the slot still holds them (evict_slot resets pos)
            self.on_evict(entry)   # holds-lock: _lock
        del self._entries[entry.id]
        self._by_slot.pop(entry.slot, None)
        node = entry.node
        if node is not None and node.entry is entry:
            node.entry = None
            self._prune(node)
        entry.node = None
        self.evictions += 1
        self._evict_slot(entry.slot)
        return entry.slot

    @_locked
    def evict_lru(self) -> Optional[int]:
        """Evict the least-recently-used rc==0 entry; returns its slot
        (for the admission path to acquire) or None when everything is
        pinned or the cache is empty."""
        victims = [e for e in self._entries.values()
                   if self._pins.get(e.id, 0) == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda e: (e.last_used, e.id))
        return self.evict_entry(victim)

    def _prune(self, node: "_Node") -> None:
        """Drop entry-less leaf chains so the trie stays proportional
        to what it indexes."""
        while node is not None and node is not self._root \
                and node.entry is None and not node.edges:
            parent = node.parent
            for tok, (label, child) in list(parent.edges.items()):
                if child is node:
                    del parent.edges[tok]
                    break
            node = parent

    # ---- introspection ----
    @property
    @_locked
    def n_entries(self) -> int:
        return len(self._entries)

    @_locked
    def entries(self) -> List[PrefixEntry]:
        return list(self._entries.values())

    @_locked
    def total_refcount(self) -> int:
        return sum(self._pins.values())

    @_locked
    def stats(self) -> Dict[str, float]:
        return {
            "entries": float(len(self._entries)),
            "pinned": float(len(self._pins)),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "tokens_reused": float(self.tokens_reused),
            "insertions": float(self.insertions),
            "evictions": float(self.evictions),
        }

    @_locked
    def check_invariants(self) -> None:
        """Entry/trie/slot agreement: every entry reachable, one slot
        per entry, pins only on live entries, trie terminals match."""
        slots = [e.slot for e in self._entries.values()]
        assert len(set(slots)) == len(slots), f"slot aliasing: {slots}"
        assert set(self._by_slot) == set(slots)
        for eid in self._pins:
            assert eid in self._entries, (eid, self._entries)
            assert self._pins[eid] > 0
        for e in self._entries.values():
            node, depth, partial = self._walk(e.seq)
            assert depth == len(e.seq) and partial is None, e
            sub = self._subtree_entry(node)
            assert sub is not None, e
