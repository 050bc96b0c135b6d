"""Fleet-global prefix-cache index: the router's soft-state radix trie
over every worker's announced KV prefixes.

Counterpart of ``chainermn_tpu/serving/fleet_cache.py`` (a copy: the JAX
module is pure host Python).  Each engine worker's prefix cache is
private; workers announce every insert, eviction and spill over the
mailbox wire (``cache_announce`` messages, epoch-stamped), and the router
keeps one compressed radix trie mapping prefixes to (worker, epoch, slab
geometry, tier).  On a local miss with a remote hit the router can pull
the slab over the KV-transfer plane instead of re-prefilling, priced in
token units, the currency of its affinity score.

Soft-state discipline:

* the index is a hint, never ground truth: the owning worker holds the
  slab, and an entry that turns out stale at pull time degrades to a
  counted re-prefill (a wasted round trip, never a wrong token);
* every record carries the announcing worker's epoch; the router's death
  / fence path drops every record of a fenced worker in one call
  (:meth:`FleetCacheIndex.drop_worker`), and a fenced worker's buffered
  announces are refused upstream by the ``EpochFence``;
* a re-admitted worker's state is rebuilt, not patched: the ``hello``
  handshake triggers a full ``snapshot`` announce
  (:meth:`FleetCacheIndex.snapshot`);
* records have a ``tier``: ``"hot"`` (a device slot) or ``"spill"`` (the
  worker's host spill store).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

#: Record tiers, best first: a device-resident slab packs fresher than
#: a spilled payload (tie-broken by recency within a tier).
TIERS = ("hot", "spill")


class IndexRecord:
    """One worker's claim: ``seq[:length]``'s K/V is pullable from
    ``worker`` (announced under ``epoch``, with the slab ``geom`` the
    router needs to price the transfer).  ``model_id`` rides the geom
   : in a heterogeneous fleet a claim is only pullable into
    a worker serving the SAME variant — K/V from a different model is
    geometry-compatible garbage at best."""

    __slots__ = ("worker", "seq", "length", "epoch", "geom", "tier",
                 "model_id", "last_used")

    def __init__(self, worker: str, seq: Tuple[int, ...], length: int,
                 epoch: int, geom: Optional[Dict[str, Any]],
                 tier: str = "hot"):
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
        self.worker = str(worker)
        self.seq = tuple(int(t) for t in seq)[: int(length)]
        self.length = int(length)
        self.epoch = int(epoch)
        self.geom = dict(geom) if geom else None
        self.tier = tier
        self.model_id = (self.geom or {}).get("model_id")
        self.last_used = 0

    def __repr__(self):
        return (f"IndexRecord({self.worker!r}, len={self.length}, "
                f"epoch={self.epoch}, tier={self.tier}, "
                f"model={self.model_id})")


class _Node:
    """Compressed-trie node; a terminal node can host ONE record per
    worker (several workers may hold the same prefix)."""

    __slots__ = ("edges", "recs", "parent")

    def __init__(self, parent: Optional["_Node"] = None):
        self.edges: Dict[int, Tuple[Tuple[int, ...], "_Node"]] = {}
        self.recs: Dict[str, IndexRecord] = {}
        self.parent = parent


def _common_len(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class FleetCacheIndex:
    """The router-side half of the fleet KV economy: announce-driven
    radix trie + per-worker reverse map, one lock (host microseconds;
    announces and lookups come from the router thread and submit
    threads)."""

    def __init__(self, min_prefix_len: int = 2):
        self._lock = threading.Lock()
        self._root = _Node()
        # worker -> {seq tuple -> record} (the drop/snapshot face)
        self._by_worker: Dict[str, Dict[Tuple[int, ...], IndexRecord]] = {}
        self._clock = 0
        self.min_prefix_len = max(int(min_prefix_len), 1)
        # counters (the fleet_health provider block + /metricsz)
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evicts = 0
        self.demotions = 0
        self.snapshots = 0
        self.dropped_workers = 0
        self.stale_fallbacks: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # announces (the router's pump feeds these, already fence-gated)
    # ------------------------------------------------------------------
    def insert(self, worker: str, epoch: int, seq, length: int,
               geom: Optional[Dict[str, Any]] = None,
               tier: str = "hot") -> IndexRecord:
        rec = IndexRecord(worker, tuple(seq), length, epoch, geom, tier)
        if len(rec.seq) < self.min_prefix_len:
            return rec    # unusably short: never index it
        with self._lock:
            self._clock += 1
            rec.last_used = self._clock
            old = self._by_worker.get(rec.worker, {}).get(rec.seq)
            if old is not None:
                self._remove_locked(old)
            node = self._insert_node(rec.seq)
            node.recs[rec.worker] = rec
            self._by_worker.setdefault(rec.worker, {})[rec.seq] = rec
            self.inserts += 1
        return rec

    def evict(self, worker: str, seq, tier: Optional[str] = None
              ) -> bool:
        """A worker announced it no longer holds ``seq`` (device slot
        scavenged AND not spilled, or the spill store dropped it).
        ``tier`` scopes the removal: a SPILL-store eviction must only
        drop a ``spill``-tier record — the worker may have re-donated
        the same sequence to its device trie since (the record is
        ``hot`` again), and deleting that claim would silently stop
        the router pulling a prefix the worker still holds."""
        seq = tuple(int(t) for t in seq)
        with self._lock:
            rec = self._by_worker.get(str(worker), {}).get(seq)
            if rec is None or (tier is not None and rec.tier != tier):
                return False
            self._remove_locked(rec)
            self.evicts += 1
            return True

    def demote(self, worker: str, seq, tier: str = "spill") -> bool:
        """Device slot scavenged but the slab SPILLED: the prefix is
        still pullable from the worker's host tier."""
        seq = tuple(int(t) for t in seq)
        with self._lock:
            rec = self._by_worker.get(str(worker), {}).get(seq)
            if rec is None:
                return False
            rec.tier = tier
            self.demotions += 1
            return True

    def snapshot(self, worker: str, epoch: int, entries,
                 geom: Optional[Dict[str, Any]] = None) -> int:
        """Full rebuild of one worker's view — rides the ``hello``
        re-admission handshake: whatever the index believed about the
        worker is REPLACED by what the worker says it holds now."""
        self.drop_worker(worker, count=False)
        n = 0
        for ent in entries:
            self.insert(worker, epoch, ent["seq"], ent["length"],
                        geom=ent.get("geom", geom),
                        tier=ent.get("tier", "hot"))
            n += 1
        with self._lock:
            self.snapshots += 1
        return n

    def drop_worker(self, worker: str, count: bool = True) -> int:
        """The death/fence/drain path: every record of ``worker`` is
        soft state of a corpse — drop them all in one sweep."""
        with self._lock:
            recs = list(self._by_worker.get(str(worker), {}).values())
            for rec in recs:
                self._remove_locked(rec)
            if count and recs:
                self.dropped_workers += 1
            return len(recs)

    def reset_counters(self) -> None:
        """Zero the rate counters (hits/misses/stale fallbacks) while
        keeping the structure and its structural counters — the bench
        warm-up must not leak into the measured window
        (``FleetRouter.reset_stats`` calls this)."""
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.stale_fallbacks = {}

    def count_stale(self, reason: str) -> None:
        """A claim this index advertised turned out wrong at pull time
        — the counted degrade-to-re-prefill outcome, per reason."""
        with self._lock:
            self.stale_fallbacks[reason] = \
                self.stale_fallbacks.get(reason, 0) + 1

    # ------------------------------------------------------------------
    # trie plumbing
    # ------------------------------------------------------------------
    def _insert_node(self, seq: Tuple[int, ...]) -> "_Node":
        node, depth = self._root, 0
        while True:
            if depth == len(seq):
                return node
            edge = node.edges.get(seq[depth])
            if edge is None:
                child = _Node(parent=node)
                node.edges[seq[depth]] = (seq[depth:], child)
                return child
            label, child = edge
            k = _common_len(label, seq[depth:])
            if k == len(label):
                node, depth = child, depth + k
                continue
            mid = _Node(parent=node)
            node.edges[seq[depth]] = (label[:k], mid)
            mid.edges[label[k]] = (label[k:], child)
            child.parent = mid
            node, depth = mid, depth + k

    def _remove_locked(self, rec: IndexRecord) -> None:
        by = self._by_worker.get(rec.worker)
        if by is not None:
            by.pop(rec.seq, None)
            if not by:
                self._by_worker.pop(rec.worker, None)
        node, depth, partial = self._walk(rec.seq)
        if depth == len(rec.seq) and partial is None \
                and node.recs.get(rec.worker) is rec:
            del node.recs[rec.worker]
            self._prune(node)

    def _walk(self, seq) -> Tuple["_Node", int, Optional["_Node"]]:
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

    def _prune(self, node: "_Node") -> None:
        while node is not None and node is not self._root \
                and not node.recs and not node.edges:
            parent = node.parent
            for tok, (label, child) in list(parent.edges.items()):
                if child is node:
                    del parent.edges[tok]
                    break
            node = parent

    def _subtree_best(self, node: "_Node", workers=None,
                      model_id: Optional[str] = None
                      ) -> Optional[IndexRecord]:
        """Best record in the subtree: hot beats spill, recent beats
        old (record count is bounded by slots × workers — cheap DFS).
        ``model_id`` pins the variant: an unlabeled record (no geom)
        is REFUSED under a pinned query — conservative, because a
        cross-model pull is silent garbage, a re-prefill is just
        tokens."""
        best: Optional[IndexRecord] = None
        stack = [node]
        while stack:
            n = stack.pop()
            for rec in n.recs.values():
                if workers is not None and rec.worker not in workers:
                    continue
                if model_id is not None and rec.model_id != model_id:
                    continue
                if best is None or (
                        (TIERS.index(rec.tier), -rec.last_used)
                        < (TIERS.index(best.tier), -best.last_used)):
                    best = rec
            stack.extend(child for _, child in n.edges.values())
        return best

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def match(self, prompt, workers=None, count: bool = True,
              model_id: Optional[str] = None
              ) -> Tuple[Optional[IndexRecord], int]:
        """Longest indexed prefix of ``prompt`` among ``workers`` (None
        = any): ``(record, match_len)`` with the trie-cache semantics —
        capped at ``len(prompt) - 1`` and the record's own length — or
        ``(None, 0)``.  ``count=False`` is the peek face (per-worker
        probes must not distort the hit/miss counters).  ``model_id``
        keys the claim: only same-variant records match; a
        prefix that WOULD have hit another variant's slab is a counted
        ``model_mismatch`` stale fallback, never a cross-model pull."""
        prompt = tuple(int(t) for t in prompt)
        if len(prompt) < 2:
            if count:
                with self._lock:
                    self.misses += 1
            return None, 0
        with self._lock:
            node, depth, partial = self._walk(prompt[: len(prompt) - 1])
            sub = partial if partial is not None else node
            rec = self._subtree_best(sub, workers, model_id)
            if rec is None and model_id is not None \
                    and depth >= self.min_prefix_len and count \
                    and self._subtree_best(sub, workers) is not None:
                # the ONLY claims on this prefix belong to a different
                # variant — the heterogeneous-fleet near-miss, counted
                # under the existing stale-fallback discipline
                self.stale_fallbacks["model_mismatch"] = \
                    self.stale_fallbacks.get("model_mismatch", 0) + 1
            if rec is None or depth < self.min_prefix_len:
                if count:
                    self.misses += 1
                return None, 0
            match_len = min(depth, rec.length, len(prompt) - 1)
            if match_len < self.min_prefix_len:
                if count:
                    self.misses += 1
                return None, 0
            if count:
                self.hits += 1
                self._clock += 1
                rec.last_used = self._clock
            return rec, match_len

    def match_for(self, worker: str, prompt) -> int:
        """Longest indexed prefix ``worker`` itself claims (the LOCAL
        half of the pull decision) — peek semantics, no counters."""
        _, mlen = self.match(prompt, workers={str(worker)}, count=False)
        return mlen

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def entries_for(self, worker: str
                    ) -> Dict[Tuple[int, ...], Tuple[int, str]]:
        with self._lock:
            return {seq: (rec.length, rec.tier)
                    for seq, rec in
                    self._by_worker.get(str(worker), {}).items()}

    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._by_worker)

    @property
    def n_entries(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._by_worker.values())

    def stats(self) -> Dict[str, float]:
        with self._lock:
            per_worker = {w: float(len(v))
                          for w, v in self._by_worker.items()}
            return {
                "entries": float(sum(len(v)
                                     for v in self._by_worker.values())),
                "workers": float(len(self._by_worker)),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "inserts": float(self.inserts),
                "evicts": float(self.evicts),
                "demotions": float(self.demotions),
                "snapshots": float(self.snapshots),
                "dropped_workers": float(self.dropped_workers),
                "stale_fallbacks": float(
                    sum(self.stale_fallbacks.values())),
                **{f"entries/{w}": n for w, n in sorted(
                    per_worker.items())},
            }

    def state(self) -> Dict[str, Any]:
        """The ``fleet_health`` provider's cache-index block."""
        with self._lock:
            return {
                "entries": sum(len(v)
                               for v in self._by_worker.values()),
                "per_worker": {
                    w: [{"len": rec.length, "tier": rec.tier,
                         "epoch": rec.epoch, "model": rec.model_id,
                         "seq_head": list(rec.seq[:8])}
                        for rec in sorted(v.values(),
                                          key=lambda r: -r.last_used)]
                    for w, v in sorted(self._by_worker.items())},
                "hits": self.hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evicts": self.evicts,
                "demotions": self.demotions,
                "snapshots": self.snapshots,
                "stale_fallbacks": dict(self.stale_fallbacks),
            }

    def check_invariants(self) -> None:
        """Trie/reverse-map agreement: every reverse-map record sits at
        its terminal node, every node record is reverse-mapped."""
        with self._lock:
            for worker, by in self._by_worker.items():
                for seq, rec in by.items():
                    node, depth, partial = self._walk(seq)
                    assert depth == len(seq) and partial is None, rec
                    assert node.recs.get(worker) is rec, rec
            stack = [self._root]
            seen = 0
            while stack:
                n = stack.pop()
                for rec in n.recs.values():
                    assert self._by_worker.get(rec.worker, {}).get(
                        rec.seq) is rec, rec
                    seen += 1
                stack.extend(child for _, child in n.edges.values())
            assert seen == sum(len(v) for v in self._by_worker.values())
