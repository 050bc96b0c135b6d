"""Replica-set-aware snapshots: write once per GROUP, not once per rank.

Counterpart of ``chainermn_tpu/extensions/multi_node_snapshot.py``
(reference: ``chainermn/extensions/multi_node_snapshot.py ::
multi_node_snapshot(comm, snapshot, replica_sets)``) — when training is
data-parallel, every rank in a replica set
holds IDENTICAL state, so writing one snapshot per rank multiplies the
checkpoint IO and storage by the set size for nothing.  The wrapper makes
only the first rank of each replica set write, and on resume the loaded
state fans out to the rest of the set.

Shards are written at replica-SET granularity (``.set{i}of{n}`` files)
by the process owning the set's lead rank, and the restore fan-out
inside a set rides ``split(...)`` sub-communicators' object transport
(``bcast_obj``) — shared filesystems are NOT assumed.  Ranks absent from
``replica_sets`` form singleton sets, exactly the reference's default.
The file layout and the ``kind="set"`` manifest are the JAX package's.

Composition, not reimplementation: the wrapper borrows the
:class:`~..extensions.checkpoint.MultiNodeCheckpointer` it is given for
its name, path, trigger cadence and write discipline (atomic
write-then-rename), and overrides only WHO writes and HOW a shard is
located on resume.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..communicators.base import CommunicatorBase
from .checkpoint import (MANIFEST_SCHEMA, MultiNodeCheckpointer,
                         _atomic_write, _crc, _leaf_paths_and_shapes,
                         _to_host)


def _normalize_sets(replica_sets: Sequence[Sequence[int]],
                    size: int) -> List[List[int]]:
    """Validate + complete the partition: listed sets must be disjoint and
    in range; unlisted ranks become singleton sets (reference default)."""
    seen: set = set()
    sets: List[List[int]] = []
    for s in replica_sets:
        s = sorted(int(r) for r in s)
        if not s:
            raise ValueError("empty replica set")
        for r in s:
            if not 0 <= r < size:
                raise ValueError(f"rank {r} outside world size {size}")
            if r in seen:
                raise ValueError(f"rank {r} appears in two replica sets")
            seen.add(r)
        sets.append(s)
    for r in range(size):
        if r not in seen:
            sets.append([r])
    return sorted(sets)


class MultiNodeSnapshot:
    """The wrapped extension.  ``save``/``maybe_load``/trainer-``__call__``
    mirror :class:`MultiNodeCheckpointer`'s faces.  The pickle happens in
    ``save`` itself (as in the JAX package); the write rides the
    checkpointer's writer."""

    def __init__(self, comm: CommunicatorBase,
                 snapshot: MultiNodeCheckpointer,
                 replica_sets: Sequence[Sequence[int]]):
        self.comm = comm
        self.ckpt = snapshot
        self.sets = _normalize_sets(replica_sets, comm.size)
        self._set_of_rank = {r: i for i, s in enumerate(self.sets) for r in s}
        # the process's OWN set: the one holding its lead rank (the state a
        # process snapshots is process-wide, so its ranks must not straddle
        # sets — the one-process case owns everything and is exempt by
        # construction)
        owned = [r for r in range(comm.size)
                 if getattr(comm, "owns_rank", lambda _r: True)(r)]
        my_sets = {self._set_of_rank[r] for r in owned}
        if len(my_sets) > 1 and len(owned) != comm.size:
            raise ValueError(
                f"process owns ranks {owned} spanning replica sets "
                f"{sorted(my_sets)}; replica sets must align with process "
                "boundaries (each process's ranks inside ONE set)")
        self.set_id = self._set_of_rank[comm.rank]
        # sets this process WRITES: those whose lead rank it owns
        self._writer_sets = [i for i, s in enumerate(self.sets)
                             if getattr(comm, "owns_rank",
                                        lambda _r: True)(min(s))]

    # ---- naming ----
    @property
    def _nsets(self) -> int:
        return len(self.sets)

    def _filename(self, iteration: int, set_id: int) -> str:
        return os.path.join(
            self.ckpt.path,
            f"{self.ckpt.name}.iter{iteration:012d}"
            f".set{set_id}of{self._nsets}")

    _PAT = re.compile(
        r"^(?P<name>.+)\.iter(?P<it>\d{12})\.set(?P<sid>\d+)of(?P<n>\d+)$")

    # ---- manifest (same format-v2 sidecar as MultiNodeCheckpointer,
    # kind="set": one checksum per replica SET, not per process) ----
    def _manifest_path(self, iteration: int) -> str:
        return os.path.join(
            self.ckpt.path,
            f"{self.ckpt.name}.iter{iteration:012d}"
            f".sets{self._nsets}.manifest.json")

    def _read_manifest(self, iteration: int) -> Optional[Dict[str, Any]]:
        try:
            with open(self._manifest_path(iteration)) as f:
                man = json.load(f)
        except (FileNotFoundError, ValueError, OSError):
            return None
        return man if man.get("schema") == MANIFEST_SCHEMA else None

    def _verify(self, iteration: int, set_id: int) -> bool:
        """Shard vs manifest CRC; manifest-less generations pass (v1)."""
        man = self._read_manifest(iteration)
        if man is None:
            return True
        want = (man.get("checksums") or {}).get(str(set_id))
        if want is None:
            return True
        try:
            with open(self._filename(iteration, set_id), "rb") as f:
                return _crc(f.read()) == int(want)
        except OSError:
            return False

    def _visible_generations(self, set_id: int,
                             any_layout: bool = False) -> List[int]:
        out = []
        for fn in os.listdir(self.ckpt.path):
            m = self._PAT.match(fn)
            if (m and m.group("name") == self.ckpt.name
                    and (any_layout or (int(m.group("sid")) == set_id
                                        and int(m.group("n")) == self._nsets))):
                it = int(m.group("it"))
                if not any_layout and not self._verify(it, set_id):
                    print(f"[chainermn_tpu_torch snapshot] set shard "
                          f"{self._filename(it, set_id)} fails its "
                          f"manifest checksum — skipping generation {it}",
                          file=sys.stderr, flush=True)
                    continue
                out.append(it)
        return sorted(out)

    # ---- save / load ----
    def save(self, state: Any, iteration: int) -> None:
        """One atomic shard per replica set this process leads — a pure-DP
        job with replica sets of size G does 1/G of the per-rank IO.

        Write discipline is the wrapped checkpointer's, really borrowed:
        the detach+pickle happens here synchronously (mutable state must
        not race the train loop), the disk IO rides the checkpointer's
        one-deep async writer thread when it was built with
        ``async_write``, and its ``keep``/``gc_interval`` knobs govern
        the wrapper's own ``.setXofY`` generations."""
        host_state = _to_host(state) if self._writer_sets else None
        payload = (pickle.dumps(host_state,
                                protocol=pickle.HIGHEST_PROTOCOL)
                   if self._writer_sets else None)
        manifest_task = None
        if self.ckpt._manifest:
            # NOT a gang collective (same discipline as the per-process
            # checkpointer): every process publishes its set-id → shard
            # checksum map (non-writers publish an empty one) on the
            # bounded best-effort side channel, and only the rank-0
            # owner — always a writer, rank 0 leads its own set — waits
            # to collect before writing the kind="set" manifest.  A dead
            # or skipping peer's sets go unverified, never wedge a save.
            mine = ({sid: _crc(payload) for sid in self._writer_sets}
                    if payload is not None else {})
            owner = self.comm.owns_rank(0)
            tag = f"{self.ckpt.name}.sets{self._nsets}.it{iteration}"
            per_proc = self.comm.allgather_obj_eventual(
                tag, mine,
                timeout_s=self.ckpt.manifest_timeout_s if owner else 0.0,
                discard_tag=self.ckpt._sum_prev_tag)
            self.ckpt._sum_prev_tag = tag
            checksums: Dict[int, int] = {}
            for entry in per_proc.values():
                checksums.update({int(k): int(v)
                                  for k, v in (entry or {}).items()})
            if owner:
                manifest_task = {
                    "schema": MANIFEST_SCHEMA,
                    "name": self.ckpt.name,
                    "iteration": iteration,
                    "world_size": self._nsets,
                    "kind": "set",
                    "layout": self.ckpt.layout,
                    "leaves": _leaf_paths_and_shapes(
                        host_state, self.ckpt.layout, self._nsets),
                    "checksums": {str(k): v for k, v in checksums.items()},
                }
        if not self._writer_sets:
            return
        if not self.ckpt._async:
            self._write(payload, iteration, manifest_task)
            return
        self.ckpt._join_writer()  # bounded depth: one write in flight
        self.ckpt._submit(self._write, payload, iteration, manifest_task)

    def _write(self, payload: bytes, iteration: int,
               manifest_task=None) -> None:
        for sid in self._writer_sets:
            _atomic_write(self.ckpt.path, self._filename(iteration, sid),
                          payload)
        if manifest_task is not None:
            _atomic_write(
                self.ckpt.path, self._manifest_path(iteration),
                json.dumps(manifest_task, sort_keys=True, indent=1).encode())
        self.ckpt.last_saved_iteration = iteration
        self.ckpt._saves_since_gc += 1
        if self.ckpt._saves_since_gc >= self.ckpt.gc_interval:
            self._gc()
            self.ckpt._saves_since_gc = 0

    def _gc(self) -> None:
        """Drop all but the newest ``keep`` generations of OWNED sets."""
        for sid in self._writer_sets:
            for it in self._visible_generations(sid)[:-self.ckpt.keep]:
                try:
                    os.unlink(self._filename(it, sid))
                except FileNotFoundError:
                    pass
                if self.comm.owns_rank(0):
                    try:
                        os.unlink(self._manifest_path(it))
                    except FileNotFoundError:
                        pass

    def flush(self) -> None:
        """Block until the in-flight async write (if any) is on disk."""
        self.ckpt._join_writer()

    def maybe_load(self, state: Any = None) -> Tuple[Any, Optional[int]]:
        """Newest generation every process's set can produce, fanned out
        within each set: the lead process reads the shard, the rest of the
        set receive it over the split sub-communicator's object lane.

        Shards-exist-but-nothing-consistent fails loudly and collectively,
        exactly like :meth:`MultiNodeCheckpointer.maybe_load` — a silent
        fresh start after a partial gang save would split the job into
        crashed and restarted halves."""
        self.ckpt._join_writer()  # our newest shards must be visible
        local = set(self._visible_generations(self.set_id))
        gens = set.intersection(
            *map(set, self.comm.allgather_obj(sorted(local))))
        if not gens:
            # stale = ANY snapshot shard of this name, including ones from
            # a different replica-set layout (mirrors checkpoint.py's
            # any_world_size probe)
            any_stale = any(self.comm.allgather_obj(bool(
                self._visible_generations(self.set_id, any_layout=True))))
            if any_stale:
                raise RuntimeError(
                    f"replica-set snapshot shards for '{self.ckpt.name}' "
                    f"exist in {self.ckpt.path} but no generation is "
                    f"consistent across all {self._nsets} replica set(s) — "
                    "an interrupted save left partial shards, or the "
                    "replica-set layout changed; restore the original "
                    "layout or delete the stale shards")
            return state, None
        it = max(gens)
        subs = self.comm.split([self._set_of_rank[r]
                                for r in range(self.comm.size)])
        sub = subs[self.set_id] if isinstance(subs, dict) else subs
        payload = None
        if self.set_id in self._writer_sets:
            with open(self._filename(it, self.set_id), "rb") as f:
                payload = f.read()
        payload = sub.bcast_obj(payload, root=0)
        return pickle.loads(payload), it

    # ---- trainer-extension face ----
    trigger = property(lambda self: self.ckpt.trigger)

    def __call__(self, trainer) -> None:
        self.save(trainer.checkpoint_state(), trainer.iteration)


def multi_node_snapshot(comm: CommunicatorBase,
                        snapshot: MultiNodeCheckpointer,
                        replica_sets: Sequence[Sequence[int]]
                        ) -> MultiNodeSnapshot:
    """Factory with the reference's signature
    (``multi_node_snapshot(comm, snapshot, replica_sets)``)."""
    return MultiNodeSnapshot(comm, snapshot, replica_sets)
