"""Fault-tolerant distributed checkpointing.

Counterpart of ``chainermn_tpu/extensions/checkpoint.py`` (reference:
``chainermn/extensions/checkpoint.py :: create_multi_node_checkpointer(
name, comm, cp_interval, gc_interval, path)``): each process snapshots its
own shard of state, old generations are garbage-collected, and
``maybe_load`` resumes from the newest generation that is consistent
across all processes.  A process is a rank of the communicator's process
group (``comm.process_index`` / ``comm.process_count``), where the JAX
package takes ``jax.process_index()`` / ``jax.process_count()``.  State is
any picklable tree: the Trainer's ``checkpoint_state()`` (module and
optimizer ``state_dict``s, the iterator's state) qualifies.

The host snapshot (``save``)
----------------------------
JAX arrays are immutable, so the JAX package's host copy is a snapshot by
construction.  A torch optimizer updates its tensors in place, and
``.cpu()`` of a CPU tensor is the tensor itself, so ``save`` takes a true
snapshot: a CPU tensor is cloned, a CUDA tensor is copied into a pinned
host buffer with ``non_blocking=True`` (two sets of buffers, reused
alternately, so the copy never waits for the write in flight), numpy
arrays are copied, and every other leaf goes through a pickle round trip
(an unpicklable state fails at ``save`` itself).  One synchronisation of
the current stream ends the copies: it is the only place ``save`` blocks
on the device.  Tensors stay torch tensors in the shard (numpy has no
bf16), and the manifest records their dtype in torch's spelling
(``torch.bfloat16``).

Asynchronous writes: pickle, CRC32, the manifest's checksum exchange and
the disk write run on one background thread; the train loop continues at
once.  Depth is bounded at one write in flight (a new save waits out the
previous one), every read or consistency operation joins the writer
first, and a writer error re-raises at the next checkpoint call instead
of vanishing.  ``timings`` keeps, per generation, the ms ``save`` blocked
and the writer's ms and bytes.

Format v2 — world-size-independent checkpoints
----------------------------------------------
Each generation carries a per-generation MANIFEST
(``{name}.iter{it}.world{n}.manifest.json``, written by the process
owning rank 0) recording the schema, world size, partition LAYOUT
(leaf path in ``jax.tree_util.keystr`` syntax, e.g.
``['updater']['state'][0]['layer1.0.conv1.weight']`` → ``replicated`` /
``per_rank`` / ``["sharded", axis]``), logical leaf shapes, and a CRC32
per shard, field for field the JAX package's manifest.  The checksum
exchange rides ``allgather_obj_eventual`` — the BOUNDED, non-lockstep
side channel over the process group's store — never a gang collective:
``save()`` stays a LOCAL operation, so a peer that skips a generation,
is mid-preemption, or is already dead degrades the manifest (its
checksum is simply absent, ``_verify_shard`` accepts that shard
unverified) instead of wedging every survivor's save.  Two things fall
out:

* **Torn-shard tolerance** — ``_consistent_generations`` verifies every
  local shard against its manifest checksum and silently excludes a
  generation with a corrupt/truncated shard, so resume falls back to the
  previous consistent one instead of unpickling garbage (a torn write at
  the instant of death can no longer poison resume).
* **Elastic resume** — ``maybe_load`` on a DIFFERENT process count finds
  the newest gang-agreed old-world generation, reads ALL its shards
  (shared filesystem assumed, as every elastic scheduler provides),
  re-partitions them host-side via
  :func:`chainermn_tpu_torch.parallel.reshard.reshard_host` per the
  manifest layout, and resumes the exact trajectory — iterator and
  optimizer state included.  ChainerMN's fault-tolerant checkpoint
  required the original rank count; here a preempted n=8 job continues
  on the n=4 that survives.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import sys
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import _tree
from ..communicators.base import CommunicatorBase

#: Manifest schema stamp (bump on layout-incompatible changes).
MANIFEST_SCHEMA = "chainermn_tpu.ckpt_manifest.v2"


def _atomic_write(directory: str, target: str, payload: bytes) -> None:
    """Write-then-rename so a crash mid-write never corrupts ``target``."""
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


_IMMUTABLE = (type(None), bool, int, float, complex, str, bytes, np.generic)


class _PinnedPool:
    """Two sets of pinned host buffers, used alternately: a save copies
    into one set while the write of the previous save may still read the
    other (the writer is one deep, so the set before that is free)."""

    def __init__(self):
        self._sets: List[Dict[int, Any]] = [{}, {}]
        self._turn = 0

    def next_set(self) -> Dict[int, Any]:
        self._turn ^= 1
        return self._sets[self._turn]


def _to_host(tree, pool: Optional[_PinnedPool] = None):
    """A host snapshot of ``tree`` that shares no memory with it: CPU
    tensors cloned, CUDA tensors copied into pinned buffers (``pool``'s,
    when given) and the stream synchronised once, numpy arrays copied,
    any other mutable leaf through a pickle round trip."""
    import torch

    leaves, treedef = _tree.flatten(tree)
    bufs = pool.next_set() if pool is not None else {}
    out, cuda = [], False
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                buf = bufs.get(i)
                if (buf is None or buf.shape != x.shape
                        or buf.dtype != x.dtype):
                    buf = bufs[i] = torch.empty(
                        x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                out.append(buf)
                cuda = True
            else:
                out.append(x.clone())
        elif isinstance(x, np.ndarray):
            out.append(np.array(x, copy=True, order="K"))
        elif isinstance(x, _IMMUTABLE):
            out.append(x)
        else:
            out.append(pickle.loads(pickle.dumps(
                x, protocol=pickle.HIGHEST_PROTOCOL)))
    if cuda:
        torch.cuda.current_stream().synchronize()
    return treedef.unflatten(out)


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def _leaf_paths_and_shapes(state, layout: Optional[Dict[str, Any]],
                           world: int) -> List[Dict[str, Any]]:
    """``[{path, shape, dtype}]`` with LOGICAL shapes: a leaf the layout
    declares sharded on axis ``a`` has its local axis-``a`` extent
    multiplied by the world size (shards partition the logical array)."""
    import torch

    layout = layout or {}
    out = []
    for dotted, leaf in _tree.flatten_with_path(state)[0]:
        arr = (leaf if isinstance(leaf, (np.ndarray, torch.Tensor))
               else np.asarray(leaf))
        shape = list(getattr(arr, "shape", ()))
        spec = layout.get(dotted, "replicated")
        if isinstance(spec, (list, tuple)) and spec and spec[0] == "sharded":
            ax = int(spec[1])
            if ax < len(shape):
                shape[ax] = shape[ax] * world
        out.append({"path": dotted, "shape": shape,
                    "dtype": str(getattr(arr, "dtype", type(leaf).__name__))})
    return out


def _layout_spec_tree(state, layout: Optional[Dict[str, Any]]):
    """Translate a dotted-path layout map into the per-leaf spec tree
    :func:`~chainermn_tpu_torch.parallel.reshard.reshard_host` consumes:
    ``None`` (replicated, the default), ``"per_rank"``, or an int axis."""
    layout = layout or {}

    def spec_of(dotted):
        spec = layout.get(dotted, "replicated")
        if spec in (None, "replicated"):
            return None
        if spec == "per_rank":
            return "per_rank"
        if isinstance(spec, (list, tuple)) and spec and spec[0] == "sharded":
            return int(spec[1])
        if isinstance(spec, int):
            return spec
        raise ValueError(f"unknown layout spec {spec!r} for {dotted!r}")

    paths, treedef = _tree.flatten_with_path(state)
    return treedef.unflatten([spec_of(p) for p, _ in paths])


class MultiNodeCheckpointer:
    """Sharded generation-based checkpointer with consistent auto-resume.

    Knobs (reference signature + one addition):

    * ``cp_interval`` — trainer-extension save frequency, in iterations.
    * ``gc_interval`` — run GC once every this many ``save`` calls.
    * ``keep`` — how many newest generations GC retains (the reference
      conflated this with ``cp_interval``; a separate knob avoids
      "checkpoint every 1000 iters" implying "keep 1000 generations").
    """

    def __init__(self, name: str, comm: CommunicatorBase, path: str,
                 cp_interval: int = 5, gc_interval: int = 5, keep: int = 5,
                 async_write: bool = True,
                 layout: Optional[Dict[str, Any]] = None,
                 manifest: bool = True):
        self.name = name
        self.comm = comm
        self.path = path
        self.cp_interval = int(cp_interval)
        self.gc_interval = int(gc_interval)
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError("keep must be >= 1 (GC may never delete the "
                             "newest generation)")
        self._saves_since_gc = 0
        self._async = bool(async_write)
        self._executor = None
        self._pending = None  # Future of the one in-flight write
        #: dotted leaf path → "replicated" (default) | "per_rank" |
        #: ["sharded", axis] — recorded in the generation manifest and
        #: consumed by the elastic-restore reshard.
        self.layout = dict(layout or {})
        self._manifest = bool(manifest)
        #: How long the rank-0 owner waits for peer checksums before
        #: writing a (possibly partial) manifest.  Only the owner pays
        #: it, and only for peers that never publish — a skipped or dead
        #: peer costs one bounded wait, never a wedge.
        self.manifest_timeout_s = 5.0
        self._sum_prev_tag: Optional[str] = None
        # iteration of the last shard THIS process put on disk (the
        # preemption bundle reports it)
        self.last_saved_iteration: Optional[int] = None
        self._pool = _PinnedPool()
        #: per generation: iteration, save_block_ms (the host snapshot),
        #: write_ms (pickle, CRC, checksum exchange, write) and bytes
        self.timings: List[Dict[str, Any]] = []
        os.makedirs(path, exist_ok=True)

    # ---- naming ----
    @property
    def _process(self) -> int:
        return int(getattr(self.comm, "process_index", 0))

    @property
    def _nproc(self) -> int:
        return int(getattr(self.comm, "process_count", 1))

    def _filename(self, iteration: int, process: Optional[int] = None) -> str:
        p = self._process if process is None else process
        return os.path.join(
            self.path,
            f"{self.name}.iter{iteration:012d}.proc{p}of{self._nproc}")

    _PAT = re.compile(
        r"^(?P<name>.+)\.iter(?P<it>\d{12})\.proc(?P<proc>\d+)of(?P<nproc>\d+)$")

    def _local_files(self, any_world_size: bool = False) -> List[Tuple[int, str]]:
        """(iteration, filename) shards THIS process has on disk (matching
        the current world size unless ``any_world_size``)."""
        out = []
        for fn in os.listdir(self.path):
            m = self._PAT.match(fn)
            if (m and m.group("name") == self.name
                    and int(m.group("proc")) == self._process
                    and (any_world_size or int(m.group("nproc")) == self._nproc)):
                out.append((int(m.group("it")), os.path.join(self.path, fn)))
        return sorted(out)

    def _local_generations(self, any_world_size: bool = False) -> List[int]:
        return [it for it, _ in self._local_files(any_world_size)]

    # ---- manifest (format v2) ----
    def _manifest_path(self, iteration: int, nproc: Optional[int] = None
                       ) -> str:
        n = self._nproc if nproc is None else nproc
        return os.path.join(
            self.path,
            f"{self.name}.iter{iteration:012d}.world{n}.manifest.json")

    _MANIFEST_PAT = re.compile(
        r"^(?P<name>.+)\.iter(?P<it>\d{12})\.world(?P<n>\d+)"
        r"\.manifest\.json$")

    def _read_manifest(self, iteration: int, nproc: Optional[int] = None
                       ) -> Optional[Dict[str, Any]]:
        p = self._manifest_path(iteration, nproc)
        try:
            with open(p) as f:
                man = json.load(f)
        except (FileNotFoundError, ValueError, OSError):
            return None
        if man.get("schema") != MANIFEST_SCHEMA:
            return None
        return man

    def _write_manifest(self, iteration: int,
                        checksums: Dict[int, int],
                        leaves: List[Dict[str, Any]]) -> None:
        man = {
            "schema": MANIFEST_SCHEMA,
            "name": self.name,
            "iteration": iteration,
            "world_size": self._nproc,
            "kind": "proc",
            "layout": self.layout,
            "leaves": leaves,
            "checksums": {str(p): int(c) for p, c in checksums.items()},
        }
        _atomic_write(
            self.path, self._manifest_path(iteration),
            json.dumps(man, sort_keys=True, indent=1).encode())

    def _verify_shard(self, fname: str, manifest: Dict[str, Any],
                      shard_key: str) -> bool:
        """CRC the shard against the manifest; a missing manifest entry
        counts as unverifiable-but-accepted (v1 compat), a mismatch or an
        unreadable file as torn."""
        want = (manifest.get("checksums") or {}).get(shard_key)
        if want is None:
            return True
        try:
            with open(fname, "rb") as f:
                return _crc(f.read()) == int(want)
        except OSError:
            return False

    # ---- async writer plumbing ----
    def _join_writer(self) -> None:
        """Wait out the in-flight write; re-raise its error if it failed."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def _submit(self, fn, *args):
        from concurrent.futures import ThreadPoolExecutor

        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"chainermn-tpu-torch-ckpt-{self.name}")
        self._pending = self._executor.submit(fn, *args)

    def flush(self) -> None:
        """Block until the in-flight async write (if any) is on disk."""
        self._join_writer()

    # ---- save / load ----
    def save(self, state: Any, iteration: int) -> None:
        """Snapshot this process's shard of ``state`` at ``iteration``.

        Atomic per shard (tmp file + rename) so a crash mid-save never
        corrupts an older generation — the reference relied on the same
        write-then-rename discipline.  The host snapshot happens here,
        synchronously (:func:`_to_host`: it shares no memory with the
        live state, so the train loop may go on mutating it); with
        ``async_write`` (default) the pickle, the checksum exchange and
        the disk IO are deferred to the writer thread.
        """
        t0 = time.perf_counter()
        host_state = _to_host(state, self._pool)
        row = {"iteration": int(iteration),
               "save_block_ms": (time.perf_counter() - t0) * 1e3}
        self.timings.append(row)
        if not self._async:
            self._write_generation(host_state, iteration, row)
            return
        self._join_writer()  # bounded depth: one write in flight
        self._submit(self._write_generation, host_state, iteration, row)

    def _write_generation(self, host_state, iteration: int,
                          row: Dict[str, Any]) -> None:
        """The writer's share of a save: pickle, CRC32, the manifest's
        checksum exchange, the shard and manifest writes, GC."""
        t0 = time.perf_counter()
        payload = pickle.dumps(host_state, protocol=pickle.HIGHEST_PROTOCOL)
        manifest_task = None
        if self._manifest:
            # NOT a gang collective: each process publishes its shard
            # checksum on the bounded best-effort side channel
            # (``allgather_obj_eventual``) and only the rank-0 owner —
            # the manifest writer — waits (``manifest_timeout_s``) to
            # collect them.  A peer that skips this generation or died
            # mid-step is simply absent from the manifest (its shard
            # loads unverified, v1-style); it can never wedge this
            # process's save — a skipped save and the preemption final
            # save both depend on that.
            checksum = _crc(payload)
            tag = f"{self.name}.it{iteration}.w{self._nproc}"
            owner = self.comm.owns_rank(0)
            per_proc = self.comm.allgather_obj_eventual(
                tag, checksum,
                timeout_s=self.manifest_timeout_s if owner else 0.0,
                discard_tag=self._sum_prev_tag)
            self._sum_prev_tag = tag
            checksums = {int(p): int(c) for p, c in per_proc.items()}
            if owner:
                leaves = _leaf_paths_and_shapes(host_state, self.layout,
                                                self._nproc)
                manifest_task = (iteration, checksums, leaves)
        self._write(payload, iteration, manifest_task)
        row.update(write_ms=(time.perf_counter() - t0) * 1e3,
                   bytes=len(payload))

    def _write(self, payload: bytes, iteration: int,
               manifest_task=None) -> None:
        _atomic_write(self.path, self._filename(iteration), payload)
        if manifest_task is not None:
            self._write_manifest(*manifest_task)
        self.last_saved_iteration = iteration
        self._saves_since_gc += 1
        if self._saves_since_gc >= self.gc_interval:
            self._gc()
            self._saves_since_gc = 0

    def _gc(self) -> None:
        """Drop all but the newest ``keep`` local generations (plus the
        manifests of dropped generations, if this process wrote them)."""
        gens = self._local_generations()
        for it in gens[:-self.keep]:
            try:
                os.unlink(self._filename(it))
            except FileNotFoundError:
                pass
            if self.comm.owns_rank(0):
                try:
                    os.unlink(self._manifest_path(it))
                except FileNotFoundError:
                    pass
        self._gc_other_worlds()

    def _gc_other_worlds(self) -> None:
        """After an elastic resume the OLD world's shards have no owning
        process in the new world (`_gc` above matches only
        ``proc{me}of{nproc}``), so a preempted n=8 job resumed at n=4
        would leak ranks 4-7's shards forever.  The rank-0 owner deletes
        other-world generations once a NEWER same-world save exists —
        `_gc` only runs after a save, and saves only happen once every
        process has passed ``maybe_load`` (training is collective), so
        nobody is still reading them."""
        if not self.comm.owns_rank(0) or self.last_saved_iteration is None:
            return
        newest = self.last_saved_iteration
        for fn in os.listdir(self.path):
            m = self._PAT.match(fn)
            if (m and m.group("name") == self.name
                    and int(m.group("nproc")) != self._nproc
                    and int(m.group("it")) <= newest):
                try:
                    os.unlink(os.path.join(self.path, fn))
                except FileNotFoundError:
                    pass
                continue
            m = self._MANIFEST_PAT.match(fn)
            if (m and m.group("name") == self.name
                    and int(m.group("n")) != self._nproc
                    and int(m.group("it")) <= newest):
                try:
                    os.unlink(os.path.join(self.path, fn))
                except FileNotFoundError:
                    pass

    def _consistent_generations(self) -> List[int]:
        """Generations every process has with a CHECKSUM-CLEAN local
        shard (set intersection over DCN).  A generation whose shard
        fails its manifest CRC — the torn write of a process killed
        mid-save — is excluded HERE, before the gang intersection, so
        every process falls back to the same previous consistent
        generation instead of unpickling garbage.  Generations without a
        manifest (v1 / ``manifest=False``) are accepted unverified."""
        local = set()
        for it, fname in self._local_files():
            man = self._read_manifest(it)
            if man is not None and not self._verify_shard(
                    fname, man, str(self._process)):
                print(f"[chainermn_tpu_torch checkpoint] shard {fname} fails "
                      f"its manifest checksum (torn write?) — skipping "
                      f"generation {it}", file=sys.stderr, flush=True)
                continue
            local.add(it)
        all_lists = self.comm.allgather_obj(sorted(local))
        consistent = local
        for other in all_lists:
            consistent &= set(other)
        return sorted(consistent)

    # ---- elastic resume (format v2 + reshard_host) ----
    def _elastic_candidates(self) -> List[Tuple[int, int]]:
        """(iteration, old_world) pairs this process can FULLY restore
        from local/shared disk: a manifest exists for a DIFFERENT world
        size and every one of its shards is present and checksum-clean."""
        out = []
        for fn in os.listdir(self.path):
            m = self._MANIFEST_PAT.match(fn)
            if not m or m.group("name") != self.name:
                continue
            old_n = int(m.group("n"))
            it = int(m.group("it"))
            if old_n == self._nproc:
                continue
            man = self._read_manifest(it, old_n)
            if man is None:
                continue
            ok = True
            for p in range(old_n):
                shard = os.path.join(
                    self.path,
                    f"{self.name}.iter{it:012d}.proc{p}of{old_n}")
                if not (os.path.exists(shard)
                        and self._verify_shard(shard, man, str(p))):
                    ok = False
                    break
            if ok:
                out.append((it, old_n))
        return sorted(out)

    def _elastic_load(self, iteration: int, old_n: int) -> Any:
        """Read every old-world shard, re-partition via ``reshard_host``
        per the manifest layout, return THIS process's new shard."""
        from ..parallel.reshard import reshard_host

        man = self._read_manifest(iteration, old_n) or {}
        shards = []
        for p in range(old_n):
            shard = os.path.join(
                self.path,
                f"{self.name}.iter{iteration:012d}.proc{p}of{old_n}")
            with open(shard, "rb") as f:
                shards.append(pickle.load(f))
        layout = man.get("layout") or {}
        spec_tree = _layout_spec_tree(shards[0], layout)
        new_shards = reshard_host(shards, spec_tree, spec_tree, self._nproc)
        print(f"[chainermn_tpu_torch checkpoint] elastic resume: generation "
              f"{iteration} resharded {old_n} -> {self._nproc} process(es)",
              file=sys.stderr, flush=True)
        return new_shards[self._process]

    def maybe_load(self, state: Any = None, elastic: bool = True
                   ) -> Tuple[Any, Optional[int]]:
        """Resume from the newest consistent generation, if any.

        Returns ``(state, iteration)``; ``(state, None)`` untouched when no
        consistent checkpoint exists (fresh start) — mirroring the
        reference's ``maybe_load`` no-op contract.  Tensors come back on
        the host; ``Trainer.load_checkpoint_state`` copies each onto its
        live tensor's device and dtype.

        **Elastic** (format v2, default on): when the newest restorable
        generation was saved under a DIFFERENT world size, its shards are
        re-partitioned host-side per the manifest layout
        (:func:`~chainermn_tpu_torch.parallel.reshard.reshard_host`) and every
        process receives its new-world shard — a preempted n=8 job
        resumes on the n=4 that survives.  Candidate agreement is
        collective (intersection of what every process can fully verify
        over the object lane), so the gang can never split between a
        resumed and a fresh-started half.  Same-world generations win
        ties; a strictly NEWER other-world generation wins outright.

        If shards exist but nothing is restorable (an interrupted v1 save
        with nothing older, or manifest-less shards from another world
        size), every process raises the same error on gang-agreed
        information — loud and collective, exactly like the reference's
        same-rank-count requirement, minus the cases v2 makes
        resumable.
        """
        self._join_writer()  # our newest shard must be on disk and visible
        gens = self._consistent_generations()
        newest_same = gens[-1] if gens else None
        newest_elastic: Optional[Tuple[int, int]] = None
        if elastic:
            cand_lists = self.comm.allgather_obj(self._elastic_candidates())
            agreed = set(map(tuple, cand_lists[0]))
            for other in cand_lists[1:]:
                agreed &= set(map(tuple, other))
            if agreed:
                newest_elastic = max(agreed)
        if newest_elastic is not None and (
                newest_same is None or newest_elastic[0] > newest_same):
            it, old_n = newest_elastic
            return self._elastic_load(it, old_n), it
        if newest_same is None:
            any_stale = any(self.comm.allgather_obj(
                bool(self._local_generations(any_world_size=True))))
            if any_stale:
                raise RuntimeError(
                    f"checkpoint shards for '{self.name}' exist in "
                    f"{self.path} but no generation is restorable across "
                    f"all {self._nproc} process(es) — an interrupted save "
                    "left only partial/torn shards, or the world size "
                    "changed and the shards carry no v2 manifest to "
                    "reshard from; resume with the original world size or "
                    "delete the stale shards")
            return state, None
        it = newest_same
        with open(self._filename(it), "rb") as f:
            loaded = pickle.load(f)
        return loaded, it

    def get_generations(self) -> List[int]:
        """Consistent generations currently resumable (newest last)."""
        self._join_writer()
        return self._consistent_generations()

    def finalize(self) -> None:
        """Delete every local shard (reference: cleanup on job teardown),
        including shards saved under a different world size.  Cleanup runs
        even when the last in-flight write failed — its error re-raises
        AFTER the contract is honored."""
        try:
            self._join_writer()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
            for _, path in self._local_files(any_world_size=True):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            if self.comm.owns_rank(0):
                for fn in os.listdir(self.path):
                    m = self._MANIFEST_PAT.match(fn)
                    if m and m.group("name") == self.name:
                        try:
                            os.unlink(os.path.join(self.path, fn))
                        except FileNotFoundError:
                            pass

    # ---- trainer-extension face (chainermn_tpu_torch.training) ----
    # When registering directly (``trainer.extend(checkpointer)``) the save
    # cadence comes from the TRAINER's trigger alone; ``cp_interval`` is only
    # this extension's default trigger period, never a second gate.
    trigger = property(lambda self: (self.cp_interval, "iteration"))

    def __call__(self, trainer) -> None:
        self.save(trainer.checkpoint_state(), trainer.iteration)


def create_multi_node_checkpointer(
    name: str,
    comm: CommunicatorBase,
    cp_interval: int = 5,
    gc_interval: int = 5,
    path: Optional[str] = None,
    keep: int = 5,
    async_write: bool = True,
    layout: Optional[Dict[str, Any]] = None,
    manifest: bool = True,
) -> MultiNodeCheckpointer:
    """Factory with the reference's signature (``create_multi_node_checkpointer``);
    ``path`` defaults to ``./{name}-checkpoints`` like the reference's
    cwd-relative default.  ``layout``/``manifest`` are the format-v2 knobs
    (elastic resume + torn-shard tolerance — see class docstring)."""
    if path is None:
        path = os.path.join(os.getcwd(), f"{name}-checkpoints")
    return MultiNodeCheckpointer(name, comm, path, cp_interval, gc_interval,
                                 keep, async_write, layout=layout,
                                 manifest=manifest)


def reshard_checkpoint(path: str, name: str, new_nproc: int,
                       iteration: Optional[int] = None,
                       source_process: int = 0) -> int:
    """Rewrite a checkpoint saved under one world size for another.

    Beyond-reference (the reference REQUIRES the original rank count): an
    offline tool for the common elastic case where
    per-process state is REPLICATED (params, optimizer state, trainer
    counters — everything the training steps keep replicated).  It takes
    ``source_process``'s shard of the newest old-world generation (or
    ``iteration``) and writes it as every one of the ``new_nproc`` shards.

    Contract: rank-SPECIFIC state inside the shard (iterator cursors, RNG
    per rank) is duplicated, not resharded — the multi-node iterator
    tolerates this (non-master ranks install the master's broadcast state),
    but anything else per-rank must be re-derived by the caller after
    resume.  Run this offline (no gang needed), then restart the job at the
    new world size.

    Returns the iteration rewritten.  Raises if no complete old-world
    generation exists.
    """
    pat = MultiNodeCheckpointer._PAT
    by_gen: dict = {}
    for fn in os.listdir(path):
        m = pat.match(fn)
        if m and m.group("name") == name:
            key = (int(m.group("it")), int(m.group("nproc")))
            by_gen.setdefault(key, set()).add(int(m.group("proc")))
    if new_nproc < 1:
        raise ValueError(f"new_nproc must be >= 1, got {new_nproc}")
    # superset, not equality: a stray shard with proc >= nproc must not
    # disqualify a generation whose required shards all exist
    complete = [(it, nproc) for (it, nproc), procs in by_gen.items()
                if procs >= set(range(nproc))
                and (iteration is None or it == iteration)]
    if not complete:
        raise RuntimeError(
            f"no complete generation for '{name}' in {path}"
            + (f" at iteration {iteration}" if iteration is not None else ""))
    it = max(i for i, _ in complete)
    worlds = sorted(n for i, n in complete if i == it)
    if len(worlds) > 1 and iteration is None:
        # Two complete generations at the SAME iteration under different
        # world sizes: picking one silently decides which payload wins.
        # Make the caller choose via iteration= + cleaning the stale set.
        raise RuntimeError(
            f"iteration {it} of '{name}' has complete checkpoints for "
            f"multiple world sizes {worlds}; remove the stale generation "
            f"or pass iteration= explicitly to confirm the newest one")
    old_nproc = worlds[-1]
    if not 0 <= source_process < old_nproc:
        raise ValueError(f"source_process {source_process} outside the old "
                         f"world size {old_nproc}")
    src = os.path.join(
        path, f"{name}.iter{it:012d}.proc{source_process}of{old_nproc}")
    with open(src, "rb") as f:
        payload = f.read()
    for p in range(new_nproc):
        _atomic_write(path, os.path.join(
            path, f"{name}.iter{it:012d}.proc{p}of{new_nproc}"), payload)
    return it
