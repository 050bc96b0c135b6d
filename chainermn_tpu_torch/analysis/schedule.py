"""Collective schedule IR — comm programs as compiled, checkable artifacts.

Counterpart of ``chainermn_tpu/analysis/schedule.py``, a copy: the same
IR, generators, cost model and fingerprints, so a schedule lowered here
is the JAX package's schedule byte for byte (schemas keep their
``chainermn_tpu.*`` names: the two packages read each other's records).

ROADMAP item 3 / GC3 (arxiv 2201.11840): a redistribution between two
sharding specs should not be one opaque monolithic collective but an
explicit PROGRAM of transfers that can be chunked, pipelined, and staged
hierarchically over ICI-then-DCN — and statically verified before it
ever runs.  This module is the IR + the lowering generators + the r04
cost model; the verifier (coverage, exhaustive BFS model check,
deterministic interpreter) lives in :mod:`.schedule_check`.

IR grammar (schema ``chainermn_tpu.schedule.v1``)::

    Schedule  := array geometry (shape/dtype/src_spec/dst_spec/worlds)
                 + Topology + {Chunk} + {Transfer} + per-rank programs
    Chunk     := named payload: (src_rank, dst_rank,
                                 segments=[(src_off, dst_off, n), ...])
                 offsets in ELEMENTS of the flattened local blocks
    Transfer  := (tid, chunk, src, dst, dest∈{out,stage}, link∈{ici,dcn},
                  via=None | staged-chunk-name)
    Op        := copy(chunk)     -- local in-block → out-block
               | unstage(chunk)  -- local stage     → out-block
               | start(tid)      -- async issue on Transfer.src (a "send")
               | done(tid)       -- blocking await on Transfer.dst (a "recv")

``start``/``done`` are the async halves the item-5 bucket-pipelined
allreduce will reuse; a synchronous send/recv pair is simply a start
immediately awaited.  A ``reduce`` op kind is reserved in the grammar
for that plane (parsed, serialized, refused by the verifier until the
accumulation coverage rule lands).

A Transfer with ``via=c`` forwards a previously STAGED chunk ``c`` from
its ``src`` rank instead of gathering from the in-block — that is the
hierarchical staging primitive: cross-slice bytes go over DCN ONCE to a
gateway rank, which fans them out over ICI to its slice peers
(portable-redistribution, arxiv 2112.01075).  The verifier demands the
via chunk's source projection be byte-identical to the forwarded
chunk's (same global elements), so staging can never smuggle wrong
bytes.

Everything here is stdlib + numpy; no jax import (the analysis-package
contract).  Cost constants are the BENCH_r04 ``project_dp_scaling``
assumptions in ``bench.py`` (v5e ICI 1.8e11 B/s, 1 µs/hop; DCN 2.5e10
B/s per host) — the schedule chooser and the scaling projection price
the same wire.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SCHEDULE_SCHEMA", "CALIBRATION_SCHEMA", "Topology", "Chunk",
    "Transfer", "Op", "Schedule",
    "CostModel", "calibrated_cost_model",
    "block_shape", "block_global_indices", "expected_flow",
    "lower_single", "lower_chunked", "lower_pipelined",
    "lower_hierarchical", "GENERATORS", "candidate_schedules",
    "price_schedule",
]

SCHEDULE_SCHEMA = "chainermn_tpu.schedule.v1"


def np_dtype(name) -> np.dtype:
    """The numpy dtype that holds a schedule's elements.  ``"bfloat16"``
    (named as JAX names it, so fingerprints match) is held as ``int16``:
    numpy has no bf16 of its own, and a schedule only moves bytes."""
    return np.dtype(np.int16 if str(name) == "bfloat16" else name)

OP_KINDS = ("copy", "unstage", "start", "done", "reduce")
#: synchronous aliases accepted by from_json (GC3 grammar speaks
#: send/recv; our canonical async forms are start/done).
_OP_ALIASES = {"send": "start", "recv": "done"}
LINKS = ("ici", "dcn")
DESTS = ("out", "stage")


# --------------------------------------------------------------------------
# topology
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Topology:
    """``slices`` pods of ``per_slice`` ranks; intra-slice wire is ICI,
    cross-slice is DCN (the two-tier TPU fabric of
    ``hierarchical_pmean``)."""
    slices: int
    per_slice: int

    @property
    def size(self) -> int:
        return self.slices * self.per_slice

    @classmethod
    def flat(cls, world: int) -> "Topology":
        return cls(1, int(world))

    def slice_of(self, rank: int) -> int:
        return rank // self.per_slice

    def pos_of(self, rank: int) -> int:
        return rank % self.per_slice

    def link(self, a: int, b: int) -> str:
        if a == b:
            raise ValueError("no link from a rank to itself")
        return "ici" if self.slice_of(a) == self.slice_of(b) else "dcn"


# --------------------------------------------------------------------------
# IR nodes
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Chunk:
    """A named payload: ``segments`` are (src_off, dst_off, n) runs in
    elements of the flattened (C-order) local blocks."""
    name: str
    src_rank: int
    dst_rank: int
    segments: Tuple[Tuple[int, int, int], ...]

    @property
    def nelems(self) -> int:
        return sum(n for _, _, n in self.segments)

    def src_side(self) -> Tuple[Tuple[int, int], ...]:
        """The source projection (src_off, n) — what bytes this chunk
        reads, independent of where they land."""
        return tuple((so, n) for so, _, n in self.segments)


@dataclass(frozen=True)
class Transfer:
    tid: str
    chunk: str
    src: int
    dst: int
    #: "out" lands into the destination block; "stage" parks the payload
    #: in the dst rank's staging buffer for a later forwarding hop.
    dest: str
    link: str
    #: payload source at ``src``: None = gather from the in-block
    #: (requires chunk.src_rank == src); a chunk name = forward that
    #: previously staged chunk's payload.
    via: Optional[str] = None


@dataclass(frozen=True)
class Op:
    kind: str
    arg: str  # chunk name for copy/unstage/reduce, tid for start/done

    def render(self) -> str:
        return f"{self.kind}({self.arg})"


@dataclass
class Schedule:
    name: str
    kind: str
    shape: Tuple[int, ...]
    dtype: str
    src_spec: Optional[int]
    dst_spec: Optional[int]
    src_world: int
    dst_world: int
    topology: Topology
    chunks: Dict[str, Chunk]
    transfers: Dict[str, Transfer]
    #: rank -> ordered op list; rank ids cover max(src_world, dst_world).
    programs: Dict[int, List[Op]]
    #: declared landing-buffer capacity (outstanding started-not-done
    #: transfers targeting any single rank); the model check proves the
    #: reachable maximum never exceeds it.
    max_inflight: int = 0

    @property
    def n_ranks(self) -> int:
        return max(self.src_world, self.dst_world)

    @property
    def itemsize(self) -> int:
        return int(np_dtype(self.dtype).itemsize)

    def wire_bytes(self) -> Dict[str, int]:
        out = {"ici": 0, "dcn": 0}
        for t in self.transfers.values():
            out[t.link] += self.chunks[t.chunk].nelems * self.itemsize
        return out

    def stats(self) -> Dict[str, object]:
        wb = self.wire_bytes()
        return {
            "kind": self.kind,
            "chunks": len(self.chunks),
            "transfers": len(self.transfers),
            "ops": sum(len(p) for p in self.programs.values()),
            "ici_bytes": wb["ici"],
            "dcn_bytes": wb["dcn"],
            "max_inflight": self.max_inflight,
        }

    # -- serialization: the "compiled artifact" face --------------------

    def to_json(self) -> dict:
        return {
            "schema": SCHEDULE_SCHEMA,
            "name": self.name,
            "kind": self.kind,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "src_spec": self.src_spec,
            "dst_spec": self.dst_spec,
            "src_world": self.src_world,
            "dst_world": self.dst_world,
            "topology": [self.topology.slices, self.topology.per_slice],
            "max_inflight": self.max_inflight,
            "chunks": [
                {"name": c.name, "src": c.src_rank, "dst": c.dst_rank,
                 "segments": [list(s) for s in c.segments]}
                for c in self.chunks.values()],
            "transfers": [
                {"tid": t.tid, "chunk": t.chunk, "src": t.src,
                 "dst": t.dst, "dest": t.dest, "link": t.link,
                 "via": t.via}
                for t in self.transfers.values()],
            "programs": {
                str(r): [[op.kind, op.arg] for op in prog]
                for r, prog in sorted(self.programs.items())},
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Schedule":
        if doc.get("schema") != SCHEDULE_SCHEMA:
            raise ValueError(
                f"not a {SCHEDULE_SCHEMA} document: "
                f"schema={doc.get('schema')!r}")
        chunks = {}
        for c in doc["chunks"]:
            chunks[c["name"]] = Chunk(
                c["name"], int(c["src"]), int(c["dst"]),
                tuple(tuple(int(x) for x in s) for s in c["segments"]))
        transfers = {}
        for t in doc["transfers"]:
            transfers[t["tid"]] = Transfer(
                t["tid"], t["chunk"], int(t["src"]), int(t["dst"]),
                t["dest"], t["link"], t.get("via"))
        programs = {}
        for r, prog in doc["programs"].items():
            ops = []
            for kind, arg in prog:
                kind = _OP_ALIASES.get(kind, kind)
                if kind not in OP_KINDS:
                    raise ValueError(f"unknown op kind {kind!r}")
                ops.append(Op(kind, arg))
            programs[int(r)] = ops
        topo = doc.get("topology")
        return cls(
            name=doc["name"], kind=doc.get("kind", "unknown"),
            shape=tuple(int(x) for x in doc["shape"]),
            dtype=doc["dtype"],
            src_spec=doc["src_spec"], dst_spec=doc["dst_spec"],
            src_world=int(doc["src_world"]),
            dst_world=int(doc["dst_world"]),
            topology=(Topology(int(topo[0]), int(topo[1])) if topo
                      else Topology.flat(max(int(doc["src_world"]),
                                             int(doc["dst_world"])))),
            chunks=chunks, transfers=transfers, programs=programs,
            max_inflight=int(doc.get("max_inflight", 0)))

    def fingerprint(self) -> str:
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


# --------------------------------------------------------------------------
# block geometry: the same np.array_split math as reshard_host, so the
# oracle and the runtime can never disagree about where a byte lives.
# --------------------------------------------------------------------------

def block_shape(shape: Sequence[int], spec: Optional[int], rank: int,
                world: int) -> Tuple[int, ...]:
    shape = tuple(int(x) for x in shape)
    if spec is None:
        return shape
    axis = int(spec)
    if not 0 <= axis < len(shape):
        raise ValueError(f"spec axis {axis} out of range for {shape}")
    lo, hi = _split_bounds(shape[axis], world, rank)
    out = list(shape)
    out[axis] = hi - lo
    return tuple(out)


def _split_bounds(length: int, world: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of ``rank``'s slice under np.array_split semantics."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    base, extra = divmod(length, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def block_global_indices(shape: Sequence[int], spec: Optional[int],
                         rank: int, world: int) -> np.ndarray:
    """Flat C-order GLOBAL element indices of ``rank``'s local block,
    enumerated in the block's own C order (strictly increasing, since a
    slice preserves C-order monotonicity)."""
    shape = tuple(int(x) for x in shape)
    total = int(np.prod(shape)) if shape else 1
    if spec is None:
        return np.arange(total, dtype=np.int64)
    axis = int(spec)
    lo, hi = _split_bounds(shape[axis], world, rank)
    g = np.arange(total, dtype=np.int64).reshape(shape)
    sl = [slice(None)] * len(shape)
    sl[axis] = slice(lo, hi)
    return g[tuple(sl)].reshape(-1)


def _runs(src_pos: np.ndarray, dst_pos: np.ndarray
          ) -> Tuple[Tuple[int, int, int], ...]:
    """Compress aligned position arrays into (src_off, dst_off, n)
    maximal contiguous runs."""
    if len(src_pos) == 0:
        return ()
    brk = np.where((np.diff(src_pos) != 1) | (np.diff(dst_pos) != 1))[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [len(src_pos)]])
    return tuple((int(src_pos[a]), int(dst_pos[a]), int(e - a))
                 for a, e in zip(starts, ends))


def expected_flow(shape: Sequence[int], src_spec: Optional[int],
                  dst_spec: Optional[int], src_world: int,
                  dst_world: int
                  ) -> Dict[Tuple[int, int], Tuple[Tuple[int, int, int],
                                                   ...]]:
    """The statics oracle: (src_rank, dst_rank) -> segments such that
    every destination element is covered exactly once.

    For a sharded source the owner of each element is unique, so the
    flow is the exact block intersection.  For a replicated source every
    replica holds everything; we pin the single source per destination
    the way ``reshard_host`` does: the destination rank itself when it
    was part of the old world (a pure local copy — the zero-wire R→S
    lowering of ``reshard``), else old rank ``d % src_world``.
    """
    flows: Dict[Tuple[int, int], Tuple[Tuple[int, int, int], ...]] = {}
    gdst = {d: block_global_indices(shape, dst_spec, d, dst_world)
            for d in range(dst_world)}
    if src_spec is None:
        for d in range(dst_world):
            s = d if d < src_world else d % src_world
            # a replicated src block is the full array, so the dst
            # element's global index IS its src offset.
            segs = _runs(gdst[d],
                         np.arange(len(gdst[d]), dtype=np.int64))
            if segs:
                flows[(s, d)] = segs
        return flows
    for s in range(src_world):
        gsrc = block_global_indices(shape, src_spec, s, src_world)
        for d in range(dst_world):
            common, src_pos, dst_pos = np.intersect1d(
                gsrc, gdst[d], assume_unique=True, return_indices=True)
            if len(common) == 0:
                continue
            flows[(s, d)] = _runs(src_pos, dst_pos)
    return flows


def _split_segments(segments: Sequence[Tuple[int, int, int]],
                    n_chunks: int
                    ) -> List[Tuple[Tuple[int, int, int], ...]]:
    """Split a segment list into ``n_chunks`` pieces of near-equal
    element count (np.array_split sizing), cutting inside segments when
    needed.  Deterministic, so identical source projections split
    identically — the alignment hierarchical staging relies on."""
    total = sum(n for _, _, n in segments)
    n_chunks = max(1, min(int(n_chunks), total)) if total else 1
    if n_chunks == 1:
        return [tuple(segments)]
    bounds = [_split_bounds(total, n_chunks, i)[0]
              for i in range(n_chunks)] + [total]
    pieces: List[List[Tuple[int, int, int]]] = [[] for _ in
                                                range(n_chunks)]
    off = 0
    for so, do, n in segments:
        seg_lo, seg_hi = off, off + n
        for i in range(n_chunks):
            lo = max(seg_lo, bounds[i])
            hi = min(seg_hi, bounds[i + 1])
            if lo < hi:
                pieces[i].append((so + (lo - seg_lo),
                                  do + (lo - seg_lo), hi - lo))
        off += n
    return [tuple(p) for p in pieces if p]


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def _declared_inflight(transfers: Dict[str, Transfer]) -> int:
    per_dst: Dict[int, int] = {}
    for t in transfers.values():
        per_dst[t.dst] = per_dst.get(t.dst, 0) + 1
    return max(per_dst.values(), default=0)


def _base(shape, dtype, src_spec, dst_spec, src_world, dst_world,
          topology, kind) -> Schedule:
    world = max(int(src_world), int(dst_world))
    topo = topology or Topology.flat(world)
    if topo.size < world:
        raise ValueError(f"topology {topo} smaller than world {world}")
    name = (f"{kind}:{_spec_name(src_spec)}->{_spec_name(dst_spec)}"
            f"@{src_world}->{dst_world}"
            f"/{'x'.join(map(str, shape))}:{dtype}")
    return Schedule(
        name=name, kind=kind, shape=tuple(int(x) for x in shape),
        dtype=str(dtype), src_spec=src_spec, dst_spec=dst_spec,
        src_world=int(src_world), dst_world=int(dst_world),
        topology=topo, chunks={}, transfers={},
        programs={r: [] for r in range(world)})


def _spec_name(spec) -> str:
    return "R" if spec is None else f"S{int(spec)}"


def _finish(sched: Schedule) -> Schedule:
    sched.max_inflight = max(1, _declared_inflight(sched.transfers))
    return sched


def lower_single(shape, dtype, src_spec, dst_spec, src_world, dst_world,
                 topology: Optional[Topology] = None) -> Schedule:
    """The current monolithic lowering as an explicit program: local
    copies, then every rank posts all its sends, then awaits all its
    receives — exactly the all-posted buffer envelope of the one-shot
    collective."""
    return lower_chunked(shape, dtype, src_spec, dst_spec, src_world,
                         dst_world, topology, n_chunks=1, kind="single")


def lower_chunked(shape, dtype, src_spec, dst_spec, src_world,
                  dst_world, topology: Optional[Topology] = None,
                  n_chunks: int = 4, kind: str = "chunked") -> Schedule:
    """Flat lowering with each pairwise flow split into ``n_chunks``
    pieces (alpha cost up, enables overlap downstream)."""
    sched = _base(shape, dtype, src_spec, dst_spec, src_world,
                  dst_world, topology, kind)
    flows = expected_flow(shape, src_spec, dst_spec, src_world,
                          dst_world)
    copies: Dict[int, List[Op]] = {}
    sends: Dict[int, List[Op]] = {}
    recvs: Dict[int, List[Op]] = {}
    for (s, d), segs in sorted(flows.items()):
        for j, piece in enumerate(_split_segments(segs, n_chunks)):
            cname = f"c{s}_{d}_{j}"
            sched.chunks[cname] = Chunk(cname, s, d, piece)
            if s == d:
                copies.setdefault(s, []).append(Op("copy", cname))
                continue
            tid = f"t{s}_{d}_{j}"
            sched.transfers[tid] = Transfer(
                tid, cname, s, d, "out", sched.topology.link(s, d))
            sends.setdefault(s, []).append(Op("start", tid))
            recvs.setdefault(d, []).append(Op("done", tid))
    for r in sched.programs:
        sched.programs[r] = (copies.get(r, []) + sends.get(r, [])
                             + recvs.get(r, []))
    return _finish(sched)


def lower_pipelined(shape, dtype, src_spec, dst_spec, src_world,
                    dst_world, topology: Optional[Topology] = None,
                    n_chunks: int = 4, depth: int = 2) -> Schedule:
    """Chunked lowering with each rank's program interleaving its sends
    and receives: at most ``depth`` of its own starts run ahead of its
    done stream, so landings drain (and downstream consumers unblock)
    while later pieces are still on the wire."""
    sched = lower_chunked(shape, dtype, src_spec, dst_spec, src_world,
                          dst_world, topology, n_chunks,
                          kind="pipelined")
    depth = max(1, int(depth))
    for r, prog in sched.programs.items():
        copies = [op for op in prog if op.kind == "copy"]
        starts = [op for op in prog if op.kind == "start"]
        dones = [op for op in prog if op.kind == "done"]
        merged = copies + starts[:depth]
        si, di = depth, 0
        while si < len(starts) or di < len(dones):
            if di < len(dones):
                merged.append(dones[di])
                di += 1
            if si < len(starts):
                merged.append(starts[si])
                si += 1
        sched.programs[r] = merged
    return _finish(sched)


def lower_hierarchical(shape, dtype, src_spec, dst_spec, src_world,
                       dst_world, topology: Topology,
                       n_chunks: int = 1) -> Schedule:
    """ICI/DCN staged lowering.  Cross-slice flows whose destinations in
    one slice want the SAME source bytes (replicated destinations —
    elastic expansion, rolling-upgrade gather) cross DCN once to a
    gateway rank and fan out over ICI; everything else goes direct over
    its natural link.  With ``n_chunks > 1`` the gateway forwards piece
    ``j`` over ICI while piece ``j+1`` is still on the DCN wire — the
    pipelined hierarchical candidate."""
    sched = _base(shape, dtype, src_spec, dst_spec, src_world,
                  dst_world, topology, "hierarchical")
    topo = sched.topology
    flows = expected_flow(shape, src_spec, dst_spec, src_world,
                          dst_world)
    copies: Dict[int, List[Op]] = {}
    free_sends: Dict[int, List[Op]] = {}        # via=None starts
    inbound: Dict[int, List[Transfer]] = {}     # ordered dones per rank
    followups: Dict[Tuple[int, str], List[Op]] = {}  # after a landing

    def add_chunk(cname, s, d, piece):
        sched.chunks[cname] = Chunk(cname, s, d, piece)

    def direct(s, d, j, piece):
        cname = f"c{s}_{d}_{j}"
        add_chunk(cname, s, d, piece)
        tid = f"t{s}_{d}_{j}"
        t = Transfer(tid, cname, s, d, "out", topo.link(s, d))
        sched.transfers[tid] = t
        free_sends.setdefault(s, []).append(Op("start", tid))
        inbound.setdefault(d, []).append(t)

    # group cross-slice flows by (src, dst slice) to find shareable fans
    groups: Dict[Tuple[int, int], List[Tuple[int, tuple]]] = {}
    for (s, d), segs in sorted(flows.items()):
        if s == d:
            for j, piece in enumerate(_split_segments(segs, n_chunks)):
                cname = f"c{s}_{d}_{j}"
                add_chunk(cname, s, d, piece)
                copies.setdefault(s, []).append(Op("copy", cname))
        elif topo.link(s, d) == "ici":
            for j, piece in enumerate(_split_segments(segs, n_chunks)):
                direct(s, d, j, piece)
        else:
            groups.setdefault((s, topo.slice_of(d)), []).append(
                (d, segs))

    for (s, dslice), members in sorted(groups.items()):
        src_sides = {tuple((so, n) for so, _, n in segs)
                     for _, segs in members}
        if len(members) == 1 or len(src_sides) != 1:
            # nothing shareable: direct DCN per destination
            for d, segs in members:
                for j, piece in enumerate(
                        _split_segments(segs, n_chunks)):
                    direct(s, d, j, piece)
            continue
        # gateway: the member aligned with the source's in-slice
        # position when present (spreads DCN ingress), else the lowest.
        dsts = [d for d, _ in members]
        aligned = [d for d in dsts if topo.pos_of(d) == topo.pos_of(s)]
        g = aligned[0] if aligned else min(dsts)
        by_dst = dict(members)
        g_pieces = _split_segments(by_dst[g], n_chunks)
        others = sorted(d for d in dsts if d != g)
        for j, g_piece in enumerate(g_pieces):
            carrier = f"c{s}_{g}_{j}"
            add_chunk(carrier, s, g, g_piece)
            tid = f"t{s}_{g}_{j}"
            t = Transfer(tid, carrier, s, g, "stage", "dcn")
            sched.transfers[tid] = t
            free_sends.setdefault(s, []).append(Op("start", tid))
            inbound.setdefault(g, []).append(t)
            fol = followups.setdefault((g, carrier), [])
            fol.append(Op("unstage", carrier))
            for d in others:
                cname = f"c{s}_{d}_{j}"
                piece = _split_segments(by_dst[d], n_chunks)[j]
                add_chunk(cname, s, d, piece)
                ftid = f"t{s}_{d}_{j}"
                ft = Transfer(ftid, cname, g, d, "out", "ici",
                              via=carrier)
                sched.transfers[ftid] = ft
                fol.append(Op("start", ftid))
                inbound.setdefault(d, []).append(ft)

    for r in sched.programs:
        prog = copies.get(r, []) + free_sends.get(r, [])
        for t in inbound.get(r, []):
            prog.append(Op("done", t.tid))
            if t.dest == "stage":
                prog.extend(followups.get((r, t.chunk), []))
        sched.programs[r] = prog
    return _finish(sched)


GENERATORS = {
    "single": lower_single,
    "chunked": lower_chunked,
    "pipelined": lower_pipelined,
    "hierarchical": lower_hierarchical,
}


def candidate_schedules(shape, dtype, src_spec, dst_spec, src_world,
                        dst_world, topology: Optional[Topology] = None,
                        n_chunks: int = 4, depth: int = 2
                        ) -> List[Schedule]:
    """The search space: the monolithic baseline plus the chunked,
    pipelined, and (when the topology has a DCN tier) hierarchical
    candidates, in deterministic order."""
    world = max(int(src_world), int(dst_world))
    topo = topology or Topology.flat(world)
    out = [
        lower_single(shape, dtype, src_spec, dst_spec, src_world,
                     dst_world, topo),
        lower_chunked(shape, dtype, src_spec, dst_spec, src_world,
                      dst_world, topo, n_chunks=n_chunks),
        lower_pipelined(shape, dtype, src_spec, dst_spec, src_world,
                        dst_world, topo, n_chunks=n_chunks,
                        depth=depth),
    ]
    if topo.slices > 1:
        out.append(lower_hierarchical(
            shape, dtype, src_spec, dst_spec, src_world, dst_world,
            topo, n_chunks=n_chunks))
    return out


# --------------------------------------------------------------------------
# r04 cost model + deterministic event pricing
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CostModel:
    """Wire constants from BENCH_r04 ``project_dp_scaling`` (bench.py):
    v5e ICI 1.8e11 B/s with 1 µs/hop alpha, DCN 2.5e10 B/s per host.
    The DCN alpha and local copy bandwidth are this model's own
    assumptions (cross-host message setup is dominated by the NIC/host
    stack; copies run at HBM-ish speed)."""
    ici_bw: float = 1.8e11
    dcn_bw: float = 2.5e10
    alpha_ici_s: float = 1.0e-6
    alpha_dcn_s: float = 25.0e-6
    copy_bw: float = 4.0e11

    def bw(self, link: str) -> float:
        return self.ici_bw if link == "ici" else self.dcn_bw

    def alpha(self, link: str) -> float:
        return self.alpha_ici_s if link == "ici" else self.alpha_dcn_s


#: Versioned schema of the persisted calibration artifact produced by
#: :mod:`.calibrate` — per-link (alpha, bw) fitted from measured
#: ``schedule_exec`` records.  Lives here (not in calibrate.py) so
#: :func:`price_schedule` can validate it without a circular import.
CALIBRATION_SCHEMA = "chainermn_tpu.calibration.v1"


def calibrated_cost_model(calibration: Optional[dict],
                          base: Optional[CostModel] = None) -> CostModel:
    """A :class:`CostModel` with the fitted per-link constants from a
    calibration artifact substituted over ``base`` (stock r04 constants
    for any link the fit could not resolve).  Refuses an artifact whose
    schema version is not ours — a stale calibration silently priced as
    current is exactly the rot this plane exists to prevent."""
    cm = base or CostModel()
    if not calibration:
        return cm
    schema = calibration.get("schema")
    if schema != CALIBRATION_SCHEMA:
        raise ValueError(
            f"stale/foreign calibration artifact: schema={schema!r}, "
            f"want {CALIBRATION_SCHEMA} (re-fit with "
            f"chainermn_tpu_torch.analysis.calibrate)")
    links = calibration.get("links") or {}
    kw: Dict[str, float] = {}
    ici = links.get("ici") or {}
    if ici.get("bw"):
        kw["ici_bw"] = float(ici["bw"])
        kw["alpha_ici_s"] = float(ici.get("alpha_s", cm.alpha_ici_s))
    dcn = links.get("dcn") or {}
    if dcn.get("bw"):
        kw["dcn_bw"] = float(dcn["bw"])
        kw["alpha_dcn_s"] = float(dcn.get("alpha_s", cm.alpha_dcn_s))
    copy = links.get("copy") or {}
    if copy.get("bw"):
        kw["copy_bw"] = float(copy["bw"])
    if not kw:
        return cm
    from dataclasses import replace
    return replace(cm, **kw)


def price_schedule(sched: Schedule,
                   cost_model: Optional[CostModel] = None,
                   calibration: Optional[dict] = None
                   ) -> Dict[str, object]:
    """Deterministic event simulation of one schedule.

    Resource model: each rank owns one egress and one ingress port per
    link class; transfers on the same port serialize (NIC/ICI-port
    contention — this is what makes the all-posted monolithic schedule
    pay 2·(P-1)/P·bytes/bw like the ring model in
    ``project_dp_scaling``), while different ports and link classes
    overlap freely.  ``start`` is asynchronous (the issuing rank does
    not wait); ``done`` blocks until the wire completes; landings and
    local copies cost bytes/copy_bw on the executing rank.

    ``calibration`` is a loaded ``chainermn_tpu.calibration.v1``
    artifact (see :mod:`.calibrate`): its fitted per-link constants are
    substituted over ``cost_model`` so candidates rank by MEASURED
    costs; a stale-schema artifact raises.
    """
    cm = calibrated_cost_model(calibration, cost_model) \
        if calibration is not None else (cost_model or CostModel())
    item = sched.itemsize
    rank_time = {r: 0.0 for r in sched.programs}
    egress: Dict[Tuple[int, str], float] = {}
    ingress: Dict[Tuple[int, str], float] = {}
    completion: Dict[str, float] = {}
    land_time: Dict[Tuple[int, str], float] = {}  # (rank, chunk)->t
    pcs = {r: 0 for r in sched.programs}
    bytes_by = {"ici": 0, "dcn": 0, "copy": 0}
    msgs_by = {"ici": 0, "dcn": 0}

    def ready(r: int, op: Op) -> bool:
        if op.kind == "done":
            return op.arg in completion
        if op.kind == "unstage":
            return (r, op.arg) in land_time
        if op.kind == "start":
            t = sched.transfers[op.arg]
            return t.via is None or (r, t.via) in land_time
        return True

    progressed = True
    while progressed:
        progressed = False
        for r in sorted(sched.programs):
            prog = sched.programs[r]
            while pcs[r] < len(prog) and ready(r, prog[pcs[r]]):
                op = prog[pcs[r]]
                pcs[r] += 1
                progressed = True
                if op.kind in ("copy", "unstage"):
                    nbytes = sched.chunks[op.arg].nelems * item
                    base = rank_time[r]
                    if op.kind == "unstage":
                        base = max(base, land_time[(r, op.arg)])
                    rank_time[r] = base + nbytes / cm.copy_bw
                    bytes_by["copy"] += nbytes
                elif op.kind == "start":
                    t = sched.transfers[op.arg]
                    nbytes = sched.chunks[t.chunk].nelems * item
                    issue = rank_time[r]
                    if t.via is not None:
                        issue = max(issue, land_time[(r, t.via)])
                    beg = max(issue,
                              egress.get((t.src, t.link), 0.0),
                              ingress.get((t.dst, t.link), 0.0))
                    end = beg + cm.alpha(t.link) + nbytes / cm.bw(t.link)
                    egress[(t.src, t.link)] = end
                    ingress[(t.dst, t.link)] = end
                    completion[t.tid] = end
                    bytes_by[t.link] += nbytes
                    msgs_by[t.link] += 1
                elif op.kind == "done":
                    t = sched.transfers[op.arg]
                    nbytes = sched.chunks[t.chunk].nelems * item
                    rank_time[r] = (max(rank_time[r],
                                        completion[op.arg])
                                    + nbytes / cm.copy_bw)
                    if t.dest == "stage":
                        land_time[(r, t.chunk)] = rank_time[r]
                else:  # pragma: no cover - reduce reserved
                    raise NotImplementedError(
                        f"cost model: op kind {op.kind!r} reserved")
    if any(pcs[r] < len(sched.programs[r]) for r in pcs):
        stuck = {r: sched.programs[r][pcs[r]].render()
                 for r in pcs if pcs[r] < len(sched.programs[r])}
        raise RuntimeError(
            f"price_schedule: schedule {sched.name} does not make "
            f"progress (verify it first); stuck at {stuck}")
    wall = max([0.0] + list(rank_time.values())
               + list(completion.values()))
    return {
        "schedule": sched.name,
        "kind": sched.kind,
        "wall_us": wall * 1e6,
        "cost_ms": wall * 1e3,
        "ici_bytes": bytes_by["ici"],
        "dcn_bytes": bytes_by["dcn"],
        "copy_bytes": bytes_by["copy"],
        "ici_messages": msgs_by["ici"],
        "dcn_messages": msgs_by["dcn"],
    }
