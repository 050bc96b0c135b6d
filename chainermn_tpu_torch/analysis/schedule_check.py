"""Static verifier for collective schedule IR — no schedule runs unverified.

Counterpart of ``chainermn_tpu/analysis/schedule_check.py``, a copy.

Three independent proofs per :class:`~.schedule.Schedule`, in order:

1. **Structural + byte-coverage/permutation** (static, numpy): every op
   and transfer is well-formed, and reconciling against the same
   ``np.array_split`` block math :func:`reshard_host
   <chainermn_tpu_torch.parallel.reshard.reshard_host>` / the shardflow
   statics use, every destination element is written EXACTLY once and
   each written run carries exactly the global elements the destination
   block expects at that offset (wrong-source and permutation bugs are
   the same violation: a global-index mismatch).
2. **Exhaustive BFS model check** (reusing :mod:`.protocol`): the
   schedule's start/done machine is explored under ALL rank
   interleavings for deadlock-freedom, staging-fence ordering
   (start-forwarding-before-landing), and buffer-bound safety
   (outstanding transfers at any rank never exceed the declared
   landing capacity).  Violations come back as minimal counterexample
   traces, as the protocol checker reports them.  Delivery timing is absorbed into scheduling
   freedom (``done`` is enabled once the matching ``start`` has
   executed; delaying a delivery is the same as the destination rank
   simply not being scheduled) — sound here because no invariant
   observes in-flight vs landed, and it keeps the state space at the
   product of program counters.
3. **Deterministic interpreter**: the schedule executes on host numpy
   buffers and the result must be byte-exact against the direct
   spec-sliced oracle — this is the execution engine
   ``reshard_host(..., schedule=)`` swaps in, so "verified" and "what
   actually runs" are the same code path.

Seeded-fault mutators (:data:`SEEDED_FAULTS`) produce the broken
candidates the fixture corpus pins at 0 FN / 0 FP: dropped chunk,
double write, send/recv cycle, done-before-start, buffer overrun.

Runner: ``python -m chainermn_tpu_torch.analysis.schedule_check`` verifies
every (src,dst) spec pair reachable from elastic resume, ``heal()``
live shrink, and ``rolling_upgrade()`` (:data:`FLEET_PAIRS`), exits
0/1/2 (the lint contract).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import protocol
from .schedule import (
    Chunk, CostModel, Op, Schedule, Topology, Transfer,
    block_global_indices, block_shape, candidate_schedules, np_dtype,
    price_schedule,
)

__all__ = [
    "VerifyResult", "structural_check", "coverage_check",
    "make_schedule_model", "run_schedule", "make_input_blocks",
    "expected_output_blocks", "verify_schedule", "seed_fault",
    "SEEDED_FAULTS", "compile_verified", "verified_schedule",
    "SCHEDULE_EXEC_SCHEMA", "ScheduleExecProfile", "execute_profiled",
    "FLEET_PAIRS",
    "fleet_pair_topology", "main",
]


# --------------------------------------------------------------------------
# phase 1: structural + coverage
# --------------------------------------------------------------------------

def _block_elems(sched: Schedule, spec, rank: int, world: int) -> int:
    return int(np.prod(block_shape(sched.shape, spec, rank, world)))


def structural_check(sched: Schedule) -> List[str]:
    v: List[str] = []
    topo = sched.topology
    starts: Dict[str, int] = {}
    dones: Dict[str, int] = {}
    for r, prog in sched.programs.items():
        for op in prog:
            if op.kind == "reduce":
                v.append(f"structural: r{r} {op.render()} — reduce ops "
                         f"are reserved for the item-5 allreduce plane "
                         f"and not yet verifiable")
            elif op.kind in ("copy", "unstage"):
                c = sched.chunks.get(op.arg)
                if c is None:
                    v.append(f"structural: r{r} {op.render()} names an "
                             f"unknown chunk")
                    continue
                if op.kind == "copy" and not (c.src_rank == c.dst_rank
                                              == r):
                    v.append(f"structural: r{r} copy({c.name}) but the "
                             f"chunk is r{c.src_rank}->r{c.dst_rank}")
                if op.kind == "unstage" and c.dst_rank != r:
                    v.append(f"structural: r{r} unstage({c.name}) but "
                             f"the chunk lands at r{c.dst_rank}")
            elif op.kind in ("start", "done"):
                t = sched.transfers.get(op.arg)
                if t is None:
                    v.append(f"structural: r{r} {op.render()} names an "
                             f"unknown transfer")
                    continue
                side = starts if op.kind == "start" else dones
                side[op.arg] = side.get(op.arg, 0) + 1
                want = t.src if op.kind == "start" else t.dst
                if r != want:
                    v.append(f"structural: {op.render()} executed on "
                             f"r{r}, belongs to r{want}")
            else:
                v.append(f"structural: unknown op kind {op.kind!r}")
    for tid, t in sorted(sched.transfers.items()):
        c = sched.chunks.get(t.chunk)
        if c is None:
            v.append(f"structural: transfer {tid} names unknown chunk "
                     f"{t.chunk!r}")
            continue
        if t.src == t.dst:
            v.append(f"structural: transfer {tid} is a self-send")
            continue
        if t.link != topo.link(t.src, t.dst):
            v.append(f"structural: transfer {tid} declares link "
                     f"{t.link} but r{t.src}->r{t.dst} is "
                     f"{topo.link(t.src, t.dst)}")
        if t.dest == "out" and t.dst != c.dst_rank:
            v.append(f"structural: transfer {tid} lands chunk "
                     f"{c.name} at r{t.dst}, chunk wants "
                     f"r{c.dst_rank}")
        if t.via is None:
            if c.src_rank != t.src:
                v.append(f"structural: transfer {tid} gathers chunk "
                         f"{c.name} from r{t.src}'s in-block but the "
                         f"chunk is sourced at r{c.src_rank}")
        else:
            via = sched.chunks.get(t.via)
            if via is None:
                v.append(f"structural: transfer {tid} forwards "
                         f"unknown chunk {t.via!r}")
            elif (via.src_rank != c.src_rank
                  or via.src_side() != c.src_side()):
                v.append(f"structural: transfer {tid} forwards staged "
                         f"chunk {t.via} as {c.name} but their source "
                         f"projections differ — staging may not "
                         f"substitute bytes")
        if starts.get(tid, 0) != 1 or dones.get(tid, 0) != 1:
            v.append(f"structural: transfer {tid} needs exactly one "
                     f"start and one done "
                     f"(has {starts.get(tid, 0)}/{dones.get(tid, 0)})")
    for c in sched.chunks.values():
        s_elems = _block_elems(sched, sched.src_spec, c.src_rank,
                               sched.src_world) \
            if c.src_rank < sched.src_world else None
        d_elems = _block_elems(sched, sched.dst_spec, c.dst_rank,
                               sched.dst_world) \
            if c.dst_rank < sched.dst_world else None
        if s_elems is None:
            v.append(f"structural: chunk {c.name} sourced at r"
                     f"{c.src_rank} outside src world "
                     f"{sched.src_world}")
            continue
        if d_elems is None:
            v.append(f"structural: chunk {c.name} lands at r"
                     f"{c.dst_rank} outside dst world "
                     f"{sched.dst_world}")
            continue
        for so, do, n in c.segments:
            if n <= 0 or so < 0 or do < 0 or so + n > s_elems \
                    or do + n > d_elems:
                v.append(f"structural: chunk {c.name} segment "
                         f"({so},{do},{n}) out of block bounds "
                         f"(src {s_elems}, dst {d_elems})")
    if sched.max_inflight < 1:
        v.append("structural: max_inflight must be >= 1")
    return v


def coverage_check(sched: Schedule) -> List[str]:
    """Every destination element written exactly once, from the right
    source: each landed run's source global indices must equal the
    destination block's expected global indices at that offset."""
    v: List[str] = []
    gsrc = {s: block_global_indices(sched.shape, sched.src_spec, s,
                                    sched.src_world)
            for s in range(sched.src_world)}
    gdst = {d: block_global_indices(sched.shape, sched.dst_spec, d,
                                    sched.dst_world)
            for d in range(sched.dst_world)}
    cover = {d: np.zeros(len(gdst[d]), dtype=np.int32)
             for d in range(sched.dst_world)}

    def land(chunk_name: str, what: str):
        c = sched.chunks.get(chunk_name)
        if c is None or c.src_rank >= sched.src_world \
                or c.dst_rank >= sched.dst_world:
            return  # structural_check already reported
        for so, do, n in c.segments:
            if so + n > len(gsrc[c.src_rank]) \
                    or do + n > len(gdst[c.dst_rank]):
                return  # structural bound violation already reported
            if not np.array_equal(gsrc[c.src_rank][so:so + n],
                                  gdst[c.dst_rank][do:do + n]):
                v.append(
                    f"coverage: {what} chunk {c.name} segment "
                    f"({so},{do},{n}) moves the wrong global elements "
                    f"(permutation/source mismatch vs the "
                    f"array_split statics)")
            cover[c.dst_rank][do:do + n] += 1

    for r, prog in sched.programs.items():
        for op in prog:
            if op.kind in ("copy", "unstage"):
                land(op.arg, f"r{r} {op.kind}")
    for t in sched.transfers.values():
        if t.dest == "out":
            land(t.chunk, f"transfer {t.tid}")
    for d in range(sched.dst_world):
        cnt = cover[d]
        missing = int((cnt == 0).sum())
        if missing:
            first = int(np.argmax(cnt == 0))
            v.append(f"coverage: r{d} has {missing} destination "
                     f"element(s) never written (first gap at local "
                     f"offset {first}) — dropped chunk")
        dup = int((cnt > 1).sum())
        if dup:
            first = int(np.argmax(cnt > 1))
            v.append(f"coverage: r{d} has {dup} destination "
                     f"element(s) written more than once (first at "
                     f"local offset {first}) — double write")
    return v


# --------------------------------------------------------------------------
# phase 2: exhaustive BFS model check (protocol.py machinery)
# --------------------------------------------------------------------------

def make_schedule_model(sched: Schedule) -> protocol.Model:
    """The schedule's start/done machine as a :class:`protocol.Model`.

    State = (pc_0, ..., pc_{n-1}, violation) — one program counter per
    rank plus a sticky violation description.  Every rank interleaving
    is explored; ``done(t)`` is enabled once ``start(t)`` has executed
    anywhere (see module docstring for why that abstraction is sound).
    """
    ranks = sorted(sched.programs)
    rix = {r: i for i, r in enumerate(ranks)}
    progs = {r: list(sched.programs[r]) for r in ranks}
    start_pos: Dict[str, Tuple[int, int]] = {}
    done_pos: Dict[str, Tuple[int, int]] = {}
    for r, prog in progs.items():
        for i, op in enumerate(prog):
            if op.kind == "start":
                start_pos.setdefault(op.arg, (rix[r], i))
            elif op.kind == "done":
                done_pos.setdefault(op.arg, (rix[r], i))
    # staged-chunk landing prefix: chunks landed into r's stage buffer
    # strictly before each pc (done ops with dest == "stage").
    stage_prefix: Dict[int, List[frozenset]] = {}
    for r, prog in progs.items():
        acc, pref = set(), [frozenset()]
        for op in prog:
            if op.kind == "done":
                t = sched.transfers.get(op.arg)
                if t is not None and t.dest == "stage":
                    acc.add(t.chunk)
            pref.append(frozenset(acc))
        stage_prefix[rix[r]] = pref
    by_dst: Dict[int, List[Transfer]] = {}
    for t in sched.transfers.values():
        by_dst.setdefault(t.dst, []).append(t)

    def occupancy(pcs: Tuple[int, ...], d: int) -> int:
        occ = 0
        for t in by_dst.get(d, ()):
            sp = start_pos.get(t.tid)
            dp = done_pos.get(t.tid)
            if sp is not None and pcs[sp[0]] > sp[1] \
                    and (dp is None or pcs[dp[0]] <= dp[1]):
                occ += 1
        return occ

    transitions: List[protocol.Transition] = []
    for r in ranks:
        i = rix[r]
        for pc, op in enumerate(progs[r]):
            name = f"r{r}.{op.render()}@{pc}"

            def guard(s, i=i, pc=pc, op=op):
                if s[-1] is not None or s[i] != pc:
                    return False
                if op.kind == "done":
                    sp = start_pos.get(op.arg)
                    return sp is not None and s[sp[0]] > sp[1]
                return True

            def apply(s, i=i, pc=pc, op=op, r=r):
                pcs = list(s[:-1])
                pcs[i] += 1
                viol = s[-1]
                if op.kind == "start":
                    t = sched.transfers[op.arg]
                    if t.via is not None \
                            and t.via not in stage_prefix[i][pc]:
                        viol = (f"fence: r{r} starts {t.tid} "
                                f"forwarding chunk {t.via} before its "
                                f"staged payload landed")
                    occ = occupancy(tuple(pcs), t.dst)
                    if viol is None and occ > sched.max_inflight:
                        viol = (f"buffer: {occ} outstanding transfers "
                                f"at r{t.dst} exceed the declared "
                                f"landing capacity "
                                f"{sched.max_inflight}")
                elif op.kind == "unstage":
                    if op.arg not in stage_prefix[i][pc]:
                        viol = (f"fence: r{r} unstages chunk {op.arg} "
                                f"before its staged payload landed")
                return tuple(pcs) + (viol,)

            transitions.append(protocol.Transition(name, guard, apply))

    ends = tuple(len(progs[r]) for r in ranks)

    def invariant(s) -> Optional[str]:
        return s[-1]

    def terminal_invariant(s) -> Optional[str]:
        if s[-1] is not None:
            return None  # the state invariant already fired
        if tuple(s[:-1]) == ends:
            return None
        blocked = {}
        for r in ranks:
            i = rix[r]
            if s[i] < len(progs[r]):
                op = progs[r][s[i]]
                why = ""
                if op.kind == "done":
                    sp = start_pos.get(op.arg)
                    why = (" (its start never executes)" if sp is None
                           else f" (waiting on r{ranks[sp[0]]} "
                                f"start@{sp[1]})")
                blocked[f"r{r}"] = op.render() + why
        return f"deadlock: no enabled transition, blocked at {blocked}"

    initial = tuple(0 for _ in ranks) + (None,)
    return protocol.Model(f"schedule:{sched.name}", initial,
                          transitions, invariant, terminal_invariant)


# --------------------------------------------------------------------------
# phase 3: deterministic host interpreter
# --------------------------------------------------------------------------

def make_input_blocks(sched: Schedule,
                      base: Optional[np.ndarray] = None
                      ) -> List[np.ndarray]:
    """Flattened per-source-rank in-blocks (canonical distinct-valued
    base array unless one is given)."""
    total = int(np.prod(sched.shape)) if sched.shape else 1
    if base is None:
        base = np.arange(total).astype(np_dtype(sched.dtype)
                                       ).reshape(sched.shape)
    base = np.asarray(base, dtype=np_dtype(sched.dtype)
                      ).reshape(sched.shape)
    flat = base.reshape(-1)
    return [flat[block_global_indices(sched.shape, sched.src_spec, s,
                                      sched.src_world)].copy()
            for s in range(sched.src_world)]


def expected_output_blocks(sched: Schedule,
                           base: Optional[np.ndarray] = None
                           ) -> List[np.ndarray]:
    total = int(np.prod(sched.shape)) if sched.shape else 1
    if base is None:
        base = np.arange(total).astype(np_dtype(sched.dtype)
                                       ).reshape(sched.shape)
    flat = np.asarray(base, dtype=np_dtype(sched.dtype)).reshape(-1)
    return [flat[block_global_indices(sched.shape, sched.dst_spec, d,
                                      sched.dst_world)].copy()
            for d in range(sched.dst_world)]


#: Schema of one measured schedule-execution op record.
#: Fingerprint-keyed so records from many runs of many schedules can be
#: pooled and still attributed; ``run`` disambiguates executions of the
#: SAME schedule (the critical-path extractor must not mix two runs).
SCHEDULE_EXEC_SCHEMA = "chainermn_tpu.schedule_exec.v1"

#: Per-process execution counter feeding ``run`` ids — deliberately NOT
#: wall-clock-derived, so a replayed fit is deterministic.
_EXEC_SEQ = itertools.count()


class ScheduleExecProfile:
    """Measured per-op records for executions of ONE schedule.

    :func:`run_schedule` calls :meth:`on_op` around every executed op;
    each record carries (op, arg, rank, link, bytes, wall_us, t_us)
    under ``SCHEDULE_EXEC_SCHEMA``, keyed by the schedule fingerprint
    and a per-execution ``run`` id.  ``link`` is the transfer's wire
    class for ``start``/``done`` and ``"copy"`` for local
    ``copy``/``unstage`` ops (they never touch a wire but DO consume
    the copy engine the cost model prices via ``copy_bw``).

    The profile is the truth side of the calibration loop: byte
    reconciliation against the IR's declared :meth:`Schedule.wire_bytes`
    is exact (a measured byte that the IR does not declare — or vice
    versa — is a profiler bug, not noise), while walls feed the
    least-squares (alpha, bw) fit in :mod:`.calibrate`.
    """

    def __init__(self, sched: Schedule, clock_ns=None):
        self.sched = sched
        self.schedule = sched.name
        self.kind = sched.kind
        self.fingerprint = sched.fingerprint()
        self.records: List[dict] = []
        self._clock = clock_ns or time.perf_counter_ns
        self._item = sched.itemsize
        self._t0: Optional[int] = None
        self._run_seq = None  # assigned lazily per begin()
        # (kind, arg) -> (link, bytes), precomputed so on_op stays a
        # single dict lookup — this runs inside reshard_host's
        # schedule interpreter and its cost is the profiler_overhead
        # the schedule_truth bench gates < 3%.
        self._info: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for tid, t in sched.transfers.items():
            nb = sched.chunks[t.chunk].nelems * self._item
            self._info[("start", tid)] = (t.link, nb)
            self._info[("done", tid)] = (t.link, nb)
        for cname, c in sched.chunks.items():
            nb = c.nelems * self._item
            self._info[("copy", cname)] = ("copy", nb)
            self._info[("unstage", cname)] = ("copy", nb)

    def now_ns(self) -> int:
        return self._clock()

    def begin(self) -> None:
        """Mark the start of one execution (a new ``run`` id); called
        automatically by :func:`run_schedule` so repeated executions
        through one profile stay distinguishable."""
        self._run_seq = f"{self.fingerprint}-{next(_EXEC_SEQ)}"
        self._t0 = None

    def on_op(self, op: Op, rank: int, t_beg_ns: int,
              t_end_ns: int) -> None:
        if self._run_seq is None:
            self.begin()
        if self._t0 is None:
            self._t0 = t_beg_ns
        link, nbytes = self._info[(op.kind, op.arg)]
        self.records.append({
            "schema": SCHEDULE_EXEC_SCHEMA,
            "fingerprint": self.fingerprint,
            "schedule": self.schedule,
            "sched_kind": self.kind,
            "run": self._run_seq,
            "seq": len(self.records),
            "op": op.kind,
            "arg": op.arg,
            "rank": int(rank),
            "link": link,
            "bytes": int(nbytes),
            "t_us": (t_beg_ns - self._t0) / 1e3,
            "wall_us": (t_end_ns - t_beg_ns) / 1e3,
        })

    # -- aggregation faces ----------------------------------------------

    def runs(self) -> List[str]:
        out: List[str] = []
        for rec in self.records:
            if not out or out[-1] != rec["run"]:
                out.append(rec["run"])
        return out

    def run_records(self, run: Optional[str] = None) -> List[dict]:
        runs = self.runs()
        if not runs:
            return []
        run = run or runs[-1]
        return [r for r in self.records if r["run"] == run]

    def wall_us(self, run: Optional[str] = None) -> float:
        recs = self.run_records(run)
        return max((r["t_us"] + r["wall_us"] for r in recs),
                   default=0.0)

    def measured_wire_bytes(self, run: Optional[str] = None
                            ) -> Dict[str, int]:
        """Bytes that crossed each wire in one run — summed over
        ``start`` records only (a transfer crosses its link once; its
        ``done`` is the landing copy)."""
        out = {"ici": 0, "dcn": 0}
        for r in self.run_records(run):
            if r["op"] == "start" and r["link"] in out:
                out[r["link"]] += r["bytes"]
        return out

    def reconcile(self, run: Optional[str] = None) -> List[str]:
        """Exact byte reconciliation of one run against the IR: summed
        measured transfer bytes must EQUAL the schedule's declared
        :meth:`Schedule.wire_bytes` per link, and every started
        transfer must have exactly one measured ``done``."""
        v: List[str] = []
        declared = self.sched.wire_bytes()
        measured = self.measured_wire_bytes(run)
        for link in sorted(declared):
            if measured.get(link, 0) != declared[link]:
                v.append(
                    f"reconcile: {link} measured {measured.get(link, 0)}"
                    f" B != declared {declared[link]} B")
        starts: Dict[str, int] = {}
        dones: Dict[str, int] = {}
        for r in self.run_records(run):
            if r["op"] == "start":
                starts[r["arg"]] = starts.get(r["arg"], 0) + 1
            elif r["op"] == "done":
                dones[r["arg"]] = dones.get(r["arg"], 0) + 1
        if starts != dones:
            odd = {t for t in set(starts) | set(dones)
                   if starts.get(t, 0) != dones.get(t, 0)}
            v.append(f"reconcile: start/done counts differ for "
                     f"{sorted(odd)}")
        return v


def execute_profiled(sched: Schedule,
                     in_blocks: Optional[Sequence[np.ndarray]] = None,
                     reps: int = 1
                     ) -> Tuple[List[np.ndarray], ScheduleExecProfile]:
    """Run a verified schedule ``reps`` times under a fresh profiler
    and return (last outputs, profile) — the bench/`--measure` face."""
    prof = ScheduleExecProfile(sched)
    ins = in_blocks if in_blocks is not None else make_input_blocks(sched)
    outs: List[np.ndarray] = []
    for _ in range(max(1, int(reps))):
        outs = run_schedule(sched, ins, profiler=prof)
    return outs, prof


def run_schedule(sched: Schedule, in_blocks: Sequence[np.ndarray],
                 profiler: Optional[ScheduleExecProfile] = None
                 ) -> List[np.ndarray]:
    """Execute a VERIFIED schedule on host buffers.  Deterministic
    round-robin over ranks; each rank runs its program in order, a
    ``done`` blocking until the matching ``start`` has produced the
    payload.  Byte-exactness vs the direct path is part of
    :func:`verify_schedule`, so callers may swap schedules freely.

    With a ``profiler`` every op is timed and recorded
    (``SCHEDULE_EXEC_SCHEMA``); without one the only added cost is a
    predicted-taken branch per op — the zero-overhead-off discipline
    the journal set."""
    if len(in_blocks) != sched.src_world:
        raise ValueError(f"need {sched.src_world} in-blocks, got "
                         f"{len(in_blocks)}")
    item_dtype = np_dtype(sched.dtype)
    ins = [np.asarray(b).reshape(-1) for b in in_blocks]
    outs = [np.empty(_block_elems(sched, sched.dst_spec, d,
                                  sched.dst_world), dtype=item_dtype)
            for d in range(sched.dst_world)]
    stage: Dict[Tuple[int, str], np.ndarray] = {}
    wire: Dict[str, np.ndarray] = {}
    pcs = {r: 0 for r in sched.programs}
    if profiler is not None:
        profiler.begin()

    def gather(c: Chunk, src_buf: np.ndarray) -> np.ndarray:
        return np.concatenate([src_buf[so:so + n]
                               for so, _, n in c.segments]) \
            if len(c.segments) != 1 else \
            src_buf[c.segments[0][0]:c.segments[0][0]
                    + c.segments[0][2]].copy()

    def scatter(c: Chunk, payload: np.ndarray, out: np.ndarray):
        off = 0
        for _, do, n in c.segments:
            out[do:do + n] = payload[off:off + n]
            off += n

    def ready(r: int, op: Op) -> bool:
        if op.kind == "done":
            return op.arg in wire
        if op.kind == "unstage":
            return (r, op.arg) in stage
        if op.kind == "start":
            t = sched.transfers[op.arg]
            return t.via is None or (r, t.via) in stage
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
                t_beg = profiler.now_ns() if profiler is not None else 0
                if op.kind == "copy":
                    c = sched.chunks[op.arg]
                    scatter(c, gather(c, ins[r]), outs[r])
                elif op.kind == "unstage":
                    c = sched.chunks[op.arg]
                    scatter(c, stage[(r, op.arg)], outs[r])
                elif op.kind == "start":
                    t = sched.transfers[op.arg]
                    c = sched.chunks[t.chunk]
                    payload = (stage[(r, t.via)]
                               if t.via is not None
                               else gather(c, ins[r]))
                    wire[t.tid] = payload
                elif op.kind == "done":
                    t = sched.transfers[op.arg]
                    payload = wire.pop(t.tid)
                    if t.dest == "stage":
                        stage[(r, t.chunk)] = payload
                    else:
                        scatter(sched.chunks[t.chunk], payload,
                                outs[r])
                else:
                    raise NotImplementedError(
                        f"interpreter: op kind {op.kind!r} reserved")
                if profiler is not None:
                    profiler.on_op(op, r, t_beg, profiler.now_ns())
    stuck = {r: sched.programs[r][pcs[r]].render()
             for r in pcs if pcs[r] < len(sched.programs[r])}
    if stuck:
        raise RuntimeError(f"run_schedule: schedule {sched.name} "
                           f"deadlocked at {stuck} — it was not "
                           f"verified")
    return outs


# --------------------------------------------------------------------------
# the verifier
# --------------------------------------------------------------------------

@dataclass
class VerifyResult:
    ok: bool
    schedule: str
    kind: str
    violations: List[str] = field(default_factory=list)
    #: minimal counterexample trace from the model check (rendered
    #: transition names), empty when the machine is clean.
    counterexample: List[str] = field(default_factory=list)
    n_states: int = 0
    complete: bool = True
    phases: Dict[str, str] = field(default_factory=dict)

    def render(self) -> str:
        head = (f"{self.schedule}: "
                + ("OK" if self.ok else "VIOLATION")
                + f" ({self.n_states} states"
                + ("" if self.complete else ", TRUNCATED")
                + "; " + ", ".join(f"{k}={v}" for k, v in
                                   sorted(self.phases.items()))
                + ")")
        lines = [head]
        for v in self.violations:
            lines.append(f"  - {v}")
        if self.counterexample:
            lines.append("  counterexample (minimal):")
            for i, t in enumerate(self.counterexample, 1):
                lines.append(f"    {i:2d}. {t}")
        return "\n".join(lines)


def verify_schedule(sched: Schedule, max_states: int = 500_000
                    ) -> VerifyResult:
    """Run all three proofs.  The interpreter only runs once structure,
    coverage, and the model check are clean (executing an unverified
    schedule, even on host buffers, is the thing this module exists to
    prevent)."""
    res = VerifyResult(True, sched.name, sched.kind)
    sv = structural_check(sched)
    res.phases["structural"] = "ok" if not sv else "violated"
    res.violations += sv
    if not sv:
        cv = coverage_check(sched)
        res.phases["coverage"] = "ok" if not cv else "violated"
        res.violations += cv
    else:
        res.phases["coverage"] = "skipped"
    model = make_schedule_model(sched)
    cr = protocol.check(model, max_states=max_states)
    res.n_states = cr.n_states
    res.complete = cr.complete
    if not cr.ok:
        res.phases["model"] = "violated"
        res.violations.append(f"model: {cr.violation}")
        res.counterexample = [t for t, _ in cr.counterexample]
    elif not cr.complete:
        res.phases["model"] = "truncated"
        res.violations.append(
            f"model: state space truncated at {cr.n_states} states — "
            f"not exhaustively verified (raise max_states or shrink "
            f"the schedule)")
    else:
        res.phases["model"] = "ok"
    if not res.violations:
        try:
            got = run_schedule(sched, make_input_blocks(sched))
            want = expected_output_blocks(sched)
            bad = [d for d in range(sched.dst_world)
                   if not np.array_equal(got[d], want[d])]
            if bad:
                res.violations.append(
                    f"interpreter: output differs from the statics "
                    f"oracle at dst rank(s) {bad}")
                res.phases["interpreter"] = "violated"
            else:
                res.phases["interpreter"] = "ok"
        except Exception as e:  # pragma: no cover - belt
            res.violations.append(f"interpreter: crashed: {e!r}")
            res.phases["interpreter"] = "crashed"
    else:
        res.phases["interpreter"] = "skipped"
    res.ok = not res.violations
    return res


# --------------------------------------------------------------------------
# seeded faults — the 0 FN / 0 FP corpus generators
# --------------------------------------------------------------------------

def _clone(sched: Schedule, suffix: str) -> Schedule:
    out = copy.deepcopy(sched)
    out.name = f"{sched.name}+{suffix}"
    return out


def _out_transfers(sched: Schedule) -> List[Transfer]:
    return [sched.transfers[tid] for tid in sorted(sched.transfers)
            if sched.transfers[tid].dest == "out"]


def seed_fault(sched: Schedule, fault: str) -> Schedule:
    """A deterministically broken copy of ``sched``.  Each fault class
    maps to the verifier phase that must catch it:

    - ``dropped_chunk``   -> coverage gap
    - ``double_write``    -> coverage multiplicity
    - ``send_recv_cycle`` -> model deadlock
    - ``done_before_start`` -> model fence violation (needs a staged
      hop, i.e. a hierarchical schedule)
    - ``buffer_overrun``  -> model buffer-bound violation
    """
    out = _clone(sched, fault)
    if fault == "dropped_chunk":
        cands = _out_transfers(out) or None
        if cands:
            t = cands[-1]
            del out.transfers[t.tid]
            del out.chunks[t.chunk]
            for r in out.programs:
                out.programs[r] = [
                    op for op in out.programs[r]
                    if not (op.kind in ("start", "done")
                            and op.arg == t.tid)]
        else:
            for r in sorted(out.programs):
                copies = [op for op in out.programs[r]
                          if op.kind == "copy"]
                if copies:
                    out.programs[r].remove(copies[-1])
                    break
        return out
    if fault == "double_write":
        cands = _out_transfers(out)
        if cands:
            t = cands[0]
            c = out.chunks[t.chunk]
            c2 = Chunk(c.name + "_dup", c.src_rank, c.dst_rank,
                       c.segments)
            out.chunks[c2.name] = c2
            t2 = Transfer(t.tid + "_dup", c2.name, t.src, t.dst,
                          t.dest, t.link, t.via)
            out.transfers[t2.tid] = t2
            out.programs[t.src].append(Op("start", t2.tid))
            out.programs[t.dst].append(Op("done", t2.tid))
            out.max_inflight += 1  # keep the buffer bound honest
        else:
            for r in sorted(out.programs):
                copies = [op for op in out.programs[r]
                          if op.kind == "copy"]
                if copies:
                    out.programs[r].append(copies[0])
                    break
        return out
    if fault == "send_recv_cycle":
        pair = None
        for t1 in _out_transfers(out):
            for t2 in _out_transfers(out):
                if t1.src == t2.dst and t1.dst == t2.src \
                        and t1.via is None and t2.via is None:
                    pair = (t1, t2)
                    break
            if pair:
                break
        if pair is None:
            raise ValueError(
                f"{sched.name}: no reciprocal transfer pair to build "
                f"a send/recv cycle from")
        t1, t2 = pair

        def reorder(r, first_tid, then_tid):
            prog = [op for op in out.programs[r]
                    if not (op.kind == "done" and op.arg == first_tid)]
            i = next(j for j, op in enumerate(prog)
                     if op.kind == "start" and op.arg == then_tid)
            prog.insert(i, Op("done", first_tid))
            out.programs[r] = prog

        # t1: a->b, t2: b->a.  a now awaits t2 before sending t1, and
        # b awaits t1 before sending t2 — the classic rendezvous cycle.
        reorder(t1.src, t2.tid, t1.tid)
        reorder(t2.src, t1.tid, t2.tid)
        return out
    if fault == "done_before_start":
        for r in sorted(out.programs):
            prog = out.programs[r]
            for i, op in enumerate(prog):
                if op.kind != "start":
                    continue
                t = out.transfers[op.arg]
                if t.via is None:
                    continue
                lands = [j for j, o in enumerate(prog) if j < i
                         and o.kind == "done"
                         and out.transfers[o.arg].chunk == t.via
                         and out.transfers[o.arg].dest == "stage"]
                if not lands:
                    continue
                j = lands[-1]
                prog[i], prog[j] = prog[j], prog[i]
                return out
        raise ValueError(
            f"{sched.name}: no staged forwarding hop to misorder "
            f"(use a hierarchical schedule)")
    if fault == "buffer_overrun":
        if sched.max_inflight <= 1:
            raise ValueError(f"{sched.name}: declared capacity is "
                             f"already 1")
        out.max_inflight = sched.max_inflight - 1
        return out
    raise KeyError(f"unknown fault {fault!r}; have {SEEDED_FAULTS}")


SEEDED_FAULTS = ("dropped_chunk", "double_write", "send_recv_cycle",
                 "done_before_start", "buffer_overrun")


# --------------------------------------------------------------------------
# verified compilation + the fleet-reachable pair matrix
# --------------------------------------------------------------------------

_COMPILE_CACHE: Dict[tuple, Tuple[Schedule, dict]] = {}


def _calibration_key(calibration: Optional[dict]) -> Optional[str]:
    """Stable identity of a calibration artifact for the compile cache
    (two fits with identical constants share an entry; a re-fit with
    new measurements invalidates)."""
    if not calibration:
        return None
    import hashlib
    blob = json.dumps(calibration, sort_keys=True,
                      separators=(",", ":"), default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def compile_verified(shape, dtype, src_spec, dst_spec, src_world,
                     dst_world, topology: Optional[Topology] = None,
                     n_chunks: int = 2, depth: int = 2,
                     cost_model: Optional[CostModel] = None,
                     calibration: Optional[dict] = None,
                     max_states: int = 500_000
                     ) -> Tuple[Schedule, dict]:
    """Generate candidates, verify every one, and return the cheapest
    VERIFIED schedule plus its price row (with the baseline cost and
    per-candidate table attached).  Results are cached per geometry —
    the ``make_reshard``-style compile-once contract.

    With ``calibration`` (a loaded ``chainermn_tpu.calibration.v1``
    artifact) candidates rank by MEASURED per-link constants instead of
    the stock r04 assumptions; the calibration's identity participates
    in the cache key so a re-fit re-ranks."""
    key = (tuple(shape), str(dtype), src_spec, dst_spec,
           int(src_world), int(dst_world),
           (topology.slices, topology.per_slice) if topology else None,
           int(n_chunks), int(depth), _calibration_key(calibration))
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        return hit
    cands = candidate_schedules(shape, dtype, src_spec, dst_spec,
                                src_world, dst_world, topology,
                                n_chunks=n_chunks, depth=depth)
    rows = []
    best = None
    for sc in cands:
        vr = verify_schedule(sc, max_states=max_states)
        if not vr.ok:
            raise RuntimeError(
                f"generator emitted an unverifiable schedule:\n"
                f"{vr.render()}")
        row = price_schedule(sc, cost_model, calibration=calibration)
        row["n_states"] = vr.n_states
        rows.append(row)
        if best is None or row["cost_ms"] < best[1]["cost_ms"]:
            best = (sc, row)
    sched, row = best
    report = dict(row)
    report["baseline_cost_ms"] = rows[0]["cost_ms"]
    report["speedup_vs_single"] = (
        rows[0]["cost_ms"] / row["cost_ms"] if row["cost_ms"] else 1.0)
    report["candidates"] = rows
    _COMPILE_CACHE[key] = (sched, report)
    return sched, report


def verified_schedule(kind: str, shape, dtype, src_spec, dst_spec,
                      src_world, dst_world,
                      topology: Optional[Topology] = None,
                      n_chunks: int = 2, depth: int = 2,
                      max_states: int = 500_000) -> Schedule:
    """One named generator's schedule, verified and cached — or the
    cheapest verified candidate for ``kind="auto"``.  Raises if the
    schedule does not pass the verifier (nothing unverified escapes)."""
    if kind == "auto":
        return compile_verified(shape, dtype, src_spec, dst_spec,
                                src_world, dst_world, topology,
                                n_chunks=n_chunks, depth=depth,
                                max_states=max_states)[0]
    from .schedule import GENERATORS
    gen = GENERATORS.get(kind)
    if gen is None:
        raise KeyError(f"unknown schedule kind {kind!r}; have "
                       f"{sorted(GENERATORS)} or 'auto'")
    key = ("one", kind, tuple(shape), str(dtype), src_spec, dst_spec,
           int(src_world), int(dst_world),
           (topology.slices, topology.per_slice) if topology else None,
           int(n_chunks), int(depth))
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        return hit[0]
    kw = {} if kind == "single" else (
        {"n_chunks": n_chunks} if kind != "pipelined"
        else {"n_chunks": n_chunks, "depth": depth})
    if kind == "hierarchical":
        world = max(int(src_world), int(dst_world))
        topology = topology or Topology.flat(world)
        sched = gen(shape, dtype, src_spec, dst_spec, src_world,
                    dst_world, topology, **kw)
    else:
        sched = gen(shape, dtype, src_spec, dst_spec, src_world,
                    dst_world, topology, **kw)
    vr = verify_schedule(sched, max_states=max_states)
    if not vr.ok:
        raise RuntimeError(f"schedule failed verification:\n"
                           f"{vr.render()}")
    _COMPILE_CACHE[key] = (sched, {})
    return sched


#: Every (src,dst) spec pair the fleet actually lowers through
#: ``reshard_host``: elastic resume re-folds a checkpoint across a
#: world change in either direction, ``heal()`` live-shrinks the gang
#: by one rank, and ``rolling_upgrade()`` gathers a sharded checkpoint
#: into full replicated params for each replacement worker (the
#: fan-out row is the whole-fleet upgrade, the ICI+DCN pair where
#: hierarchical staging wins).
FLEET_PAIRS: Tuple[Tuple[str, Optional[int], Optional[int], int, int],
                   ...] = (
    ("elastic_resume_shrink_repl", None, None, 4, 2),
    ("elastic_resume_shrink_sharded", 0, 0, 4, 2),
    ("elastic_resume_grow_sharded", 0, 0, 2, 4),
    ("live_shrink_repl", None, None, 4, 3),
    ("live_shrink_sharded", 0, 0, 4, 3),
    ("rolling_upgrade_gather", 0, None, 2, 1),
    ("rolling_upgrade_repl", None, None, 2, 1),
    ("rolling_upgrade_fanout", 0, None, 4, 4),
)


def fleet_pair_topology(src_world: int, dst_world: int) -> Topology:
    """The wire each fleet pair actually crosses: 4-rank worlds are a
    2-host × 2-chip gang (ICI inside a host, DCN across), 2-rank
    worlds are one chip per host (pure DCN), odd worlds are flat."""
    world = max(int(src_world), int(dst_world))
    if world % 2 == 0 and world >= 4:
        return Topology(2, world // 2)
    if world == 2:
        return Topology(2, 1)
    return Topology.flat(world)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis.schedule_check",
        description="verify collective schedules (exit 0 clean / 1 "
                    "violations / 2 unusable)")
    p.add_argument("schedules", nargs="*",
                   help="schedule JSON artifacts to verify; default = "
                        "the fleet-reachable pair matrix")
    p.add_argument("--shape", default="24,4",
                   help="array shape for the pair matrix")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--chunks", type=int, default=2)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--max-states", type=int, default=500_000)
    p.add_argument("--json", action="store_true",
                   help="emit a machine-readable report")
    args = p.parse_args(argv)

    rows = []
    worst = 0
    try:
        if args.schedules:
            for path in args.schedules:
                with open(path) as f:
                    sched = Schedule.from_json(json.load(f))
                vr = verify_schedule(sched,
                                     max_states=args.max_states)
                rows.append({"pair": path, "ok": vr.ok,
                             "report": vr.render()})
                worst = max(worst, 0 if vr.ok else 1)
        else:
            shape = tuple(int(x) for x in args.shape.split(","))
            for name, src, dst, sw, dw in FLEET_PAIRS:
                sched, report = compile_verified(
                    shape, args.dtype, src, dst, sw, dw,
                    fleet_pair_topology(sw, dw),
                    n_chunks=args.chunks, depth=args.depth,
                    max_states=args.max_states)
                rows.append({
                    "pair": name, "ok": True,
                    "chosen": sched.kind,
                    "cost_ms": report["cost_ms"],
                    "speedup_vs_single": report["speedup_vs_single"],
                    "report": f"{name}: OK chosen={sched.kind} "
                              f"cost={report['cost_ms']:.4f}ms "
                              f"speedup={report['speedup_vs_single']:.2f}x",
                })
    except RuntimeError as e:
        print(f"schedule-check: VIOLATION\n{e}", file=sys.stderr)
        return 1
    except Exception as e:  # unusable, not a finding
        print(f"schedule-check: unusable: {e!r}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"rows": rows, "ok": worst == 0}, indent=2,
                         sort_keys=True))
    else:
        for r in rows:
            print(r["report"])
        n_bad = sum(0 if r["ok"] else 1 for r in rows)
        print(f"schedule-check: {len(rows)} schedule(s), "
              f"{n_bad} violating")
    return worst


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
