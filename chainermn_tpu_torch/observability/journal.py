"""Causal fleet journal: one HLC-ordered happens-before timeline.

Counterpart of ``chainermn_tpu/observability/journal.py`` (a copy: the
JAX module is stdlib-only, and the port keeps its own).  The flight ring,
the tracer and the comm ledger are per-process; this journal gives the
cross-process fleet one timeline through a hybrid logical clock (HLC):

* **HLC stamp**: ``(l, c)``, ``l`` the largest physical clock
  (microseconds) this process has seen (its own or a peer's, through a
  received message) and ``c`` a logical counter breaking ties.  A local
  event ticks; a receive merges the sender's stamp, so every send and
  its receive are ordered ``stamp(send) < stamp(recv)`` however skewed
  the wall clocks are.  The stamp rides as one extra field (``hlc``) in
  the ``worker_lane.v1`` mailbox dicts and the lease payloads.

* **Per-process journal** (:class:`Journal`): a bounded, line-buffered
  ``journal.<proc>.jsonl``.  Every distributed state transition already
  noted in the flight ring (fleet dispatch / failover / shed, beats,
  fences, cache pulls, the slot allocator; through the
  :func:`~.flight.note` tee) and the wire events (mailbox send / receive,
  lease judged) get one ``journal.v1`` line with its HLC stamp.
  Line-buffered appends keep every line a SIGKILLed process wrote.

* **Merge** (:func:`merge_journals`): N per-process journals folded into
  one total order by ``(l, c, proc, seq)``, consistent with every
  process's program order and every send / receive edge.
  :func:`happens_before_edges` extracts the explicit cross-process edges
  (mailbox and lease sequence pairs), :func:`request_story` and
  :func:`request_critical_path` one request's chain, and
  :func:`export_perfetto` renders the merged timeline as one Perfetto
  lane per process.

Everything is a no-op until :func:`configure` runs (``wire_emit`` returns
None, so senders add the ``hlc`` field only when journaling is on).
Stdlib only.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Schema stamp carried by every journal line.
JOURNAL_SCHEMA = "chainermn_tpu.journal.v1"

#: Schema of the merged fleet timeline document.
MERGE_SCHEMA = "chainermn_tpu.journal_merge.v1"

#: Env var pair that configures the journal in spawned workers (the
#: ``--journal-dir`` CLI flag sets them for its own process instead).
ENV_DIR = "CHAINERMN_JOURNAL_DIR"
ENV_PROC = "CHAINERMN_JOURNAL_PROC"

#: Flight-note kinds NOT teed into the journal: tracer span/instant
#: tees are per-process latency detail, not distributed state.
_TEE_EXCLUDE = ("span", "instant")


class HLC:
    """Hybrid logical clock: ``(l, c)`` with physical microseconds in
    ``l``.  Thread-safe; both faces strictly increase the local stamp,
    so one process's journal is totally ordered by its own stamps."""

    def __init__(self, now_us: Optional[Callable[[], int]] = None):
        self._now_us = now_us or (lambda: int(time.time() * 1e6))
        self._l = 0
        self._c = 0
        self._lock = threading.Lock()

    def tick(self) -> Tuple[int, int]:
        """Stamp a local event (send included)."""
        pt = self._now_us()
        with self._lock:
            if pt > self._l:
                self._l, self._c = pt, 0
            else:
                self._c += 1
            return self._l, self._c

    def merge(self, remote: Optional[Sequence[int]]) -> Tuple[int, int]:
        """Stamp a receive event, folding in the sender's stamp so the
        receive orders strictly after the send."""
        if not remote:
            return self.tick()
        rl, rc = int(remote[0]), int(remote[1])
        pt = self._now_us()
        with self._lock:
            if pt > self._l and pt > rl:
                self._l, self._c = pt, 0
            elif rl > self._l:
                self._l, self._c = rl, rc + 1
            elif self._l > rl:
                self._c += 1
            else:
                self._c = max(self._c, rc) + 1
            return self._l, self._c

    def read(self) -> Tuple[int, int]:
        with self._lock:
            return self._l, self._c


class Journal:
    """Bounded per-process HLC journal file (``journal.<proc>.jsonl``).

    ``capacity`` bounds the RETAINED line count: the file grows to
    ``2*capacity`` lines, then compacts (atomically, tmp + replace) to
    the newest ``capacity`` — amortized O(1) per event, and a reader
    always sees a complete file.  Writes are line-buffered so a killed
    process keeps everything it journaled (the chaos-evidence
    contract the flight ring already honors).
    """

    DEFAULT_CAPACITY = 20000

    def __init__(self, path: str, proc: str,
                 capacity: int = DEFAULT_CAPACITY):
        self.path = str(path)
        self.proc = str(proc)
        self.capacity = int(capacity)
        self.hlc = HLC()
        self._lock = threading.Lock()
        self._seq = 0
        self._lines = 0
        self.dropped = 0
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    # ---- emit faces ----
    def emit(self, kind: str,
             _stamp: Optional[Tuple[int, int]] = None,
             **fields) -> Tuple[int, int]:
        """Journal one local event; returns its HLC stamp."""
        stamp = _stamp if _stamp is not None else self.hlc.tick()
        self._write(kind, stamp, fields)
        return stamp

    def wire_emit(self, kind: str, **fields) -> List[int]:
        """Journal a SEND event and return the stamp for the wire (the
        message's ``hlc`` field must be the send event's own stamp)."""
        stamp = self.hlc.tick()
        self._write(kind, stamp, fields)
        return [stamp[0], stamp[1]]

    def recv_emit(self, remote: Optional[Sequence[int]], kind: str,
                  **fields) -> Tuple[int, int]:
        """Journal a RECEIVE event, merging the sender's wire stamp."""
        stamp = self.hlc.merge(remote)
        self._write(kind, stamp, fields)
        return stamp

    def _write(self, kind: str, stamp: Tuple[int, int],
               fields: Dict[str, Any]) -> None:
        ev = {"schema": JOURNAL_SCHEMA, "proc": self.proc,
              "kind": str(kind), "hlc": [stamp[0], stamp[1]],
              "t": round(time.time(), 6)}
        for k, v in fields.items():
            if k not in ev:
                ev[k] = v
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            try:
                self._f.write(json.dumps(ev, default=str,
                                         sort_keys=True) + "\n")
            except ValueError:
                return   # closed mid-teardown: never raise on emit
            self._lines += 1
            if self._lines > 2 * self.capacity:
                n = self._compact()
                if n is not None:
                    self._lines = n

    def _compact(self) -> Optional[int]:
        """Rewrite the file to its newest ``capacity`` lines and return
        the new line count, or None if compaction failed (caller holds
        the lock and owns ``_lines``)."""
        try:
            self._f.flush()
            with open(self.path) as f:
                lines = f.readlines()
            keep = lines[-self.capacity:]
            self.dropped += max(len(lines) - len(keep), 0)
            tmp = f"{self.path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.writelines(keep)
            os.replace(tmp, self.path)
            self._f.close()
            self._f = open(self.path, "a", buffering=1)
            return len(keep)
        except OSError:
            return None   # compaction is best-effort; emission survives

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# module-global journal (mirrors the flight module's global-ring shape)
# ---------------------------------------------------------------------------

_JOURNAL: Optional[Journal] = None


def journal_path(journal_dir: str, proc: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in str(proc)) or "proc"
    return os.path.join(journal_dir, f"journal.{safe}.jsonl")


def configure(journal_dir: str, proc: str,
              capacity: int = Journal.DEFAULT_CAPACITY) -> Journal:
    """Open this process's journal and tee flight notes into it.
    Idempotent per (dir, proc); reconfiguring closes the old file."""
    global _JOURNAL
    if (_JOURNAL is not None and _JOURNAL.proc == str(proc)
            and os.path.dirname(_JOURNAL.path)
            == os.path.abspath(journal_dir)):
        return _JOURNAL
    if _JOURNAL is not None:
        _JOURNAL.close()
    _JOURNAL = Journal(journal_path(os.path.abspath(journal_dir), proc),
                       proc, capacity)
    from . import flight as _flight
    _flight.set_journal_tee(_tee)
    return _JOURNAL


def configure_from_env() -> Optional[Journal]:
    """Configure from ``CHAINERMN_JOURNAL_DIR``/``_PROC`` when set (the
    spawned-worker path: the fleet passes them via the environment)."""
    d = os.environ.get(ENV_DIR)
    if not d:
        return None
    proc = os.environ.get(ENV_PROC) or f"pid{os.getpid()}"
    return configure(d, proc)


def reset() -> None:
    """Close and detach the global journal (tests)."""
    global _JOURNAL
    if _JOURNAL is not None:
        _JOURNAL.close()
        _JOURNAL = None
    from . import flight as _flight
    _flight.set_journal_tee(None)


def get_journal() -> Optional[Journal]:
    return _JOURNAL


def enabled() -> bool:
    return _JOURNAL is not None


def emit(kind: str, **fields) -> None:
    j = _JOURNAL
    if j is not None:
        j.emit(kind, **fields)


def wire_emit(kind: str, **fields) -> Optional[List[int]]:
    """Journal a send event; returns the wire stamp, or None when the
    journal is off (senders add the ``hlc`` field only when not None —
    the zero-overhead-off contract)."""
    j = _JOURNAL
    if j is None:
        return None
    return j.wire_emit(kind, **fields)


def recv_emit(remote: Optional[Sequence[int]], kind: str,
              **fields) -> None:
    j = _JOURNAL
    if j is not None:
        j.recv_emit(remote, kind, **fields)


def _tee(kind: str, fields: Dict[str, Any]) -> None:
    """The flight-note tee: every distributed state transition already
    noted into the ring lands in the journal too (minus tracer noise)."""
    j = _JOURNAL
    if j is None or kind in _TEE_EXCLUDE:
        return
    try:
        j.emit(kind, **fields)
    except Exception:   # noqa: BLE001 — a journal fault must never
        pass            # break the emitter's hot path


# ---------------------------------------------------------------------------
# merge: N per-process journals -> one happens-before timeline
# ---------------------------------------------------------------------------

def sort_key(ev: Dict[str, Any]) -> Tuple[int, int, str, int]:
    """The merged total order: HLC first (captures happens-before),
    then (proc, seq) as a deterministic tie-break for concurrency."""
    hlc = ev.get("hlc") or [0, 0]
    return (int(hlc[0]), int(hlc[1]), str(ev.get("proc")),
            int(ev.get("seq", 0)))


def read_journal(path: str) -> List[Dict[str, Any]]:
    """One journal file's events (schema-checked; torn tail lines from
    a mid-write kill are skipped, foreign schemas are refused)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue   # torn tail: the writer died mid-line
            if ev.get("schema") != JOURNAL_SCHEMA:
                raise ValueError(
                    f"refusing journal line with schema "
                    f"{ev.get('schema')!r} in {path!r} (this reader "
                    f"speaks {JOURNAL_SCHEMA})")
            out.append(ev)
    return out


def find_journals(journal_dir: str) -> List[str]:
    return sorted(_glob.glob(os.path.join(str(journal_dir),
                                          "journal.*.jsonl")))


def merge_journals(journal_dir_or_paths,
                   out_path: Optional[str] = None) -> Dict[str, Any]:
    """Fold per-process journals into ONE totally-ordered fleet
    timeline.

    Returns ``{"schema", "procs", "events", "edges"}`` where ``events``
    is every journal line sorted by :func:`sort_key` (happens-before
    consistent: per-process stamps strictly increase, and a receive's
    merged stamp exceeds its send's) and ``edges`` the explicit
    cross-process send→receive pairs from
    :func:`happens_before_edges`.  Also written to ``out_path``
    (atomically) when given.
    """
    if isinstance(journal_dir_or_paths, (str, os.PathLike)):
        paths = find_journals(str(journal_dir_or_paths))
    else:
        paths = [str(p) for p in journal_dir_or_paths]
    events: List[Dict[str, Any]] = []
    procs: List[str] = []
    for p in paths:
        try:
            evs = read_journal(p)
        except OSError:
            continue
        events.extend(evs)
        for ev in evs:
            if ev.get("proc") not in procs:
                procs.append(ev["proc"])
    events.sort(key=sort_key)
    for i, ev in enumerate(events):
        ev["idx"] = i
    doc = {"schema": MERGE_SCHEMA, "procs": sorted(procs),
           "events": events,
           "edges": happens_before_edges(events)}
    if out_path:
        tmp = f"{out_path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, out_path)
    return doc


def happens_before_edges(events: Sequence[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Explicit cross-process happens-before edges in a merged event
    list: mailbox ``mbx_send → mbx_recv`` pairs (matched on
    ``(mailbox, mseq)``) and lease ``beat → lease_judged`` pairs
    (matched on ``(worker, lseq)``).  Each edge is ``{"kind", "src",
    "dst"}`` with ``src``/``dst`` the event indices."""
    edges: List[Dict[str, Any]] = []
    sends: Dict[Tuple[str, int], int] = {}
    beats: Dict[Tuple[str, int], int] = {}
    for i, ev in enumerate(events):
        kind = ev.get("kind")
        if kind == "mbx_send":
            sends[(str(ev.get("mailbox")), int(ev.get("mseq", -1)))] = i
        elif kind == "mbx_recv":
            src = sends.get((str(ev.get("mailbox")),
                             int(ev.get("mseq", -1))))
            if src is not None:
                edges.append({"kind": "mailbox", "src": src, "dst": i})
        elif kind == "beat":
            beats[(str(ev.get("worker")), int(ev.get("lseq", -1)))] = i
        elif kind == "lease_judged":
            src = beats.get((str(ev.get("worker")),
                             int(ev.get("lseq", -1))))
            if src is not None:
                edges.append({"kind": "lease", "src": src, "dst": i})
    return edges


def format_event(ev: Dict[str, Any]) -> str:
    """One human line of a journal event (causal chains, --request)."""
    hlc = ev.get("hlc") or [0, 0]
    skip = {"schema", "proc", "kind", "hlc", "t", "seq", "idx"}
    detail = " ".join(
        f"{k}={ev[k]}" for k in sorted(ev) if k not in skip)
    return (f"hlc=({hlc[0]},{hlc[1]}) proc={ev.get('proc')} "
            f"{ev.get('kind')}" + (f" {detail}" if detail else ""))


# ---------------------------------------------------------------------------
# one request's cross-process causal story (explain_bundle --request)
# ---------------------------------------------------------------------------

def request_story(merged: Dict[str, Any],
                  trace_id: str) -> Dict[str, Any]:
    """Every journaled event of ONE request, in happens-before order,
    with the cross-process edges that connect them: submit → dispatch
    → [pull] → prefill → ticks → done/shed, failover hops included.
    The ``--request`` face of ``scripts/explain_bundle.py``."""
    evs = [e for e in merged.get("events", [])
           if e.get("trace_id") == trace_id]
    idxs = {e.get("idx") for e in evs}
    edges = [ed for ed in merged.get("edges", [])
             if ed.get("src") in idxs and ed.get("dst") in idxs]
    procs: List[str] = []
    for e in evs:
        if e.get("proc") not in procs:
            procs.append(e["proc"])
    outcome = None
    failovers = 0
    pulls = 0
    workers: List[str] = []
    for e in evs:
        if e.get("kind") != "fleet":
            continue
        event = e.get("event")
        if event in ("submitted", "dispatched", "redispatched"):
            w = e.get("to") if event == "redispatched" else e.get("worker")
            if w and w not in workers:
                workers.append(w)
        if event == "redispatched":
            failovers += 1
        elif str(event or "").startswith("remote_pull"):
            pulls += 1
        elif event == "finished":
            outcome = {"kind": "done", "worker": e.get("worker"),
                       "reason": e.get("reason")}
        elif event == "shed":
            outcome = {"kind": "shed"}
    return {"trace_id": trace_id, "events": evs, "edges": edges,
            "procs": procs, "workers": workers, "outcome": outcome,
            "failovers": failovers, "remote_pull_events": pulls}


def _event_label(e: Dict[str, Any]) -> str:
    kind = str(e.get("kind"))
    sub = e.get("event")
    return f"{kind}:{sub}" if sub else kind


def request_critical_path(merged: Dict[str, Any],
                          trace_id: str) -> Dict[str, Any]:
    """The longest chain of one served request: walk the
    request's journaled events in happens-before order and attribute
    the wall between each consecutive pair to a named SEGMENT
    (``fleet:submitted -> fleet:dispatched`` is queueing,
    ``fleet:dispatched -> fleet:prefill_done`` is prefill, and so on).
    A request's events form one causal chain (failover hops included),
    so the HLC-ordered walk IS the critical path; the dominant segment
    names where this request's latency actually went."""
    story = request_story(merged, trace_id)
    evs = story["events"]
    segments: List[Dict[str, Any]] = []
    for a, b in zip(evs, evs[1:]):
        ha = (a.get("hlc") or [0, 0])[0]
        hb = (b.get("hlc") or [0, 0])[0]
        segments.append({
            "from": _event_label(a), "to": _event_label(b),
            "src_proc": a.get("proc"), "dst_proc": b.get("proc"),
            "us": max(0, int(hb) - int(ha)),
        })
    total = sum(s["us"] for s in segments)
    dominant = max(segments, key=lambda s: s["us"]) if segments \
        else None
    return {
        "trace_id": trace_id,
        "n_events": len(evs),
        "total_us": total,
        "segments": segments,
        "dominant": dominant,
        "dominant_frac": (dominant["us"] / total)
        if dominant and total else 0.0,
        "outcome": story.get("outcome"),
    }


def render_critical_path(cp: Dict[str, Any]) -> str:
    if not cp.get("segments"):
        return (f"request {cp.get('trace_id')}: no critical path "
                f"(fewer than two journaled events)")
    lines = [f"request {cp['trace_id']}: critical path "
             f"{cp['total_us']}us over {cp['n_events']} events"]
    for s in cp["segments"]:
        mark = " <-- dominant" if s is cp.get("dominant") else ""
        hop = "" if s["src_proc"] == s["dst_proc"] \
            else f" [{s['src_proc']} -> {s['dst_proc']}]"
        lines.append(f"  {s['from']} -> {s['to']}: {s['us']}us"
                     f"{hop}{mark}")
    d = cp.get("dominant")
    if d is not None:
        lines.append(f"  dominant: {d['from']} -> {d['to']} "
                     f"({d['us']}us, {cp['dominant_frac']:.0%} of "
                     f"the path)")
    return "\n".join(lines)


def render_request_story(story: Dict[str, Any]) -> str:
    """Human rendering of :func:`request_story`: one HLC-ordered line
    per event, cross-process edges called out, verdict at the end."""
    tid = story["trace_id"]
    evs = story["events"]
    if not evs:
        return f"request {tid}: no journaled events"
    by_idx = {e.get("idx"): e for e in evs}
    # annotate each receive with where its cause came from
    cause: Dict[int, Dict[str, Any]] = {}
    for ed in story.get("edges", []):
        cause[ed["dst"]] = ed
    lines = [
        f"request {tid}: {len(evs)} events across "
        f"{len(story['procs'])} process(es) {story['procs']}"
        + (f", {story['failovers']} failover hop(s)"
           if story["failovers"] else "")
        + (f", {story['remote_pull_events']} remote-pull event(s)"
           if story["remote_pull_events"] else "")]
    for e in evs:
        line = f"  {format_event(e)}"
        ed = cause.get(e.get("idx"))
        if ed is not None:
            src = by_idx.get(ed["src"])
            if src is not None:
                hlc = src.get("hlc") or [0, 0]
                line += (f"   <- happens-after {src.get('kind')}"
                         f"@{src.get('proc')} hlc=({hlc[0]},{hlc[1]})")
        lines.append(line)
    out = story.get("outcome")
    if out is None:
        lines.append("  outcome: NONE journaled (in flight, or the "
                     "journal window ended first)")
    elif out["kind"] == "done":
        lines.append(f"  outcome: done on {out.get('worker')} "
                     f"(reason {out.get('reason')})"
                     + (f" after {story['failovers']} failover(s)"
                        if story["failovers"] else ""))
    else:
        lines.append("  outcome: shed"
                     + (f" after {story['failovers']} failover(s)"
                        if story["failovers"] else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Perfetto export: one lane per process via merge_trace_shards
# ---------------------------------------------------------------------------

def export_perfetto(merged: Dict[str, Any], out_path: str
                    ) -> Dict[str, Any]:
    """Render a merged journal as a Perfetto/Chrome document with one
    process lane per journaled process, through the JAX package's trace
    shard merge (:func:`merge_trace_shards`: pid = lane, metadata names
    the proc).  Timestamps
    are the HLC physical component (µs), so cross-process causality
    reads left-to-right on one shared timeline.

    Schedule-execution records (``kind="schedule_exec"``)
    get their own THREAD lane per process (tid 1) as complete events
    with their measured wall as the duration — an executed collective
    schedule is visible in the same doc as the request flow that
    triggered it."""
    from .trace import shard_path

    procs = list(merged.get("procs") or [])
    base = os.path.splitext(out_path)[0] + ".shard.json"
    paths = []
    for rank, proc in enumerate(procs):
        evs = [e for e in merged["events"] if e.get("proc") == proc]
        trace_events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": rank, "tid": 0,
             "args": {"name": f"journal:{proc}"}}]
        if any(e.get("kind") == "schedule_exec" for e in evs):
            trace_events.append(
                {"ph": "M", "name": "thread_name", "pid": rank,
                 "tid": 1, "args": {"name": "schedule_exec"}})
        for e in evs:
            hlc = e.get("hlc") or [0, 0]
            args = {k: v for k, v in e.items()
                    if k not in ("schema", "proc", "hlc", "t", "idx")}
            if e.get("kind") == "schedule_exec":
                trace_events.append(
                    {"ph": "X", "pid": rank, "tid": 1,
                     "name": f"{e.get('op')}({e.get('arg')})",
                     "ts": int(hlc[0]) + int(hlc[1]),
                     "dur": max(1, int(float(e.get("wall_us", 1)))),
                     "cat": "schedule_exec", "args": args})
                continue
            trace_events.append(
                {"ph": "i", "name": str(e.get("kind")), "pid": rank,
                 "tid": 0, "s": "t", "ts": int(hlc[0]) + int(hlc[1]),
                 "cat": "journal", "args": args})
        p = shard_path(base, rank)
        with open(p, "w") as f:
            json.dump({"traceEvents": trace_events,
                       "metadata": {"rank": rank, "proc": proc}}, f)
        paths.append(p)
    return merge_trace_shards(paths, out_path=out_path)


#: Schema stamp of a merged trace document (the JAX package's
#: ``aggregate.AGGREGATE_SCHEMA``).
AGGREGATE_SCHEMA = "chainermn_tpu.trace_merge.v1"


def merge_trace_shards(paths: Sequence[str],
                       out_path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-lane trace shards into one Perfetto/Chrome document (the
    JAX package's ``aggregate.merge_trace_shards`` over explicit paths):
    every event re-homed to ``pid = metadata.rank``, metadata events
    first, the rest by timestamp; an unreadable shard is skipped with a
    warning.  Written atomically to ``out_path`` when given."""
    events: List[Dict[str, Any]] = []
    merged_ranks: List[int] = []
    for i, p in enumerate(paths):
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"[chainermn_tpu aggregate] WARNING: trace shard {p!r} "
                  f"unreadable ({e}) — merging without it",
                  file=sys.stderr, flush=True)
            continue
        try:
            rank = int((doc.get("metadata") or {})["rank"])
        except (KeyError, TypeError, ValueError):
            rank = i
        merged_ranks.append(rank)
        events.extend(dict(ev, pid=rank)
                      for ev in doc.get("traceEvents", []))
    meta = [e for e in events if e.get("ph") == "M"]
    real = sorted((e for e in events if e.get("ph") != "M"),
                  key=lambda e: (e.get("ts", 0), e["pid"]))
    doc = {"traceEvents": meta + real, "displayTimeUnit": "ms",
           "metadata": {"schema": AGGREGATE_SCHEMA,
                        "merged_ranks": sorted(merged_ranks),
                        "expected_ranks": None}}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)
    return doc
