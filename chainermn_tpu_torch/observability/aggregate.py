"""Fleet-level trace / report aggregation: merge per-rank shards, name the
straggler.

Counterpart of ``chainermn_tpu/observability/aggregate.py`` (stdlib
only):

* **Trace shard merge**: every rank exports its own shard
  (``Tracer.export_chrome_trace(path, rank=r)`` → ``trace.rank00002
  .json``) and :func:`merge_trace_shards` folds them into ONE Perfetto
  document with one process lane (``pid``) per rank.  Each rank's clock
  is its own ``perf_counter`` epoch, so lanes compare in shape, not in
  absolute offset.  A missing or unreadable shard is skipped with a
  warning: a crashed rank must not take the evidence of the others with
  it.  The journal's Perfetto export merges through it too.
* **Cross-rank skew report**: :func:`cross_rank_report` reduces each
  rank's local step-time / comm summary over the communicator's
  ``allgather_obj`` object lane into per-rank step-time min / mean / max,
  the eager-collective wait imbalance and a named straggler rank.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence

from . import trace
from .comm import get_accountant
from .trace import shard_path  # noqa: F401  (``trace.json`` → ``.rank00002``)

#: Schema stamp carried by merged documents and skew reports.
AGGREGATE_SCHEMA = "chainermn_tpu.trace_merge.v1"

_SHARD_RE = re.compile(r"\.rank(\d+)(\.[^.]+)?$")


def find_shards(path: str) -> Dict[int, str]:
    """All on-disk shards for a base trace path, as ``{rank: file}``."""
    base, ext = os.path.splitext(path)
    out: Dict[int, str] = {}
    for f in _glob.glob(f"{base}.rank*{ext or '.json'}"):
        m = _SHARD_RE.search(f)
        if m:
            out[int(m.group(1))] = f
    return dict(sorted(out.items()))


def _shard_rank(doc: Dict[str, Any], fallback: int) -> int:
    meta = doc.get("metadata") or {}
    try:
        return int(meta["rank"])
    except (KeyError, TypeError, ValueError):
        return fallback


def merge_trace_shards(path_or_paths,
                       out_path: Optional[str] = None,
                       expected_ranks: Optional[int] = None
                       ) -> Dict[str, Any]:
    """Merge per-rank trace shards into one Perfetto/Chrome document.

    ``path_or_paths`` is either the BASE trace path (shards discovered via
    :func:`find_shards`) or an explicit sequence of shard files.  Every
    event is re-homed to ``pid = rank`` so Perfetto renders one process
    lane per rank; events are sorted by timestamp (shards written by
    independent processes interleave arbitrarily — out-of-order input is
    the normal case, not an error).  A shard that is missing (fewer found
    than ``expected_ranks``) or unreadable is skipped with a warning on
    stderr; the merge never fails because one rank died.

    Returns the merged document; also writes it to ``out_path``
    (atomically) when given.
    """
    if isinstance(path_or_paths, (str, os.PathLike)):
        shards = find_shards(str(path_or_paths))
        paths = list(shards.values())
        ranks = list(shards.keys())
    else:
        paths = [str(p) for p in path_or_paths]
        ranks = [None] * len(paths)

    events: List[Dict[str, Any]] = []
    merged_ranks: List[int] = []
    for i, p in enumerate(paths):
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"[chainermn_tpu_torch aggregate] WARNING: trace shard {p!r} "
                  f"unreadable ({e}) — merging without it",
                  file=sys.stderr, flush=True)
            continue
        rank = _shard_rank(doc, ranks[i] if ranks[i] is not None else i)
        merged_ranks.append(rank)
        for ev in doc.get("traceEvents", []):
            ev = dict(ev, pid=rank)
            events.append(ev)

    if expected_ranks is not None and len(merged_ranks) < expected_ranks:
        missing = sorted(set(range(expected_ranks)) - set(merged_ranks))
        print(f"[chainermn_tpu_torch aggregate] WARNING: expected "
              f"{expected_ranks} trace shards, merged {len(merged_ranks)} "
              f"(missing ranks {missing}) — timeline is partial",
              file=sys.stderr, flush=True)

    # Metadata events carry no "ts"; keep them first (per rank) so lane
    # names resolve before any real event, then real events by timestamp.
    meta = [e for e in events if e.get("ph") == "M"]
    real = sorted((e for e in events if e.get("ph") != "M"),
                  key=lambda e: (e.get("ts", 0), e["pid"]))
    doc = {
        "traceEvents": meta + real,
        "displayTimeUnit": "ms",
        "metadata": {"schema": AGGREGATE_SCHEMA,
                     "merged_ranks": sorted(merged_ranks),
                     "expected_ranks": expected_ranks},
    }
    if out_path:
        d = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(d, exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)
    return doc


def local_rank_summary(rank: Optional[int] = None) -> Dict[str, Any]:
    """This process's contribution to the cross-rank skew report, read from
    the live tracer + comm accountant: per-step host wall clock (the
    ``step`` spans the Trainer emits) and the cumulative collective
    ledger (bytes + eager host wait time)."""
    tr = trace.get_tracer()
    step_s = [ev["dur"] / 1e6 for ev in tr.events()
              if ev.get("ph") == "X" and ev.get("name") == "step"]
    rep = get_accountant().report()
    return {
        "rank": rank,
        "steps": len(step_s),
        "step_time_s": step_s,
        "comm_bytes": rep["bytes"],
        "comm_calls": rep["calls"],
        "comm_wait_s": rep["host_time_s"],
    }


def _stats(vals: Sequence[float]) -> Dict[str, float]:
    vals = list(vals)
    if not vals:
        return {"min": 0.0, "mean": 0.0, "max": 0.0}
    return {"min": min(vals), "mean": sum(vals) / len(vals),
            "max": max(vals)}


def cross_rank_report(comm, local: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Collective: every rank calls this with its local summary (default:
    :func:`local_rank_summary`) and receives the fleet view.

    The reduction rides ``comm.allgather_obj`` — the object lane, NOT
    a wire collective — so it is a setup/teardown-path operation, never
    hot.  The report names:

    * ``step_time`` — min/mean/max of the per-rank MEAN step times, plus
      the full per-rank list (``per_rank``), so "how skewed is the gang"
      is one line;
    * ``straggler_rank`` — the rank with the largest mean step time, and
      ``straggler_slowdown`` = its mean over the fleet-fastest mean
      (1.0 = perfectly balanced);
    * ``comm_wait`` — per-rank eager-collective host wait totals and
      ``imbalance`` = max/mean (the allreduce wait-time imbalance the
      allreduce-tuning literature argues from: a rank that waits least is
      usually the one everyone else is waiting FOR).
    """
    if local is None:
        local = local_rank_summary(rank=getattr(comm, "rank", None))
    gathered = comm.allgather_obj(local)
    # one entry per rank; fill in rank ids where the caller left None
    per_rank = []
    for i, g in enumerate(gathered):
        g = dict(g)
        if g.get("rank") is None:
            g["rank"] = i
        per_rank.append(g)
    # under a single controller every "rank" reports the same process-wide
    # summary — collapse duplicates by rank id so the stats stay honest
    seen: Dict[int, Dict[str, Any]] = {}
    for g in per_rank:
        seen.setdefault(int(g["rank"]), g)
    per_rank = [seen[r] for r in sorted(seen)]

    mean_step = {g["rank"]: (sum(g["step_time_s"]) / len(g["step_time_s"])
                             if g["step_time_s"] else 0.0)
                 for g in per_rank}
    waits = {g["rank"]: float(g.get("comm_wait_s") or 0.0) for g in per_rank}
    stats = _stats(list(mean_step.values()))
    straggler = (max(mean_step, key=lambda r: mean_step[r])
                 if mean_step else None)
    fastest = stats["min"]
    wait_stats = _stats(list(waits.values()))
    report = {
        "schema": AGGREGATE_SCHEMA,
        "ranks": sorted(mean_step),
        "step_time": dict(
            stats, per_rank={str(r): round(v, 6)
                             for r, v in sorted(mean_step.items())}),
        "straggler_rank": straggler,
        "straggler_slowdown": (
            round(mean_step[straggler] / fastest, 4)
            if straggler is not None and fastest > 0 else None),
        "comm_wait": {
            "per_rank": {str(r): round(v, 6)
                         for r, v in sorted(waits.items())},
            "imbalance": (round(wait_stats["max"] / wait_stats["mean"], 4)
                          if wait_stats["mean"] > 0 else None),
        },
        "comm_bytes": {str(g["rank"]): int(g.get("comm_bytes") or 0)
                       for g in per_rank},
    }
    return report
