"""Cost-model calibration + critical-path attribution from measured
``schedule_exec`` records — the truth side of the schedule plane.

Counterpart of ``chainermn_tpu/analysis/calibrate.py``, a copy.  The
schedule IR makes comm programs compiled, checkable artifacts; every one
of them is still PRICED by the hand-set r04 constants in
:class:`~.schedule.CostModel`.  This module closes the loop:

* :func:`read_exec_records` pools ``chainermn_tpu.schedule_exec.v1``
  records from raw JSONL files or journal files (torn tails
  skipped, foreign schemas refused — the journal's own read
  discipline).
* :func:`fit_calibration` fits per-link ``wall = alpha + bytes/bw`` by
  least squares and returns a versioned, commented artifact
  (``chainermn_tpu.calibration.v1``) that
  :func:`~.schedule.price_schedule`/:func:`~.schedule_check.compile_verified`
  consume via ``calibration=`` — candidates then rank by MEASURED
  costs.  :func:`load_calibration` refuses stale artifacts by schema
  version.
* :func:`drift_report` is the gate: when the calibrated model's
  predictions diverge from fresh measurements beyond a threshold the
  artifact has rotted (new host, new kernel, new numpy) and the fit
  must be redone.  ``python -m chainermn_tpu_torch.analysis --gate`` runs it
  as the ``calibration`` stage, exiting 0 ("skipped") when no records
  exist yet.
* :func:`schedule_critical_path` walks the start/done dependency edges
  of one executed run to name the longest chain, the dominant link
  class on it, and the OVERLAP FRACTION — wire time hidden behind
  other work vs exposed on the critical path.  This is the instrument
  ROADMAP item 5's bucket-pipelined overlap is gated on.

Analysis-package contract: stdlib + numpy only at import time, no jax,
no observability imports (the package imports standalone).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .schedule import (
    CALIBRATION_SCHEMA, CostModel, calibrated_cost_model,
)
from .schedule_check import SCHEDULE_EXEC_SCHEMA

__all__ = [
    "CALIBRATION_SCHEMA", "read_exec_records", "transfer_samples",
    "fit_calibration", "save_calibration", "load_calibration",
    "drift_report", "schedule_critical_path", "find_records", "main",
]

#: The journal schema — records teed through ``journal.emit``
#: arrive wrapped in this envelope; the constant is duplicated here
#: (string only) so the analysis package stays importable standalone.
_JOURNAL_SCHEMA = "chainermn_tpu.journal.v1"

#: Journal-envelope fields stripped when unwrapping a teed record.
_ENVELOPE = ("schema", "kind", "hlc")


# --------------------------------------------------------------------------
# record ingestion — the journal's torn-tail discipline
# --------------------------------------------------------------------------

def _coerce_record(doc: dict) -> Optional[dict]:
    """A usable exec record or None.  Accepts raw
    ``schedule_exec.v1`` lines and journal-enveloped lines
    (``kind == "schedule_exec"``); anything else is not ours."""
    schema = doc.get("schema")
    if schema == _JOURNAL_SCHEMA:
        if doc.get("kind") != "schedule_exec":
            return None
        doc = {k: v for k, v in doc.items() if k not in _ENVELOPE}
    elif schema is not None and schema != SCHEDULE_EXEC_SCHEMA:
        return None
    # partial/torn records (a crashed run journals what it got to) are
    # tolerated by dropping, not by crashing the fit.
    if doc.get("op") is None or doc.get("link") is None:
        return None
    try:
        doc["bytes"] = int(doc["bytes"])
        doc["wall_us"] = float(doc["wall_us"])
    except (KeyError, TypeError, ValueError):
        return None
    return doc


def read_exec_records(path: str) -> List[dict]:
    """All schedule-exec records under ``path`` (a JSONL file or a
    directory scanned for ``*.jsonl``).  Torn trailing lines and
    foreign lines are skipped silently — same contract as
    ``journal.read_journal``."""
    files: List[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(".jsonl"):
                files.append(os.path.join(path, name))
    else:
        files.append(path)
    out: List[dict] = []
    for fp in files:
        try:
            with open(fp, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail / partial write
                    if not isinstance(doc, dict):
                        continue
                    rec = _coerce_record(doc)
                    if rec is not None:
                        out.append(rec)
        except OSError:
            continue
    return out


def find_records(paths: Sequence[str] = ()) -> List[dict]:
    """Record discovery for the gate: explicit paths, else
    ``$CHAINERMN_SCHEDULE_EXEC_RECORDS`` (file or directory), else
    ``./schedule_exec.jsonl`` when present.  Empty list = nothing
    measured yet (the gate skips cleanly)."""
    cands = list(paths)
    if not cands:
        env = os.environ.get("CHAINERMN_SCHEDULE_EXEC_RECORDS")
        if env:
            cands = [env]
        elif os.path.exists("schedule_exec.jsonl"):
            cands = ["schedule_exec.jsonl"]
    recs: List[dict] = []
    for p in cands:
        if os.path.exists(p):
            recs.extend(read_exec_records(p))
    return recs


# --------------------------------------------------------------------------
# the least-squares (alpha, bw) fit
# --------------------------------------------------------------------------

def transfer_samples(records: Sequence[dict]
                     ) -> Dict[str, List[Tuple[int, float]]]:
    """Per-link (bytes, wall_s) samples.

    A wire sample is one TRANSFER: its ``start`` wall (gather + post)
    plus its ``done`` wall (await + landing copy), paired by
    (run, tid).  A ``start`` whose ``done`` never recorded (torn run)
    contributes nothing.  ``copy`` samples are individual local
    copy/unstage ops."""
    out: Dict[str, List[Tuple[int, float]]] = {
        "ici": [], "dcn": [], "copy": []}
    starts: Dict[Tuple[str, str], dict] = {}
    for r in records:
        link = r["link"]
        if link == "copy":
            out["copy"].append((r["bytes"], r["wall_us"] / 1e6))
            continue
        if link not in ("ici", "dcn"):
            continue
        key = (str(r.get("run", "?")), str(r.get("arg", "?")))
        if r["op"] == "start":
            starts[key] = r
        elif r["op"] == "done":
            s = starts.pop(key, None)
            if s is not None and s["link"] == link:
                wall_s = (s["wall_us"] + r["wall_us"]) / 1e6
                out[link].append((r["bytes"], wall_s))
    return out


def _fit_link(samples: List[Tuple[int, float]]
              ) -> Optional[Dict[str, float]]:
    """alpha + bytes/bw least squares over one link's samples; None
    when the link was never measured or the fit is degenerate."""
    pts = [(b, w) for b, w in samples if w > 0 and b > 0]
    if not pts:
        return None
    b = np.array([p[0] for p in pts], dtype=np.float64)
    w = np.array([p[1] for p in pts], dtype=np.float64)
    alpha, slope = 0.0, None
    if len(pts) >= 2 and float(b.std()) > 0:
        A = np.stack([np.ones_like(b), b], axis=1)
        coef, *_ = np.linalg.lstsq(A, w, rcond=None)
        alpha, slope = float(coef[0]), float(coef[1])
    if slope is None or slope <= 0 or alpha < 0:
        # degenerate (one sample, uniform sizes, or a negative
        # intercept/slope from noise): refit through the origin —
        # a pure-bandwidth model is still a measurement.
        alpha = max(0.0, alpha) if slope is not None and slope > 0 \
            else 0.0
        denom = float((b * b).sum())
        slope = float((b * w).sum()) / denom if denom > 0 else 0.0
        if slope <= 0:
            return None
    pred = alpha + slope * b
    residual = float(np.median(np.abs(pred - w) / w))
    return {
        "alpha_s": alpha,
        "bw": 1.0 / slope,
        "n": len(pts),
        "residual_rel": residual,
    }


def fit_calibration(records: Sequence[dict]) -> dict:
    """Fit per-link (alpha, bw) from pooled exec records and return
    the versioned calibration artifact.  Deterministic: same records
    in, byte-identical artifact out (no timestamps, no host salt)."""
    samples = transfer_samples(records)
    links: Dict[str, dict] = {}
    for link in ("ici", "dcn", "copy"):
        fit = _fit_link(samples[link])
        if fit is not None:
            links[link] = fit
    fingerprints = sorted({str(r.get("fingerprint"))
                           for r in records if r.get("fingerprint")})
    stock = CostModel()
    return {
        "schema": CALIBRATION_SCHEMA,
        "comment": [
            "Measured per-link cost-model constants fitted by"
            " chainermn_tpu_torch.analysis.calibrate from schedule_exec"
            " records (wall = alpha_s + bytes/bw, least squares).",
            "links.<link>.alpha_s: fitted per-message setup latency"
            " in seconds; links.<link>.bw: fitted bandwidth in B/s;"
            " n: samples; residual_rel: median |pred-meas|/meas of"
            " the fit itself.",
            "Consumed by price_schedule(calibration=) /"
            " compile_verified(calibration=); stock r04 constants"
            " fill any link absent here.",
            f"Stock r04 baseline: ici_bw={stock.ici_bw:g}"
            f" dcn_bw={stock.dcn_bw:g} alpha_ici_s={stock.alpha_ici_s:g}"
            f" alpha_dcn_s={stock.alpha_dcn_s:g}"
            f" copy_bw={stock.copy_bw:g}.",
        ],
        "n_records": len(records),
        "fingerprints": fingerprints,
        "links": links,
    }


def save_calibration(doc: dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_calibration(path: str) -> dict:
    """Load and validate a calibration artifact; a wrong/absent schema
    version raises (stale artifacts must be re-fit, never silently
    consumed)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) \
            or doc.get("schema") != CALIBRATION_SCHEMA:
        raise ValueError(
            f"{path}: stale/foreign calibration artifact "
            f"(schema={doc.get('schema') if isinstance(doc, dict) else None!r},"
            f" want {CALIBRATION_SCHEMA})")
    return doc


# --------------------------------------------------------------------------
# drift gate
# --------------------------------------------------------------------------

def drift_report(records: Sequence[dict], calibration: dict,
                 threshold: float = 0.5) -> dict:
    """Has reality drifted from the calibrated predictions?

    Per wire sample the calibrated model predicts
    ``alpha + bytes/bw``; the report is the median relative error per
    link and overall.  ``ok`` is False once the overall median exceeds
    ``threshold`` — time to re-fit (or to ask what changed on the
    host)."""
    cm = calibrated_cost_model(calibration)
    samples = transfer_samples(records)
    per_link: Dict[str, dict] = {}
    errs_all: List[float] = []
    for link in ("ici", "dcn"):
        errs = []
        for b, w in samples[link]:
            if w <= 0:
                continue
            pred = cm.alpha(link) + b / cm.bw(link)
            errs.append(abs(pred - w) / w)
        if errs:
            per_link[link] = {
                "n": len(errs),
                "median_rel_err": float(np.median(errs)),
            }
            errs_all.extend(errs)
    overall = float(np.median(errs_all)) if errs_all else 0.0
    return {
        "ok": overall <= threshold,
        "threshold": threshold,
        "n_samples": len(errs_all),
        "median_rel_err": overall,
        "links": per_link,
    }


# --------------------------------------------------------------------------
# causal critical path + overlap attribution
# --------------------------------------------------------------------------

def schedule_critical_path(records: Sequence[dict]) -> dict:
    """The longest dependency chain through one executed run.

    Edges: program order on each rank (the interpreter retires a
    rank's ops in order) and ``start(t) -> done(t)`` across ranks (a
    landing cannot precede its send).  The chain's length is the sum
    of op walls along it — the part of the measured wall that NO
    scheduling freedom can hide.  Wire time OFF the chain is hidden
    behind other work; the overlap fraction is
    ``hidden_wire / total_wire`` (1.0 = all wire time overlapped,
    0.0 = every wire microsecond exposed).  ``wire_exposed_frac`` is
    the complement — the gateable lower-is-better face.

    With records from several runs, the LAST run is attributed.
    """
    runs: List[str] = []
    for r in records:
        rid = str(r.get("run", "?"))
        if not runs or runs[-1] != rid:
            runs.append(rid)
    if not runs:
        return {"run": None, "n_ops": 0, "critical_path_us": 0.0,
                "chain": [], "by_link_path_us": {},
                "dominant_link": None, "dominant_op": None,
                "wire_total_us": 0.0, "wire_exposed_us": 0.0,
                "wire_hidden_us": 0.0, "overlap_frac": 0.0,
                "wire_exposed_frac": 0.0}
    run = runs[-1]
    recs = [r for r in records if str(r.get("run", "?")) == run]
    recs = sorted(recs, key=lambda r: r.get("seq", 0))
    n = len(recs)
    cp = [0.0] * n       # chain length ending at i (inclusive)
    pred = [-1] * n
    last_on_rank: Dict[int, int] = {}
    start_ix: Dict[str, int] = {}
    for i, r in enumerate(recs):
        best, best_p = 0.0, -1
        j = last_on_rank.get(r.get("rank"))
        if j is not None and cp[j] > best:
            best, best_p = cp[j], j
        if r["op"] == "done":
            j = start_ix.get(str(r.get("arg")))
            if j is not None and cp[j] > best:
                best, best_p = cp[j], j
        cp[i] = best + float(r["wall_us"])
        pred[i] = best_p
        last_on_rank[r.get("rank")] = i
        if r["op"] == "start":
            start_ix[str(r.get("arg"))] = i
    end = int(np.argmax(cp)) if n else -1
    chain_ix: List[int] = []
    i = end
    while i >= 0:
        chain_ix.append(i)
        i = pred[i]
    chain_ix.reverse()
    on_path = set(chain_ix)
    by_link: Dict[str, float] = {}
    wire_total = wire_exposed = 0.0
    for i, r in enumerate(recs):
        w = float(r["wall_us"])
        if i in on_path:
            by_link[r["link"]] = by_link.get(r["link"], 0.0) + w
        if r["link"] in ("ici", "dcn"):
            wire_total += w
            if i in on_path:
                wire_exposed += w
    hidden = max(0.0, wire_total - wire_exposed)
    dom_link = max(by_link, key=lambda k: by_link[k]) if by_link \
        else None
    dom_op = None
    if chain_ix:
        i = max(chain_ix, key=lambda j: recs[j]["wall_us"])
        r = recs[i]
        dom_op = (f"r{r.get('rank')}.{r['op']}({r.get('arg')})"
                  f"[{r['link']}] {r['wall_us']:.1f}us")
    return {
        "run": run,
        "n_ops": n,
        "critical_path_us": float(cp[end]) if n else 0.0,
        "chain": [f"r{recs[j].get('rank')}."
                  f"{recs[j]['op']}({recs[j].get('arg')})"
                  f"[{recs[j]['link']}]" for j in chain_ix],
        "by_link_path_us": {k: float(v) for k, v in
                            sorted(by_link.items())},
        "dominant_link": dom_link,
        "dominant_op": dom_op,
        "wire_total_us": wire_total,
        "wire_exposed_us": wire_exposed,
        "wire_hidden_us": hidden,
        "overlap_frac": (hidden / wire_total) if wire_total else 0.0,
        "wire_exposed_frac": (wire_exposed / wire_total)
        if wire_total else 0.0,
    }


# --------------------------------------------------------------------------
# CLI — the --gate face (exit 0 clean/skip, 1 drift, 2 unusable)
# --------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis.calibrate",
        description="fit per-link (alpha, bw) from schedule_exec "
                    "records and gate calibration drift (exit 0 "
                    "clean/skipped, 1 drift, 2 unusable)")
    p.add_argument("records", nargs="*",
                   help="record JSONL files / journal dirs; default = "
                        "$CHAINERMN_SCHEDULE_EXEC_RECORDS or "
                        "./schedule_exec.jsonl")
    p.add_argument("--fit-out", default=None,
                   help="persist the fitted calibration artifact here")
    p.add_argument("--calibration", default=None,
                   help="existing artifact to drift-check against "
                        "(default: $CHAINERMN_CALIBRATION when set, "
                        "else the fresh fit checks itself)")
    p.add_argument("--drift-threshold", type=float, default=0.5,
                   help="median relative error above which the gate "
                        "flags drift (default 0.5)")
    p.add_argument("--gate", action="store_true",
                   help="gate mode: exit 0 when no records exist yet")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    try:
        records = find_records(args.records)
    except Exception as e:
        print(f"calibrate: unusable: {e!r}", file=sys.stderr)
        return 2
    if not records:
        msg = {"stage": "calibration", "skipped": True,
               "reason": "no schedule_exec records found"}
        print(json.dumps(msg) if args.json
              else "calibration-drift: skipped (no records yet)")
        # nothing measured is not a finding — the gate stays green
        # until the first profiled execution lands records.
        return 0 if args.gate else 2

    try:
        cal_path = args.calibration \
            or os.environ.get("CHAINERMN_CALIBRATION")
        if cal_path:
            calibration = load_calibration(cal_path)
        else:
            calibration = fit_calibration(records)
        if args.fit_out:
            fresh = calibration if not cal_path \
                else fit_calibration(records)
            save_calibration(fresh, args.fit_out)
        drift = drift_report(records, calibration,
                             threshold=args.drift_threshold)
    except ValueError as e:
        print(f"calibrate: unusable: {e}", file=sys.stderr)
        return 2
    except Exception as e:
        print(f"calibrate: unusable: {e!r}", file=sys.stderr)
        return 2

    out = {
        "stage": "calibration",
        "n_records": len(records),
        "calibration_source": cal_path or "(fresh fit)",
        "links": calibration.get("links", {}),
        "drift": drift,
    }
    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        for link, fit in sorted(out["links"].items()):
            print(f"calibration: {link}: alpha={fit['alpha_s']*1e6:.2f}us "
                  f"bw={fit['bw']:.3g}B/s n={fit['n']} "
                  f"residual={fit['residual_rel']:.3f}")
        verdict = "ok" if drift["ok"] else "DRIFT"
        print(f"calibration-drift: {verdict} "
              f"median_rel_err={drift['median_rel_err']:.3f} "
              f"(threshold {drift['threshold']}, "
              f"{drift['n_samples']} samples, "
              f"{len(records)} records)")
    return 0 if drift["ok"] else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
