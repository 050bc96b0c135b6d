"""Runner: ``python -m chainermn_tpu_torch.analysis``.

Counterpart of ``chainermn_tpu/analysis/cli.py``.  With no paths it lints
the port's package against the port's own baselines
(``chainermn_tpu_torch/.spmd-lint-baseline.json`` and
``.concurrency-baseline.json`` beside it), and runs the trace engine
(:mod:`.trace_engine`) over the registered entry points on the card.  On a
host without a card the trace engine is skipped with a note, as JAX's
skips its jaxpr engine without jax; ``--device cpu`` runs it on the host.

Exit-code contract (same as ``scripts/check_perf_regression.py``):

* **0** — clean: no findings beyond the checked-in baseline;
* **1** — findings: at least one non-baselined finding (any severity);
* **2** — unusable: bad arguments, missing paths, broken baseline.

Human output is one block per finding (``path:line: severity: rule
[scope]: message``); ``--json`` emits a single machine document
(``chainermn_tpu.spmd_lint.v1``) with the findings, the baseline-accepted
count, and the per-entry-point collective sequences from the trace engine.

``--fix-baseline`` regenerates the baseline from the current findings —
the INTENTIONAL way to accept a triaged finding; human-written comments
on surviving entries are preserved.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .ast_engine import AST_RULES, analyze_paths
from .baseline import BaselineGate
from .concurrency import (CONCURRENCY_BASELINE_FILENAME,
                          CONCURRENCY_RULES)
from .concurrency import analyze_paths as analyze_concurrency
from .findings import BASELINE_FILENAME, Finding, find_baseline
from .registry import default_registry

SCHEMA = "chainermn_tpu.spmd_lint.v1"

#: ``--rules concurrency`` selects the whole lock-discipline family.
RULE_FAMILIES = {"concurrency": tuple(sorted(CONCURRENCY_RULES))}


def _all_rules():
    from .trace_engine import TRACE_RULES
    out = dict(AST_RULES)
    out.update(TRACE_RULES)
    out.update(CONCURRENCY_RULES)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis",
        description="SPMD-aware static analyzer: collective-deadlock, "
                    "PRNG, host-aliasing, and recompilation lint for "
                    "the PyTorch port (docs/ANALYSIS.md).  With --gate, "
                    "runs every analysis plane (lint + protocol "
                    "models + shardflow + schedule verifier + "
                    "calibration) as one CI check (see --gate --help)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to scan (default: the "
                        "chainermn_tpu_torch package directory)")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable JSON document on stdout")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: nearest "
                        f"{BASELINE_FILENAME} above the first path)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report everything")
    p.add_argument("--fix-baseline", action="store_true",
                   help="regenerate the baseline from current findings "
                        "(intentional acceptance; keeps existing comments)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset to run")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--no-trace", "--no-jaxpr", dest="no_trace",
                   action="store_true",
                   help="skip the trace engine (runs no entry point: "
                        "pure-AST mode, on any box)")
    p.add_argument("--device", default=None,
                   help="where the trace engine runs the entry points "
                        "(default: the card; skipped with a note when "
                        "there is none — pass 'cpu' to run them on the "
                        "host)")
    p.add_argument("--entry", action="append", default=None,
                   metavar="NAME",
                   help="run the trace checks on ONE registered entry "
                        "point (repeatable; default: all) — iterate on "
                        "a single subsystem without paying the whole "
                        "sweep")
    return p


def _package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: the ``--gate`` stages, in run order (JAX's): each is (name, thunk
#: returning an exit code under the same 0/1/2 contract).  ``shardflow``
#: runs the entry points on ``--device`` (default: the card, and the
#: stage is skipped with a note, exit 0, where there is none, as the
#: lint's trace engine is).  ``calibration`` drift-checks the measured
#: cost-model fit against fresh schedule_exec records and exits 0
#: ("skipped") until any exist.
GATE_STAGES = ("lint", "protocol", "shardflow", "schedules",
               "calibration")


def gate_main(argv: Optional[List[str]] = None) -> int:
    """``python -m chainermn_tpu_torch.analysis --gate`` — ONE CI-callable
    check running every analysis plane: the SPMD+concurrency lint, the
    protocol model checker, the shard-flow reconciliation, the collective
    schedule verifier, and the cost-model calibration drift check.
    ``--device`` names where the lint's trace engine and the shard-flow
    stage run the entry points.  Exit is the worst stage under the
    shared contract: 0 clean, 1 findings/violations, 2 unusable.
    """
    p = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.analysis --gate",
        description="run all analysis gates "
                    f"({', '.join(GATE_STAGES)}) and exit 0/1/2")
    p.add_argument("--stages", default=",".join(GATE_STAGES),
                   help="comma-separated stage subset, in run order")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable summary document on "
                        "stdout (stage output goes to stderr)")
    p.add_argument("--device", default=None,
                   help="where the entry points run (default: the card; "
                        "without one the trace engine and the shardflow "
                        "stage are skipped with a note — pass 'cpu' to "
                        "run them on the host)")
    args = p.parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = set(stages) - set(GATE_STAGES)
    if unknown:
        print(f"error: unknown stage(s): {', '.join(sorted(unknown))} "
              f"(have {', '.join(GATE_STAGES)})", file=sys.stderr)
        return 2

    dev = ["--device", args.device] if args.device else []

    def run_stage(name: str) -> int:
        if name == "lint":
            return main(dev)
        if name == "protocol":
            from .protocol import main as protocol_main
            return protocol_main([])
        if name == "shardflow":
            if not dev:
                import torch
                if not torch.cuda.is_available():
                    print("note: shardflow stage skipped (no CUDA device; "
                          "pass --device cpu to run the entry points on "
                          "the host)", file=sys.stderr)
                    return 0
            from .shardflow import main as shardflow_main
            return shardflow_main(dev)
        if name == "calibration":
            from .calibrate import main as calibrate_main
            return calibrate_main(["--gate"])
        from .schedule_check import main as schedule_main
        return schedule_main([])

    import contextlib

    rcs = {}
    for name in stages:
        print(f"=== gate stage: {name} ===",
              file=sys.stderr if args.json else sys.stdout)
        try:
            if args.json:
                with contextlib.redirect_stdout(sys.stderr):
                    rcs[name] = run_stage(name)
            else:
                rcs[name] = run_stage(name)
        except SystemExit as e:  # stage argparse bail-outs
            rcs[name] = int(e.code or 0)
        except Exception as e:
            print(f"gate stage {name} crashed: {e!r}", file=sys.stderr)
            rcs[name] = 2
    worst = max(rcs.values(), default=0)
    if args.json:
        print(json.dumps({"schema": "chainermn_tpu.analysis_gate.v1",
                          "stages": rcs, "exit": worst}, indent=2,
                         sort_keys=True))
    else:
        tally = ", ".join(f"{k}={v}" for k, v in rcs.items())
        print(f"analysis-gate: {tally} -> exit {worst}",
              file=sys.stderr)
    return worst


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--gate" in argv:
        rest = [a for a in argv if a != "--gate"]
        return gate_main(rest)
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule, (sev, desc) in sorted(_all_rules().items()):
            print(f"{rule:24s} {sev:8s} {desc}")
        for fam, members in sorted(RULE_FAMILIES.items()):
            print(f"{fam:24s} family   = {', '.join(members)}")
        return 0

    paths = args.paths or [_package_dir()]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"error: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2

    raw_rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
                 if args.rules else None)
    rules: Optional[List[str]] = None
    if raw_rules:
        rules = []
        for r in raw_rules:
            rules.extend(RULE_FAMILIES.get(r, (r,)))
        unknown = set(rules) - set(_all_rules())
        if unknown:
            print(f"error: unknown rule(s): {', '.join(sorted(unknown))} "
                  "(see --list-rules)", file=sys.stderr)
            return 2
    if args.entry and args.no_trace:
        print("error: --entry needs the trace engine (drop --no-trace)",
              file=sys.stderr)
        return 2

    # the concurrency family runs alongside the SPMD rules (own engine,
    # own baseline file); a pure-concurrency --rules selection skips the
    # AST/trace engines entirely
    conc_only = rules is not None and all(
        r in CONCURRENCY_RULES for r in rules)
    run_conc = rules is None or any(r in CONCURRENCY_RULES
                                    for r in rules)

    registry = default_registry()
    findings = ([] if conc_only
                else analyze_paths(paths, registry=registry,
                                   rules=rules))
    conc_findings: List[Finding] = []
    if run_conc:
        conc_findings = analyze_concurrency(paths, rules=rules)
        if not conc_only:
            # both engines parsed the same files: keep the AST
            # engine's parse-error as the canonical one
            conc_findings = [f for f in conc_findings
                             if f.rule != "parse-error"]

    reports = []
    device = args.device
    if device is None and not args.no_trace and not conc_only:
        import torch
        if torch.cuda.is_available():
            device = "cuda"
        else:
            print("note: trace engine skipped (no CUDA device; pass "
                  "--device cpu to run the entry points on the host)",
                  file=sys.stderr)
    if device is not None and not args.no_trace and not conc_only:
        try:
            from .trace_engine import check_entrypoints
            eps = None
            if args.entry:
                from .entrypoints import select_entrypoints
                eps, err = select_entrypoints(args.entry)
                if err:
                    print(f"error: {err}", file=sys.stderr)
                    return 2
            jf, reports = check_entrypoints(eps, device=device)
            if rules is not None:
                # entrypoint-error bypasses the filter: "this entry point
                # could not be analyzed" must never read as "clean under
                # rule X" (same carve-out as the AST engine's parse-error)
                jf = [f for f in jf
                      if f.rule in rules or f.rule == "entrypoint-error"]
            findings.extend(jf)
        except ImportError as e:
            print(f"note: trace engine skipped ({e})", file=sys.stderr)

    # ---- normalize paths for stable fingerprints regardless of cwd:
    # anchor at the baseline's directory when it contains every scanned
    # path (the checked-in layout), else at the scanned paths' common
    # ancestor — NEVER at a root that forces "../" segments, which would
    # bake the checkout's absolute location into fingerprints ----
    bl_path = args.baseline or find_baseline(paths[0])
    abs_paths = [os.path.abspath(p) for p in paths]
    common = os.path.commonpath(abs_paths)
    if os.path.isfile(common):
        common = os.path.dirname(common)
    root = common
    if bl_path:
        bl_dir = os.path.dirname(os.path.abspath(bl_path))
        if os.path.commonpath([bl_dir, common]) == bl_dir:
            root = bl_dir
    gate = BaselineGate(bl_path, enabled=not args.no_baseline)
    conc_gate = BaselineGate.resolve(
        None, paths[0], CONCURRENCY_BASELINE_FILENAME,
        enabled=not args.no_baseline)
    # each family anchors its findings at ITS OWN baseline's directory
    # (falling back to the scan root): an `--baseline` redirect of the
    # SPMD file must not re-root the concurrency fingerprints — or a
    # fixture-dir --fix-baseline would resolve the repo keepers'
    # relative paths against the wrong root and wipe them as in-scope
    conc_root = root
    if conc_gate.path:
        cd = os.path.dirname(os.path.abspath(conc_gate.path))
        if os.path.commonpath([cd, common]) == cd:
            conc_root = cd
    for f in findings:
        if f.path and not f.path.startswith("entrypoint:"):
            f.path = os.path.relpath(os.path.abspath(f.path), root)
    for f in conc_findings:
        if f.path:
            f.path = os.path.relpath(os.path.abspath(f.path), conc_root)
    for g in (gate, conc_gate):
        err = g.load()
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2

    if args.fix_baseline:
        # regeneration is scoped to THIS invocation: entries for paths
        # not scanned, rules filtered out, or entry points not run
        # (--no-trace, or no card) are carried over untouched — a partial
        # `--fix-baseline chainermn_tpu/` must not wipe the examples/
        # keepers.  Each family regenerates its OWN baseline file.
        def path_in_scope(entry, anchor) -> bool:
            ap = os.path.normpath(os.path.join(anchor, entry["path"]))
            return any(ap == sp or ap.startswith(sp + os.sep)
                       for sp in abs_paths)

        def in_scope(entry) -> bool:
            p = entry["path"]
            if p.startswith("entrypoint:"):
                if args.entry and p[len("entrypoint:"):] not in args.entry:
                    return False  # --entry: unselected entries carry over
                return device is not None and not args.no_trace and (
                    rules is None or entry["rule"] in rules
                    or entry["rule"] == "entrypoint-error")
            if rules is not None and entry["rule"] not in rules \
                    and entry["rule"] != "parse-error":
                return False
            return path_in_scope(entry, root)

        def conc_in_scope(entry) -> bool:
            if entry["rule"] == "parse-error" and not conc_only:
                # the combined run dedups parse-errors into the SPMD
                # family (they are stripped from conc_findings above);
                # a parse-error the STANDALONE concurrency runner
                # baselined must carry over, not be wiped as in-scope
                return False
            if rules is not None and entry["rule"] not in rules \
                    and entry["rule"] != "parse-error":
                return False
            return path_in_scope(entry, conc_root)

        if not conc_only:
            gate.fix(findings, in_scope=in_scope,
                     default_target=os.path.join(root,
                                                 BASELINE_FILENAME))
        if run_conc:
            conc_gate.fix(
                conc_findings, in_scope=conc_in_scope,
                default_target=os.path.join(
                    conc_root, CONCURRENCY_BASELINE_FILENAME))
        return 0

    findings, accepted = gate.filter(findings)
    conc_new, conc_accepted = conc_gate.filter(conc_findings)
    findings = sorted(findings + conc_new,
                      key=lambda f: (f.path, f.line, f.rule))
    accepted = accepted + conc_accepted

    if args.json:
        doc = {
            "schema": SCHEMA,
            "paths": [os.path.relpath(os.path.abspath(p), root)
                      for p in paths],
            "baseline": (os.path.relpath(bl_path, root)
                         if bl_path and gate.baseline is not None
                         else None),
            "concurrency_baseline": (
                os.path.relpath(conc_gate.path, root)
                if conc_gate.path and conc_gate.baseline is not None
                else None),
            "n_accepted_by_baseline": len(accepted),
            "findings": [f.to_dict() for f in findings],
            "entrypoints": [
                {"name": r.name,
                 "collectives": [list(c) for c in r.collectives],
                 "n_compiles": r.n_compiles,
                 "error": r.error} for r in reports],
        }
        print(json.dumps(doc, indent=2))
    else:
        for f in findings:
            print(f.render())
        sev = {}
        for f in findings:
            sev[f.severity] = sev.get(f.severity, 0) + 1
        tally = ", ".join(f"{n} {s}" for s, n in sorted(sev.items())) or \
            "no findings"
        extra = (f" ({len(accepted)} accepted by baseline)"
                 if accepted else "")
        print(f"spmd-lint: {tally}{extra} over {len(paths)} path(s)",
              file=sys.stderr)

    return 1 if findings else 0
