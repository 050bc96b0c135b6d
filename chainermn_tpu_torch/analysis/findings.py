"""Finding model, inline suppressions, and the checked-in baseline.

Counterpart of ``chainermn_tpu/analysis/findings.py``, a copy: the same
fingerprints, so one finding has one identity in both packages.  The
port's own tree keeps its baselines inside the package
(``chainermn_tpu_torch/.spmd-lint-baseline.json``), which
:func:`find_baseline` reaches first when it walks up from a path of
the port.

A finding is identified across commits by a **fingerprint** over (rule,
path, enclosing scope, normalized source line) — deliberately NOT the line
number, so unrelated edits above a finding don't churn the baseline.

Suppression surfaces, most local first:

* ``# spmd-lint: disable=rule1,rule2`` on the offending line;
* ``# spmd-lint: disable-next-line=rule`` on the line above;
* ``# spmd-lint: disable-file=rule`` anywhere in the first 10 lines of a
  file (for e.g. profile scripts whose constant seeds are the point);
* a baseline entry (``.spmd-lint-baseline.json``) carrying a ``comment``
  saying WHY the finding is accepted — regenerate intentionally with
  ``--fix-baseline``.

Pure stdlib: this module imports neither torch nor jax.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: Ordered weakest → strongest; exit-code policy treats every severity as
#: a finding, severity is for human triage.
SEVERITIES = ("info", "warning", "error")

BASELINE_FILENAME = ".spmd-lint-baseline.json"
_BASELINE_VERSION = 1

_SUPPRESS_RE = re.compile(
    r"#\s*spmd-lint:\s*(disable|disable-next-line|disable-file)\s*="
    r"\s*([A-Za-z0-9_,\- ]+)")


@dataclass
class Finding:
    rule: str
    severity: str
    path: str          # as given to the engine (normalized to repo-relative
    #                    by the CLI before printing/baselining)
    line: int          # 1-based
    message: str
    context: str = ""  # enclosing qualname, e.g. "ServingEngine.step"
    snippet: str = ""  # stripped source of the offending line

    def fingerprint(self) -> str:
        norm = re.sub(r"\s+", " ", self.snippet).strip()
        h = hashlib.sha1(
            "\x1f".join([self.rule, self.path.replace(os.sep, "/"),
                         self.context, norm]).encode()).hexdigest()
        return h[:16]

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path.replace(os.sep, "/"),
            "line": self.line,
            "context": self.context,
            "message": self.message,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        ctx = f" [{self.context}]" if self.context else ""
        return (f"{where}: {self.severity}: {self.rule}{ctx}: "
                f"{self.message}\n    {self.snippet}")


class Suppressions:
    """Per-file inline suppression table, parsed once from source lines."""

    def __init__(self, source: str):
        self._line: Dict[int, set] = {}
        self._file: set = set()
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            kind, rules = m.group(1), {
                r.strip() for r in m.group(2).split(",") if r.strip()}
            if kind == "disable":
                self._line.setdefault(i, set()).update(rules)
            elif kind == "disable-next-line":
                self._line.setdefault(i + 1, set()).update(rules)
            elif kind == "disable-file" and i <= 10:
                self._file.update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self._file or "all" in self._file:
            return True
        rules = self._line.get(line, ())
        return rule in rules or "all" in rules


@dataclass
class Baseline:
    """Accepted findings, keyed by fingerprint; survives line shifts."""

    entries: Dict[str, Dict] = field(default_factory=dict)
    path: Optional[str] = None

    def accepts(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.entries

    def filter(self, findings: Iterable[Finding]
               ) -> Tuple[List[Finding], List[Finding]]:
        """Split into (new, accepted-by-baseline).

        COUNT-AWARE: textually identical violations in the same scope
        share a fingerprint, so each entry accepts at most its recorded
        ``count`` occurrences (default 1) — a new duplicate of a
        baselined line is a NEW finding, not a free pass."""
        new, accepted = [], []
        seen: Dict[str, int] = {}
        for f in findings:
            fp = f.fingerprint()
            entry = self.entries.get(fp)
            allowed = int(entry.get("count", 1)) if entry else 0
            seen[fp] = seen.get(fp, 0) + 1
            (accepted if seen[fp] <= allowed else new).append(f)
        return new, accepted

    @staticmethod
    def from_findings(findings: Iterable[Finding],
                      comments: Optional[Dict[str, str]] = None,
                      path: Optional[str] = None) -> "Baseline":
        entries: Dict[str, Dict] = {}
        for f in findings:
            d = f.to_dict()
            fp = d.pop("fingerprint")
            d.pop("line")  # line numbers churn; fingerprint is the identity
            if fp in entries:
                entries[fp]["count"] += 1
                continue
            d["comment"] = (comments or {}).get(fp, "")
            d["count"] = 1
            entries[fp] = d
        return Baseline(entries=entries, path=path)

    def merge_comments_from(self, other: "Baseline") -> None:
        """Keep human-written comments across --fix-baseline regens."""
        for fp, entry in self.entries.items():
            old = other.entries.get(fp)
            if old and old.get("comment") and not entry.get("comment"):
                entry["comment"] = old["comment"]

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("baseline has no path")
        doc = {"version": _BASELINE_VERSION,
               "tool": "chainermn_tpu_torch.analysis",
               "findings": [dict(fingerprint=fp, **e)
                            for fp, e in sorted(self.entries.items(),
                                                key=lambda kv: (
                                                    kv[1]["path"],
                                                    kv[1]["rule"],
                                                    kv[0]))]}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=False)
            fh.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path


def load_baseline(path: str) -> Baseline:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != _BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {doc.get('version')!r} in {path}")
    entries = {}
    for e in doc.get("findings", []):
        e = dict(e)
        fp = e.pop("fingerprint")
        entries[fp] = e
    return Baseline(entries=entries, path=path)


def find_baseline(start: str,
                  filename: str = BASELINE_FILENAME) -> Optional[str]:
    """Walk up from ``start`` looking for a checked-in baseline file —
    linter-config discovery, so the CLI works from any cwd.  One walk
    serves both baselines (``filename``: the spmd-lint default here, the
    shard-flow one via ``shardflow.find_shardflow_baseline``)."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        cand = os.path.join(d, filename)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent
