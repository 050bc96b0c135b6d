"""Shared baseline plumbing for the analyzer CLIs.

Counterpart of ``chainermn_tpu/analysis/baseline.py``, a copy.

The AST lint (``cli.py`` / ``.spmd-lint-baseline.json``), the shard-flow
analyzer (``shardflow.py`` / ``.shardflow-baseline.json``), and the
concurrency lint (``concurrency.py`` / ``.concurrency-baseline.json``)
all speak the same baseline dialect — findings accepted by fingerprint,
``--fix-baseline`` regeneration that preserves human comments and
carries over entries outside the invocation's scope, unreadable
baselines = exit 2.  This module is the one implementation the
port's CLIs share.

Pure stdlib — imports neither torch nor jax, like the rest of the
findings machinery.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Iterable, List, Optional, Tuple

from .findings import Baseline, Finding, find_baseline, load_baseline

#: an entry predicate for --fix-baseline scope-carrying: True = the
#: entry WAS in this invocation's scope (so absence from the fresh
#: findings means it is gone for real and must be dropped); False = the
#: entry was not re-checked and carries over untouched.
InScope = Callable[[dict], bool]


class BaselineGate:
    """One analyzer run's view of its baseline file.

    ``path`` is the resolved baseline path (may be None: no baseline
    found and none requested).  ``load()`` parses it; a broken file
    returns an error string — the caller's exit-2 condition.
    """

    def __init__(self, path: Optional[str], enabled: bool = True):
        self.path = path
        self.enabled = bool(enabled)
        self.baseline: Optional[Baseline] = None

    @staticmethod
    def resolve(explicit: Optional[str], search_start: str,
                filename: str, enabled: bool = True) -> "BaselineGate":
        """The common discovery dance: an explicit ``--baseline`` path
        wins, else the nearest ``filename`` at or above
        ``search_start``."""
        path = explicit or find_baseline(search_start, filename=filename)
        return BaselineGate(path, enabled=enabled)

    def load(self) -> Optional[str]:
        """Load the baseline if enabled and present.  Returns an error
        message when the file exists but is unreadable (exit 2), else
        None."""
        if not self.enabled or not self.path \
                or not os.path.exists(self.path):
            return None
        try:
            self.baseline = load_baseline(self.path)
        except (OSError, ValueError, KeyError) as e:
            return f"unreadable baseline {self.path}: {e}"
        return None

    def filter(self, findings: Iterable[Finding]
               ) -> Tuple[List[Finding], List[Finding]]:
        """Split into (new, accepted) — identity when no baseline."""
        findings = list(findings)
        if self.baseline is None:
            return findings, []
        return self.baseline.filter(findings)

    def fix(self, findings: Iterable[Finding], *,
            default_target: str,
            in_scope: Optional[InScope] = None,
            out=sys.stderr) -> str:
        """``--fix-baseline``: regenerate from the current findings.

        Semantics (identical across all three CLIs, tested once):

        * human-written comments on surviving entries are preserved;
        * entries ``in_scope`` says were NOT re-checked by this
          invocation (path not scanned, rule filtered out, entry point
          not selected) carry over untouched — a partial regen must
          never wipe another scope's keepers;
        * the file is written atomically (tmp + rename).

        Returns the written path.
        """
        target = self.path or default_target
        new_bl = Baseline.from_findings(findings, path=target)
        carried = 0
        if self.baseline is not None:
            for fp, e in self.baseline.entries.items():
                if in_scope is not None and not in_scope(e) \
                        and fp not in new_bl.entries:
                    new_bl.entries[fp] = dict(e)
                    carried += 1
            new_bl.merge_comments_from(self.baseline)
        new_bl.save(target)
        extra = f", {carried} out-of-scope carried over" if carried else ""
        print(f"baseline written: {target} ({len(new_bl.entries)} "
              f"accepted findings{extra})", file=out)
        return target
