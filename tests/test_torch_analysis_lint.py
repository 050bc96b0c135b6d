"""The port's SPMD lint (``analysis/ast_engine.py``, ``registry.py``,
``findings.py``, ``cli.py``) against the JAX package's (CPU).

* **parity:** both packages' AST engines give identical findings (rule,
  severity, relative path, line, fingerprint) on every
  ``tests/fixtures/spmd_lint/*`` fixture and on ``chainermn_tpu/``,
  ``examples/`` and ``scripts/``.  On a file that imports torch (the
  port's scripts) the port's engine reads the torch vocabulary too: there
  its findings are JAX's plus torch-idiom ones, each of a rule the torch
  vocabulary feeds;
* **the torch idiom:** twins of the deadlock, host-alias and PRNG fixtures
  written in torch (``tests/fixtures/torch_lint/``) fire in the port's
  engine and stay silent in their clean forms — and JAX's engine misses
  the twins' torch shapes (the vocabulary is new);
* **the registry** derives the port's surface from its own
  ``ops/collective.py`` and ``communicators/base.py``: equal to JAX's,
  plus ``torch.distributed``'s calls and ``dist.get_rank()`` taint;
* **the port's tree** is clean modulo its own baseline
  (``chainermn_tpu_torch/.spmd-lint-baseline.json``, never the root one),
  every entry still matches and states its reason;
* **the CLI** exits 0 on the port's tree, 1 after a baseline entry is
  deleted, 2 when unusable; ``--fix-baseline`` round-trips, keeps the
  comments and never touches the root baselines.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from chainermn_tpu.analysis import ast_engine as JA
from chainermn_tpu.analysis import registry as JR
from chainermn_tpu_torch.analysis import ast_engine as TA
from chainermn_tpu_torch.analysis import registry as TR
from chainermn_tpu_torch.analysis.cli import main as cli_main
from chainermn_tpu_torch.analysis.findings import (find_baseline,
                                                   load_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "chainermn_tpu_torch")
BASELINE = os.path.join(PORT, ".spmd-lint-baseline.json")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "spmd_lint")
TORCH_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_lint")

#: rules the torch vocabulary feeds
TORCH_IDIOM_RULES = {"collective-deadlock", "host-alias-race",
                     "prng-constant-key", "prng-key-reuse"}


def _key(findings):
    return sorted((f.rule, f.severity, os.path.relpath(f.path, REPO),
                   f.line, f.fingerprint()) for f in findings)


def _imports_torch(path):
    with open(path) as fh:
        src = fh.read()
    return "import torch" in src or "from torch" in src


def _py_files(root):
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("tree", ["chainermn_tpu", "examples", "scripts",
                                  "tests/fixtures/spmd_lint"])
def test_engines_agree_on_jax_sources(tree):
    files = _py_files(os.path.join(REPO, tree))
    assert files
    extras = []
    for path in files:
        want = _key(JA.analyze_file(path))
        got = _key(TA.analyze_file(path))
        if not _imports_torch(path):
            assert got == want, path
            continue
        # a torch file: JAX's findings, plus the torch vocabulary's
        assert set(want) <= set(got), path
        extras += [g for g in got if g not in want]
    assert all(e[0] in TORCH_IDIOM_RULES for e in extras), extras


@pytest.mark.parametrize("rule_dir", sorted(os.listdir(JAX_FIXTURES)))
def test_engines_agree_on_every_jax_fixture(rule_dir):
    for which in ("bad", "clean"):
        path = os.path.join(JAX_FIXTURES, rule_dir, which + ".py")
        assert _key(TA.analyze_file(path)) == _key(JA.analyze_file(path))


TWINS = {
    "collective-deadlock": ("collective_deadlock", 3),
    "host-alias-race": ("host_alias_race", 2),
    "prng-constant-key": ("prng_constant_key", 3),
    "prng-key-reuse": ("prng_key_reuse", 1),
}


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_fires(rule):
    d, n = TWINS[rule]
    hits = [f for f in TA.analyze_file(os.path.join(TORCH_FIXTURES, d,
                                                    "bad.py"))
            if f.rule == rule]
    assert len(hits) == n, [(f.line, f.message) for f in hits]


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_clean_is_silent(rule):
    d, _ = TWINS[rule]
    path = os.path.join(TORCH_FIXTURES, d, "clean.py")
    assert TA.analyze_file(path) == []


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_jax_engine_misses_the_torch_shapes(rule):
    """The twins' torch shapes are the new vocabulary: JAX's engine sees
    none of them (bar the one ``PRNGKey`` literal it always caught)."""
    d, n = TWINS[rule]
    path = os.path.join(TORCH_FIXTURES, d, "bad.py")
    hits = [f for f in JA.analyze_file(path) if f.rule == rule]
    assert len(hits) == (1 if rule == "prng-constant-key" else 0)


def test_deadlock_twin_names_each_shape():
    hits = [f for f in TA.analyze_file(os.path.join(
        TORCH_FIXTURES, "collective_deadlock", "bad.py"))]
    assert {f.context for f in hits} == {"guarded_branch", "early_exit",
                                        "rank_trip_count"}
    assert {f.snippet.split("(")[0] for f in hits} == {
        "dist.all_reduce", "dist.barrier", "dist.broadcast"}


def test_dist_vocabulary_needs_the_module():
    """A method that shares a torch.distributed name is not a collective:
    only ``dist.<name>`` / ``torch.distributed.<name>`` is."""
    code = ("import torch.distributed as dist\n"
            "def f(x, table, rank):\n"
            "    if rank == 0:\n"
            "        table.broadcast(x)\n"
            "        x.scatter(0, x, x)\n"
            "    if dist.get_rank() == 0:\n"
            "        torch.distributed.barrier()\n"
            "    return x\n")
    hits = [(f.rule, f.line) for f in TA.analyze_source(code, "t.py")]
    assert hits == [("collective-deadlock", 7)]


def test_registry_is_derived_from_the_port():
    t, j = TR.default_registry(), JR.default_registry()
    assert t.ops_collectives == j.ops_collectives
    assert t.comm_methods == j.comm_methods
    assert "host_staged" not in t.ops_collectives
    assert {"all_reduce", "barrier", "broadcast", "send",
            "recv"} <= t.dist_collectives
    assert "get_rank" in t.dist_rank_calls
    assert "axis_index" in t.rank_calls


def test_registry_picks_up_a_new_port_collective(tmp_path):
    for sub in ("ops", "communicators"):
        (tmp_path / sub).mkdir()
    src = open(os.path.join(PORT, "ops", "collective.py")).read()
    (tmp_path / "ops" / "collective.py").write_text(
        src + "\n\ndef ring_sum(x, axis_name='mn'):\n    return x\n")
    shutil.copy(os.path.join(PORT, "communicators", "base.py"),
                tmp_path / "communicators" / "base.py")
    reg = TR.default_registry(str(tmp_path))
    assert "ring_sum" in reg.ops_collectives


@pytest.fixture(scope="module")
def port_findings():
    findings = TA.analyze_paths([PORT])
    for f in findings:
        f.path = os.path.relpath(os.path.abspath(f.path), PORT)
    return findings


def test_port_tree_finds_its_own_baseline():
    assert find_baseline(PORT) == BASELINE
    assert find_baseline(os.path.join(PORT, "serving")) == BASELINE


def test_port_tree_clean_modulo_its_baseline(port_findings):
    new, accepted = load_baseline(BASELINE).filter(port_findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert len(accepted) >= 10


def test_every_port_baseline_entry_still_matches(port_findings):
    baseline = load_baseline(BASELINE)
    _, accepted = baseline.filter(port_findings)
    counts = {}
    for f in accepted:
        counts[f.fingerprint()] = counts.get(f.fingerprint(), 0) + 1
    for fp, e in baseline.entries.items():
        assert counts.get(fp) == e.get("count", 1), e["path"]


def test_every_port_baseline_entry_states_its_reason():
    for name in (".spmd-lint-baseline.json", ".concurrency-baseline.json"):
        baseline = load_baseline(os.path.join(PORT, name))
        assert baseline.entries
        for e in baseline.entries.values():
            assert len(e.get("comment", "")) > 40, (name, e["path"])


def test_cli_exit_one_after_deleting_a_baseline_entry(tmp_path, capsys):
    """The CLI over the port's files of one baselined finding each: 0
    against the port's baseline, 1 once that entry is deleted."""
    doc = json.load(open(BASELINE))
    doomed = next(e for e in doc["findings"]
                  if e["path"] == "train_transformer.py")
    target = os.path.join(PORT, doomed["path"])
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps(doc))
    assert cli_main(["--no-trace", "--baseline", str(bl), target]) == 0
    doc["findings"].remove(doomed)
    bl.write_text(json.dumps(doc))
    assert cli_main(["--no-trace", "--baseline", str(bl), target]) == 1
    out = capsys.readouterr().out
    assert doomed["path"] in out and doomed["rule"] in out


def test_cli_exit_two_when_unusable(tmp_path):
    assert cli_main(["--no-trace", str(tmp_path / "missing")]) == 2
    assert cli_main(["--no-trace", "--rules", "no-such-rule"]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert cli_main(["--no-trace", "--baseline", str(bad),
                     os.path.join(PORT, "generate.py")]) == 2
    assert cli_main(["--no-trace", "--entry", "train.step"]) == 2


def test_cli_json_and_rules_filter(capsys):
    assert cli_main(["--no-trace", "--json", "--rules",
                     "prng-constant-key",
                     os.path.join(TORCH_FIXTURES, "prng_constant_key")]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == "chainermn_tpu.spmd_lint.v1"
    assert {f["rule"] for f in doc["findings"]} == {"prng-constant-key"}
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in ("unbound-axis", "recompile-hazard", "host-alias-race",
                 "blocking-call-under-lock"):
        assert rule in listed


def test_fix_baseline_round_trip_keeps_comments(tmp_path):
    tree = tmp_path / "pkg"
    shutil.copytree(os.path.join(TORCH_FIXTURES, "prng_constant_key"), tree)
    bl = tree / ".spmd-lint-baseline.json"
    assert cli_main(["--no-trace", "--fix-baseline", str(tree)]) == 0
    doc = json.load(open(bl))
    assert len(doc["findings"]) == 3
    doc["findings"][0]["comment"] = "kept on purpose"
    bl.write_text(json.dumps(doc))
    assert cli_main(["--no-trace", str(tree)]) == 0
    assert cli_main(["--no-trace", "--fix-baseline", str(tree)]) == 0
    assert "kept on purpose" in bl.read_text()


def test_fix_baseline_never_touches_the_root_baselines(tmp_path):
    """The repo's layout in miniature: root baselines above the port's
    package.  ``--fix-baseline`` over a directory of the port regenerates
    the PORT's baselines (found first on the walk up), carries the
    entries of the files it did not scan, keeps every comment, and leaves
    the root's alone."""
    roots = {n: open(os.path.join(REPO, n)).read()
             for n in (".spmd-lint-baseline.json",
                       ".concurrency-baseline.json")}
    for n, text in roots.items():
        (tmp_path / n).write_text(text)
    port = tmp_path / "chainermn_tpu_torch"
    port.mkdir()
    for n in (".spmd-lint-baseline.json", ".concurrency-baseline.json"):
        shutil.copy(os.path.join(PORT, n), port / n)
    shutil.copytree(os.path.join(PORT, "links"), port / "links",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = json.load(open(port / ".spmd-lint-baseline.json"))
    assert cli_main(["--no-trace", "--fix-baseline",
                     str(port / "links")]) == 0
    for n, text in roots.items():
        assert (tmp_path / n).read_text() == text
    after = json.load(open(port / ".spmd-lint-baseline.json"))
    assert {e["fingerprint"]: e["comment"] for e in after["findings"]} == \
        {e["fingerprint"]: e["comment"] for e in before["findings"]}


def test_module_form_exits_zero():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "chainermn_tpu_torch.analysis",
                        "--no-trace"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "no findings" in r.stderr and "accepted by baseline" in r.stderr
