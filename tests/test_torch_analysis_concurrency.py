"""The port's concurrency lint (``analysis/concurrency.py``) and lock-order
recorder (``analysis/lockassert.py``) against the JAX package's (CPU).

* **parity:** both engines give identical findings on every
  ``tests/fixtures/concurrency/*`` fixture and on the JAX tree, and equal
  ``lock_graph`` / ``lock_sites`` there;
* **the torch idiom:** waiting for the card under a lock
  (``torch.cuda.synchronize()``, ``.item()``) is a blocking call in a
  module that imports torch (``tests/fixtures/torch_lint/
  card_sync_under_lock``), and nowhere else;
* **the port's tree** is clean modulo its own
  ``chainermn_tpu_torch/.concurrency-baseline.json``; every entry still
  matches; the CLI keeps the 0/1/2 contract;
* **the recorder:** in a child process (``tests/_torch_lock_worker.py``)
  over a CPU serving run — the engine's driver thread and a two-replica
  router, 16 requests — ``assert_consistent`` passes, and the tokens are
  the greedy ``lm_generate``'s; in this process the port's recorder and
  JAX's stack in either order without double-wrapping a lock or hiding
  one from the other, and a dynamic edge that closes a cycle with the
  static graph is caught.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from chainermn_tpu.analysis import concurrency as JC
from chainermn_tpu.analysis import lockassert as JL
from chainermn_tpu_torch.analysis import concurrency as TC
from chainermn_tpu_torch.analysis import lockassert as TL
from chainermn_tpu_torch.analysis.findings import load_baseline


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "chainermn_tpu_torch")
BASELINE = os.path.join(PORT, ".concurrency-baseline.json")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "concurrency")
TWIN = os.path.join(REPO, "tests", "fixtures", "torch_lint",
                    "card_sync_under_lock")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(findings):
    return sorted((f.rule, f.severity, os.path.relpath(f.path, REPO),
                   f.line, f.fingerprint()) for f in findings)


@pytest.mark.parametrize("fixture", sorted(os.listdir(FIXTURES)))
def test_engines_agree_on_every_fixture(fixture):
    d = os.path.join(FIXTURES, fixture)
    for name in sorted(os.listdir(d)):
        if name.endswith(".py"):
            path = os.path.join(d, name)
            assert _key(TC.analyze_file(path)) == _key(JC.analyze_file(path))


@pytest.mark.parametrize("tree", ["chainermn_tpu", "examples", "scripts"])
def test_engines_agree_on_the_jax_tree(tree):
    path = os.path.join(REPO, tree)
    assert _key(TC.analyze_paths([path])) == _key(JC.analyze_paths([path]))


def test_lock_graph_and_sites_agree_on_the_jax_tree():
    path = os.path.join(REPO, "chainermn_tpu")
    tsites, tgraph = TC.analyze_lock_surface([path])
    jsites, jgraph = JC.analyze_lock_surface([path])
    assert tgraph == jgraph and tsites == jsites
    assert len(tsites) >= 20


def test_card_sync_under_lock_fires_in_torch_modules_only():
    bad = TC.analyze_file(os.path.join(TWIN, "bad.py"))
    assert [(f.rule, f.line) for f in bad] == [
        ("blocking-call-under-lock", 16), ("blocking-call-under-lock", 17)]
    assert "waits for the card" in bad[0].message
    assert TC.analyze_file(os.path.join(TWIN, "clean.py")) == []
    assert JC.analyze_file(os.path.join(TWIN, "bad.py")) == []
    # numpy's .item() under a lock is no card wait
    src = open(os.path.join(TWIN, "bad.py")).read()
    no_torch = src.replace("import torch\n", "").replace(
        "torch.cuda.synchronize()", "pass")
    assert TC.analyze_source(no_torch, "t.py") == []


@pytest.fixture(scope="module")
def port_findings():
    findings = TC.analyze_paths([PORT])
    for f in findings:
        f.path = os.path.relpath(os.path.abspath(f.path), PORT)
    return findings


def test_port_tree_clean_modulo_its_baseline(port_findings):
    new, accepted = load_baseline(BASELINE).filter(port_findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert len(accepted) >= 4


def test_every_port_baseline_entry_still_matches(port_findings):
    baseline = load_baseline(BASELINE)
    _, accepted = baseline.filter(port_findings)
    hit = {f.fingerprint() for f in accepted}
    assert set(baseline.entries) == hit


def test_port_lock_surface_is_acyclic():
    sites, graph = TC.analyze_lock_surface([PORT])
    assert len(sites) >= 20
    assert TL.find_cycle(graph) is None


def test_concurrency_cli_exit_contract(tmp_path, capsys):
    lanes = os.path.join(PORT, "serving", "lanes.py")
    assert TC.main([lanes]) == 0
    doc = json.load(open(BASELINE))
    doc["findings"] = [e for e in doc["findings"]
                       if e["path"] != "serving/lanes.py"]
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps(doc))
    assert TC.main(["--baseline", str(bl), lanes]) == 1
    assert "blocking-call-under-lock" in capsys.readouterr().out
    assert TC.main([str(tmp_path / "missing")]) == 2
    assert TC.main(["--rules", "nope", lanes]) == 2


def test_recorder_over_a_serving_run(tmp_path):
    """The recorder in a child process over the engine's driver thread and
    a two-replica router: no cycle, every request served, tokens the
    greedy generator's."""
    from chainermn_tpu_torch.parallel.decode import lm_generate
    from chainermn_tpu_torch.parallel.transformer import \
        init_tp_transformer_lm

    out = tmp_path / "out.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("CHAINERMN_TPU_LOCK_ASSERT", None)
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tests", "_torch_lock_worker.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, (r.stderr[-3000:], out.read_text()
                               if out.exists() else None)
    res = json.loads(out.read_text())
    assert res["n_tracked"] >= 10
    assert res["status"] == ["done"] * 16
    assert isinstance(res["dynamic"], list)
    for edge in res["dynamic"]:
        assert len(edge) == 2 and all(isinstance(n, str) for n in edge)
    params = init_tp_transformer_lm(torch.Generator().manual_seed(0), 64, 32,
                                    4, 2, max_len=64, device="cpu")
    for prompt, toks in zip(res["prompts"], res["tokens"]):
        want = lm_generate(params, torch.tensor([prompt]), head_dim=8,
                           max_new_tokens=4)
        assert toks == want[0].tolist()


def _fresh_locks():
    """One lock created in each package (their comm ledgers' locks)."""
    from chainermn_tpu.observability.comm import CommAccountant as JA
    from chainermn_tpu_torch.observability.comm import CommAccountant as TA
    return TA()._lock, JA()._lock


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_recorders_stack_without_clash(order):
    """Both recorders live at once, installed in either order: each
    tracks its own package's locks, none is wrapped twice, and both come
    off leaving ``threading.Lock`` as it was."""
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    jrec = JL.LockOrderRecorder()
    trec = TL.LockOrderRecorder()
    first, second = (jrec, trec) if order == "jax_first" else (trec, jrec)
    try:
        first.install()
        second.install()
        tlock, jlock = _fresh_locks()
        assert isinstance(tlock, TL._TrackedLock)
        assert isinstance(jlock, JL._TrackedLock)
        assert not isinstance(tlock._inner, (TL._TrackedLock,
                                             JL._TrackedLock))
        assert not isinstance(jlock._inner, (TL._TrackedLock,
                                             JL._TrackedLock))
        assert tlock._site[0].startswith(PORT + os.sep)
        assert jlock._site[0].startswith(os.path.join(REPO, "chainermn_tpu")
                                         + os.sep)
        # a lock created elsewhere stays native for both
        other = threading.Lock()
        assert not isinstance(other, (TL._TrackedLock, JL._TrackedLock))
        with tlock:
            with jlock:
                pass
        assert trec.n_tracked == 1 and jrec.n_tracked == 1
    finally:
        second.uninstall()
        first.uninstall()
    assert threading.Lock is orig_lock and threading.RLock is orig_rlock


def test_recorders_come_off_in_any_order():
    orig_lock = threading.Lock
    jrec, trec = JL.LockOrderRecorder(), TL.LockOrderRecorder()
    try:
        trec.install()
        jrec.install()
        trec.uninstall()            # the one beneath comes off first
        tlock, jlock = _fresh_locks()
        assert isinstance(jlock, JL._TrackedLock)
        assert not isinstance(tlock, (TL._TrackedLock, JL._TrackedLock))
    finally:
        jrec.uninstall()
        trec.uninstall()
    assert threading.Lock is orig_lock


def test_dynamic_edge_closing_a_static_cycle_is_caught(tmp_path):
    """A dynamic order the AST cannot see that closes a static path is a
    latent deadlock: ``assert_consistent`` names the cycle."""
    mod = tmp_path / "pkg"
    mod.mkdir()
    src = ("import threading\n"
           "class Pair:\n"
           "    def __init__(self):\n"
           "        self.a = threading.Lock()\n"
           "        self.b = threading.Lock()\n"
           "    def ab(self):\n"
           "        with self.a:\n"
           "            with self.b:\n"
           "                pass\n")
    (mod / "pair.py").write_text(src)
    rec = TL.LockOrderRecorder(root=str(mod))
    sys.path.insert(0, str(mod))
    try:
        rec.install()
        import pair
        p = pair.Pair()
        with p.b:                   # the reverse order, at run time
            with p.a:
                pass
    finally:
        rec.uninstall()
        sys.path.remove(str(mod))
        sys.modules.pop("pair", None)
    with pytest.raises(AssertionError, match="CHAINERMN_TPU_TORCH_LOCK"):
        TL.assert_consistent(rec, [str(mod)])


def test_env_var_is_the_ports_own(monkeypatch):
    assert TL.ENV_VAR == "CHAINERMN_TPU_TORCH_LOCK_ASSERT" != JL.ENV_VAR
    monkeypatch.setenv(JL.ENV_VAR, "1")
    monkeypatch.delenv(TL.ENV_VAR, raising=False)
    assert TL.install_from_env() is None
