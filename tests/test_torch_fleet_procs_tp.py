"""The port's worker-process fleet at TP = 2 vs the JAX package's, on the
CPU.

JAX's worker process meshes every device it sees, so under ``serve
--devices 2 --tp 2 --fleet-procs 2`` each JAX worker serves at a model
width of 2.  In the port a model rank is a process: each worker is a group
of two processes over gloo, its leader holding the lease and speaking on
the lanes, its follower running the leader's plan.  Held here:

* ``serve --devices 2 --tp 2`` with ``--fleet-procs 2`` and with
  ``--disagg 1:1 --procs`` against the JAX CLI at ``--devices 2 --tp 2``:
  JAX's summary keys, JAX's ``FleetRouter`` metric keys, JAX's tokens, one
  exit code a worker under JAX's names, every rank of every group exiting
  0, the backend in the summary;
* ``build_proc_fleet(tp=2)`` with the causal journal on: tokens equal to
  JAX's ``lm_generate``, ``rolling_upgrade`` replacing each group by a
  group of the next generation with nothing shed, a drain that ends every
  rank with 0, a merged journal that passes JAX's conformance monitor and
  that no follower wrote to, and no process left;
* chaos on a fleet of three groups: a SIGKILLed follower ends its group
  (the leader stops beating and exits ``GROUP_LOST_RC``), the lease
  expires and its requests fail over, each ending once; a SIGKILLed
  leader takes its follower down within :data:`FOLLOWER_BOUND_S`.

Budget: every spawned group has its own deadline (``TIMEOUT_S``); the file
runs in about a minute and a half on 8 cores, torch in one thread here and
in every rank.
"""

import json
import os
import re
import signal
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_lm_generator
from chainermn_tpu_torch.convert import from_jax, tree_map
from chainermn_tpu_torch.observability import journal as tjr
from chainermn_tpu_torch.serving import build_proc_fleet, rolling_upgrade
from chainermn_tpu_torch.serving import worker as tworker

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet import _jax_fleet_metric_keys  # noqa: E402

VOCAB, D, HEADS, LAYERS = 32, 16, 4, 2
HEAD_DIM = D // HEADS
NEW = 6
TIMEOUT_S = 90            # a group's bound: spawn to its last exit
#: a follower's exit after its leader's SIGKILL: PR_SET_PDEATHSIG at
#: once, the parent-pid watch within LEADER_WATCH_S; the rest is slack
#: for a loaded host
FOLLOWER_BOUND_S = 2.0
WK = dict(n_slots=2, max_total=24, queue_capacity=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here and in every rank this file spawns."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


_STATE = {}


def _model():
    if "model" not in _STATE:
        jp = jax_init(jax.random.PRNGKey(0), VOCAB, D, HEADS, LAYERS,
                      max_len=64, pos_impl="rope")
        host = jax.tree_util.tree_map(np.asarray, jp)
        _STATE["model"] = (jp, from_jax(host, device="cpu"))
    return _STATE["model"]


def _oracle(prompts):
    """JAX ``lm_generate``'s greedy tokens (one device)."""
    jp, _ = _model()
    mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
    gen = make_lm_generator(mesh, "model", head_dim=HEAD_DIM,
                            max_new_tokens=NEW)
    return np.asarray(gen(jp, np.stack(prompts))).tolist()


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, 5).astype(np.int32) for _ in range(n)]


def _alive(pid):
    """A process that runs (a zombie is dead: it holds nothing)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def _group_pids(router):
    """Every worker's group pids (leader first), from its leases."""
    return {name: list(wc.last_lease["group"]["pids"])
            for name, wc in router.workers.items()
            if wc.last_lease and "group" in wc.last_lease}


def _up(tmp_path, n, **kw):
    router = build_proc_fleet(_model()[1], {"engine": n},
                              str(tmp_path / "lanes"), head_dim=HEAD_DIM,
                              device="cpu", tp=2, beat_interval_s=0.1,
                              miss_beats=10, worker_kwargs=dict(WK), **kw)
    t0 = time.monotonic()
    try:
        while (any(w.state != "live" for w in router.workers.values())
               or len(_group_pids(router)) < n):
            assert time.monotonic() - t0 < TIMEOUT_S, "groups never live"
            router.step()
            time.sleep(0.005)
    except BaseException:
        _down(router, {})
        raise
    return router, _group_pids(router)


def _down(router, pids):
    """Reap every leader (the router's shutdown kills one that outlives
    the deadline) and kill any rank still running; returns the exit
    codes and the ranks that were still alive."""
    try:
        codes = router.shutdown(timeout_s=TIMEOUT_S / 3)
    finally:
        router.close()
        left = [p for ps in pids.values() for p in ps if _alive(p)]
        for p in left:
            os.kill(p, signal.SIGKILL)
    return codes, left


def _serve(router, prompts):
    handles = [router.submit(p, NEW) for p in prompts]
    for h in handles:
        assert h.wait(TIMEOUT_S), f"request {h.id} never ended"
    return handles


# ---------------------------------------------------------------------------
# a clean fleet of two groups: tokens, drain, journal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """Two groups serve 4 requests; ``rolling_upgrade`` replaces both
    groups with a generation 2 of the same weights, re-saved with the
    embedding row-sharded over 2 shards; one more request; every worker
    drains."""
    tmp = tmp_path_factory.mktemp("clean")
    jdir = str(tmp / "journal")
    router, pids = _up(tmp, 2, journal_dir=jdir)
    try:
        router.start()
        prompts = _prompts(5, 4)
        handles = _serve(router, prompts)
        tp = _model()[1]
        layout = tree_map(tp, lambda t: None)
        layout["embed"] = 0
        shards = [dict(tp, embed=torch.chunk(tp["embed"], 2, dim=0)[i])
                  for i in range(2)]
        upgrade = rolling_upgrade(router, None, shards, layout,
                                  generation=2, head_dim=HEAD_DIM,
                                  timeout_s=TIMEOUT_S)
        pids.update(_group_pids(router))
        after = _serve(router, prompts[:1])[0]
        router.stop()
        drained = {}
        for name, wc in list(router.workers.items()):
            if wc.state in ("starting", "live"):
                router.drain(name)
                drained[name] = router.wait_drained(name,
                                                    timeout_s=TIMEOUT_S)
        group = dict(router.group)
        states = {n: w.state for n, w in router.workers.items()}
    finally:
        codes, left = _down(router, pids)
        tjr.reset()
    return {"prompts": prompts, "handles": handles, "drained": drained,
            "codes": codes, "left": left, "pids": pids, "jdir": jdir,
            "group": group, "upgrade": upgrade, "after": after,
            "states": states}


def test_group_fleet_tokens_equal_jax(clean):
    assert clean["group"] == {"tp": 2, "backend": "gloo"}
    assert [h.status for h in clean["handles"]] == ["done"] * 4
    assert [h.tokens for h in clean["handles"]] == _oracle(clean["prompts"])


def test_group_fleet_drain_exits_every_rank_zero(clean):
    """A leader's code is nonzero when any of its ranks' is: 0 here is
    every rank's 0, the upgrade's drained groups' too.  No rank outlives
    the fleet."""
    names = ["engine0", "engine0.g2", "engine1", "engine1.g2"]
    assert clean["drained"] == {"engine0.g2": True, "engine1.g2": True}
    assert clean["states"] == dict.fromkeys(names, "drained")
    assert clean["codes"] == dict.fromkeys(names, 0)
    assert sorted(clean["pids"]) == names
    assert all(len(p) == 2 for p in clean["pids"].values())
    assert clean["left"] == []


def test_rolling_upgrade_replaces_whole_groups(clean):
    """Each old group drained behind a live replacement group of the new
    generation (two processes, spawned as the originals were): nothing
    shed, and the first prompt decodes as before."""
    up = clean["upgrade"]
    assert up["generation"] == 2 and up["drain_shed"] == 0
    assert up["upgraded"] == [{"old": "engine0", "new": "engine0.g2"},
                              {"old": "engine1", "new": "engine1.g2"}]
    assert clean["after"].status == "done"
    assert clean["after"].tokens == clean["handles"][0].tokens


def test_group_fleet_journal_passes_jax_conformance(clean):
    """The merged journal (the router and the two leaders) passes JAX's
    conformance monitor; the followers wrote none of it."""
    from chainermn_tpu.observability.conform import check_dir, render_report

    report = check_dir(clean["jdir"])
    assert report["ok"], render_report(report)
    assert report["checked"]["done_xor_shed"] == 5
    assert report["checked"]["lease_fence"] >= 4
    names = ["engine0", "engine0.g2", "engine1", "engine1.g2"]
    assert sorted(os.listdir(clean["jdir"])) == sorted(
        [f"journal.{n}.jsonl" for n in names] + ["journal.router.jsonl"])
    merged = tjr.merge_journals(clean["jdir"])
    assert merged["procs"] == names + ["router"]
    # one writer a file: a follower journaling under its worker's name
    # would repeat the leader's sequence numbers
    for name in names:
        with open(os.path.join(clean["jdir"], f"journal.{name}.jsonl")) as f:
            seqs = [json.loads(line)["seq"] for line in f if line.strip()]
        assert seqs == list(range(1, len(seqs) + 1)), name


# ---------------------------------------------------------------------------
# chaos on three groups: a follower and a leader SIGKILLed mid-run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    router, pids = _up(tmp, 3)
    try:
        router.start()
        prompts = _prompts(8, 9)
        handles = [router.submit(p, NEW) for p in prompts]
        t0 = time.monotonic()
        while router.metrics()["fleet/tokens_total"] < 6:
            assert time.monotonic() - t0 < TIMEOUT_S, "no progress"
            time.sleep(0.005)
        follower, leader = pids["engine0"][1], pids["engine1"][0]
        os.kill(follower, signal.SIGKILL)
        os.kill(leader, signal.SIGKILL)
        t_kill = time.monotonic()
        gone = {}
        while len(gone) < 1 and time.monotonic() - t_kill < TIMEOUT_S:
            if not _alive(pids["engine1"][1]):
                gone["engine1_follower"] = time.monotonic() - t_kill
            time.sleep(0.01)
        for h in handles:
            assert h.wait(TIMEOUT_S), f"request {h.id} never ended"
        router.stop()
        m = router.metrics()
        states = {n: w.state for n, w in router.workers.items()}
        router.drain("engine2")
        drained = router.wait_drained("engine2", timeout_s=TIMEOUT_S)
    finally:
        codes, left = _down(router, pids)
    return {"prompts": prompts, "handles": handles, "metrics": m,
            "states": states, "codes": codes, "left": left,
            "gone": gone, "drained": drained, "results": router._results}


def test_follower_sigkill_expires_lease_and_fails_over(chaos):
    """engine0's follower killed: its leader stops beating and exits
    GROUP_LOST_RC, the router finds the lease expired, and the requests
    fail over to the survivor: every request ends once, done, with JAX's
    tokens."""
    assert chaos["states"]["engine0"] == "dead"
    assert chaos["codes"]["engine0"] == tworker.GROUP_LOST_RC
    assert chaos["metrics"]["fleet/dead_workers"] == 2
    assert chaos["metrics"]["fleet/redispatched_total"] >= 1
    hs = chaos["handles"]
    assert [h.status for h in hs] == ["done"] * len(hs)
    assert chaos["results"] == len(hs)          # one result a request
    assert [h.tokens for h in hs] == _oracle(chaos["prompts"])
    assert chaos["drained"] and chaos["codes"]["engine2"] == 0
    assert chaos["left"] == []


def test_leader_sigkill_takes_followers_down(chaos):
    assert chaos["states"]["engine1"] == "dead"
    assert chaos["codes"]["engine1"] == -signal.SIGKILL
    assert chaos["gone"]["engine1_follower"] < FOLLOWER_BOUND_S
    assert chaos["left"] == []


def test_group_backend_rule(monkeypatch):
    """gloo on the CPU and for ranks that share a card, NCCL when each
    rank has its own."""
    from chainermn_tpu_torch.serving import worker

    assert worker.group_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert worker.group_backend("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert worker.group_backend("cuda", 2) == "nccl"
    assert worker.group_backend("cuda", 8) == "gloo"


# ---------------------------------------------------------------------------
# the CLI against JAX's
# ---------------------------------------------------------------------------

_PROMPT_LINE = re.compile(r"^prompt \[.*\] -> (\[.*\]) \(true", re.M)
CLI = ["--devices", "2", "--tp", "2", "--train-steps", "0", "--requests",
       "4"]


def _jax_cli(capsys, monkeypatch):
    """JAX's ``serve --devices 2 --tp 2`` in this process, once: its
    summary and tokens.  JAX's engine path at the same flags, without the
    worker processes: at this width JAX's own worker processes outlive
    their lease window while they compile on a loaded CPU host and shed
    what they hold (ROADMAP.md §C), while the model, the prompts and the
    greedy tokens are the same whatever the topology."""
    if "jax_cli" not in _STATE:
        from chainermn_tpu.serve import main as jax_main

        # JAX's --devices appends to XLA_FLAGS: restored after the test
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
        assert jax_main(CLI) == 0
        cap = capsys.readouterr()
        _STATE["jax_cli"] = (
            json.loads(cap.out.strip().splitlines()[-1]),
            [json.loads(m) for m in _PROMPT_LINE.findall(cap.err)])
    return _STATE["jax_cli"]


@pytest.mark.parametrize("topology", [["--fleet-procs", "2"],
                                      ["--disagg", "1:1", "--procs"]],
                         ids=["fleet_procs", "disagg_procs"])
def test_serve_cli_devices_tp2_procs_equal_jax(topology, capsys,
                                               monkeypatch):
    """The port's CLI at the JAX CLI's argv plus the topology: JAX's
    summary keys, JAX's ``FleetRouter`` metric keys and goodput keys, and
    the JAX CLI's tokens at the same flags."""
    from chainermn_tpu.observability.slo import GoodputLedger
    from chainermn_tpu_torch.serve import run as torch_run

    # the JAX CLI's init (its defaults: vocab 64, d 32, 4 heads, 2 layers,
    # max_len = max(seq_len 24, prompt 6 + new 8)); the port's run goes
    # on a thread beside JAX's
    init = jax.tree_util.tree_map(np.asarray, jax_init(
        jax.random.PRNGKey(0), 64, 32, 4, 2, max_len=24))
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "got", torch_run([*CLI, *topology], params=init)))
    th.start()
    try:
        want, want_tokens = _jax_cli(capsys, monkeypatch)
    finally:
        th.join(TIMEOUT_S * 2)
    got = out["got"]
    # JAX's summary keys, the port's own four, and the workers' group
    assert set(got) == set(want) | {"device", "dtype", "tp", "world",
                                    "fleet_group"}
    assert got["fleet_group"] == {"tp": 2, "backend": "gloo"}
    assert got["tp"] == 2 and got["world"] == 2 and got["device"] == "cpu"
    assert got["fleet_procs"] == 2
    # one code a worker (JAX's names), every rank of every group 0
    names = (["engine0", "engine1"] if "--fleet-procs" in topology
             else ["prefill0", "decode0"])
    assert got["fleet_exit_codes"] == dict.fromkeys(names, 0)
    assert [r["tokens"] for r in got["requests"]] == want_tokens
    assert all(r["status"] == "done" for r in got["requests"])
    assert set(got["metrics"]) == _jax_fleet_metric_keys()
    assert set(got["goodput"]) == set(GoodputLedger().report())
    assert got["metrics"]["fleet/shed_rate"] == 0
    assert got["metrics"]["fleet/redispatched_total"] == 0
