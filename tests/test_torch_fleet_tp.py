"""The port's in-process serving fleets at TP = 2 vs the JAX package's, on
the CPU.

JAX runs every worker or replica of a fleet on one 2-device mesh in one
process.  The port runs the same fleet in two gloo processes (one launch
for every case, ``tests/_torch_fleet_tp_worker.py``): model rank 0 hosts
the router and every engine, rank 1 builds the same fleet and follows its
one plan.  The same JAX-initialised weights (sharded by
``convert.shard_from_jax``) and prompts go through both:

* ``build_disagg_fleet`` (GQA, RoPE) with both transports, JAX's fuzz
  schedule (12 staggered requests over 2:2 workers that recycle their
  slots), and sampled requests over the lanes: every token equal, every
  allocator drained;
* the lanes' ledger row at TP = 2: the global slab's bytes, equal to
  JAX's;
* a prefill worker killed mid-transfer (a permanent fault on the first
  publish lane): the victim dead with a bundle naming the lane, the
  request requeued on the survivor, tokens as JAX's chaos test states;
* ``build_fleet(2)`` (prefix cache on): every token equal;
* both fleets under ``start()`` (threads announcing device calls at
  once), and a leader whose loop raises: its follower still returns;
* a spilled prefix packed for a pull (``pack_spilled``): the global slab
  of the ranks' spilled columns, the TP = 1 engine's rows;
* ``serve --devices 2 --tp 2`` with ``--disagg 1:1`` and ``--replicas 2``
  against JAX's CLI at the same flags: JAX's summary keys, equal tokens.
"""

import json
import os
import pickle
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu import observability as jobs
from chainermn_tpu.communicators.base import (
    set_lane_fault_injector as jax_set_lane_fault_injector)
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import make_lm_generator as jax_generator
from chainermn_tpu.serving import build_disagg_fleet as jax_disagg
from chainermn_tpu.serving import build_fleet as jax_fleet
from chainermn_tpu.serving.transfer import LANE_AXIS, LANE_OP, transfer_cost

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_functions import launch  # noqa: E402

WORLD = 2
VOCAB, D, HEADS, LAYERS, KV_HEADS = 32, 16, 4, 2, 2
HEAD_DIM = D // HEADS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=64, pos_impl="rope", n_kv_heads=KV_HEADS)
    return jax.tree_util.tree_map(np.asarray, jp)


def _mesh():
    return mn.make_nd_mesh(("model",), (WORLD,), jax.devices()[:WORLD])


def _inputs():
    params = _params()
    rng = np.random.RandomState(5)
    fuzz_prompts = [rng.randint(0, VOCAB, rng.randint(3, 7)).astype(np.int32)
                    for _ in range(12)]
    fuzz_new = [int(rng.randint(2, 8)) for _ in range(12)]
    fuzz_kw = dict(head_dim=HEAD_DIM, max_total=16, n_slots=3,
                   staging_slots=2, queue_capacity=16)
    rng = np.random.RandomState(3)
    sampled = [rng.randint(0, VOCAB, 5).astype(np.int32) for _ in range(4)]
    temps = (0.0, 0.7, 1.3, 0.7)
    keys = [None if t == 0 else np.asarray(jax.random.PRNGKey(100 + i))
            for i, t in enumerate(temps)]
    rng = np.random.RandomState(1)
    chaos = [rng.randint(0, VOCAB, 5).astype(np.int32) for _ in range(4)]
    base = dict(params=params, stagger=0)
    disagg = {
        "fuzz_local": dict(base, p=2, d=2, prompts=fuzz_prompts,
                           max_new=fuzz_new, sample=[None] * 12, stagger=3,
                           budget=600, kw=dict(fuzz_kw,
                                               transport_mode="local")),
        "fuzz_lanes": dict(base, p=2, d=2, prompts=fuzz_prompts,
                           max_new=fuzz_new, sample=[None] * 12, stagger=3,
                           budget=600, ledger=True,
                           kw=dict(fuzz_kw, transport_mode="lanes")),
        "sampled_lanes": dict(
            base, p=1, d=1, prompts=sampled, max_new=[6] * 4,
            sample=[None if k is None else (t, k)
                    for t, k in zip(temps, keys)], budget=400,
            kw=dict(head_dim=HEAD_DIM, max_total=16, n_slots=4,
                    staging_slots=2, queue_capacity=8,
                    transport_mode="lanes")),
        "chaos": dict(base, p=2, d=1, prompts=chaos, max_new=[5] * 4,
                      sample=[None] * 4, budget=600, chaos=True,
                      kw=dict(head_dim=HEAD_DIM, max_total=16, n_slots=3,
                              staging_slots=2, queue_capacity=8,
                              transport_mode="lanes")),
    }
    rng = np.random.RandomState(1)
    heads = [rng.randint(0, VOCAB, 6).astype(np.int32) for _ in range(4)]
    # the later wave shares the first wave's 4-token prefixes: prefix hits
    # on the replica that holds them
    tails = [np.concatenate([h[:4], rng.randint(0, VOCAB, 2)]).astype(
        np.int32) for h in heads]
    replicas = {"replicas_mixed": dict(
        params=params, n=2, prompts=heads + tails,
        max_new=[12, 4, 4, 4, 6, 6, 6, 6],
        sample=[None if i % 2 == 0 else
                (0.7, np.asarray(jax.random.fold_in(jax.random.PRNGKey(3),
                                                    i))) for i in range(8)],
        kw=dict(head_dim=HEAD_DIM, n_slots=4, max_total=32, queue_capacity=8,
                max_prefills_per_tick=2))}
    rng = np.random.RandomState(7)
    threads = dict(
        params=params, max_new=5,
        prompts=[rng.randint(0, VOCAB, 4).astype(np.int32)
                 for _ in range(6)],
        disagg_kw=dict(head_dim=HEAD_DIM, max_total=16, n_slots=4,
                       staging_slots=2, queue_capacity=8),
        replica_kw=dict(head_dim=HEAD_DIM, n_slots=4, max_total=16,
                        queue_capacity=8))
    return {"disagg": disagg, "replicas": replicas, "threads": threads}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("fleettp")
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    return inp, launch("_torch_fleet_tp_worker.py", "fleet", WORLD, tmp,
                       timeout=300)[0]


def _oracle(params, prompts, max_new):
    """lm_generate's greedy tokens at TP = 2, one row a prompt."""
    gen = jax_generator(_mesh(), "model", head_dim=HEAD_DIM,
                        max_new_tokens=max_new)
    return np.asarray(gen(params, np.asarray(prompts))).tolist()


_JAX = {}
_PROGS = {}


def _jax_disagg(name, case, tmp_path=None):
    """JAX's fleet at TP = 2 through the worker's schedule (once a case)."""
    if name not in _JAX:
        _JAX[name] = _run_jax_disagg(case, tmp_path)
    return _JAX[name]


def _run_jax_disagg(case, tmp_path):
    kw = dict(case["kw"])
    if case.get("chaos"):
        kw["bundle_dir"] = str(tmp_path / "bundles")
    fleet = jax_disagg(case["params"], case["p"], case["d"], mesh=_mesh(),
                       **kw)
    # fleets of one pool shape share JAX's compiled programs (compiles
    # dominate this file's time; the programs are pure functions)
    progs = _PROGS.setdefault(
        (kw["n_slots"], kw["staging_slots"], kw["max_total"]),
        {"tick": None, "prefill": {}})
    for pw in fleet.prefill_workers:
        pw.engine._prefill_progs = progs["prefill"]
    for dw in fleet.decode_workers:
        if progs["tick"] is None:
            progs["tick"] = dw.engine.engine._tick_prog
        dw.engine.engine._tick_prog = progs["tick"]
    fleet.plane._programs = _PROGS.setdefault("local", {})
    fleet.plane._inject_programs = _PROGS.setdefault("inject", {})
    fired = {"n": 0}

    def injector(lane, attempt):
        if lane.startswith("kv_transfer/put/") and fired["n"] < 1:
            fired["n"] += 1
            raise RuntimeError("injected permanent lane fault (chaos)")

    if case.get("chaos"):
        jax_set_lane_fault_injector(injector)
    if case.get("ledger"):
        jobs.reset_all()
        jobs.enable()
    try:
        hs = []
        for i, prompt in enumerate(case["prompts"]):
            kw = {}
            if case["sample"][i] is not None:
                kw = dict(temperature=case["sample"][i][0],
                          rng=case["sample"][i][1])
            hs.append(fleet.submit(prompt, case["max_new"][i], **kw))
            if case["stagger"] and i % case["stagger"] == case["stagger"] - 1:
                fleet.step()
        fleet.run(steps_budget=case["budget"])
        m = fleet.metrics()
        out = {"results": [(h.status, h.finish_reason, h.tokens)
                           for h in hs],
               "transfers": m["disagg/transfers_total"],
               "requeued": m["disagg/requeued_total"],
               "dead": [w.dead for w in fleet.prefill_workers],
               "bytes_moved": fleet.plane.bytes_moved}
        if case.get("ledger"):
            row = jobs.comm_report()["per_op"][f"{LANE_OP}@{LANE_AXIS}"]
            out["ledger"] = (row["bytes"], row["calls"])
        return out
    finally:
        jax_set_lane_fault_injector(None)
        if case.get("ledger"):
            jobs.disable()
            jobs.reset_all()
        fleet.close()


@pytest.mark.parametrize("name", ["fuzz_local", "fuzz_lanes",
                                  "sampled_lanes"])
def test_tp2_disagg_tokens_equal_jax(run, name):
    inp, out = run
    case = inp["disagg"][name]
    got = out[0][name]
    # JAX's fleet at TP = 2 is held to lm_generate by JAX's own tests
    want = _jax_disagg(name, case)
    assert got["results"] == want["results"]
    assert all(r[0] == "done" for r in got["results"]), got["results"]
    assert got["transfers"] == want["transfers"] == len(case["prompts"])
    assert got["drained"]
    # the role split is real on the leader: decode workers never prefill
    assert got["decode_prefills"] == [0] * case["d"]
    assert sum(got["prefill_calls"]) == len(case["prompts"])


def test_tp2_lanes_ledger_bytes_equal_jax(run):
    """Each lanes transfer books the GLOBAL slab's raw bytes once, on the
    leader: JAX's row, byte for byte, and the static prediction."""
    inp, out = run
    case = inp["disagg"]["fuzz_lanes"]
    got = out[0]["fuzz_lanes"]
    want = _jax_disagg("fuzz_lanes", case)
    kv_dim = KV_HEADS * HEAD_DIM
    predicted = sum(
        transfer_cost(LAYERS, len(p), kv_dim, np.float32,
                      mode="lanes")["ledger_bytes"] for p in case["prompts"])
    assert got["ledger"] == want["ledger"] == (predicted,
                                              len(case["prompts"]))
    assert got["bytes_moved"] == want["bytes_moved"] == predicted


def test_tp2_chaos_kill_prefill_worker_requeues(run, tmp_path):
    """JAX's chaos test at TP = 2: the first publish lane's permanent fault
    kills prefill0; its request re-prefills on the survivor, every token is
    lm_generate's, every pool drains, and the bundle's ring names the
    lane."""
    inp, out = run
    case = inp["disagg"]["chaos"]
    got = out[0]["chaos"]
    want = _jax_disagg("chaos", case, tmp_path)
    assert got["dead"] == want["dead"] == [True, False]
    # JAX's chaos test holds these tokens to lm_generate
    assert got["results"] == want["results"]
    assert all(r[0] == "done" for r in got["results"])
    assert got["requeued"] >= 1 and got["drained"]
    assert "kv_transfer_fault" in got["bundles"][-1]
    assert "kv_transfer/put/" in got["ring"] and "worker_lost" in got["ring"]


def test_tp2_replicas_tokens_equal_jax(run):
    inp, out = run
    case = inp["replicas"]["replicas_mixed"]
    router = jax_fleet(case["params"], case["n"], mesh=_mesh(), **case["kw"])
    try:
        def submit(i):
            kw = {}
            if case["sample"][i] is not None:
                kw = dict(temperature=case["sample"][i][0],
                          rng=case["sample"][i][1])
            return router.submit(case["prompts"][i], case["max_new"][i],
                                 **kw)
        hs = [submit(i) for i in range(4)]
        for _ in range(2):
            router.step()
        hs += [submit(i) for i in range(4, len(case["prompts"]))]
        router.run(steps_budget=400)
        want = [(h.status, h.finish_reason, h.tokens) for h in hs]
        dispatched = dict(router._dispatched_by)
    finally:
        router.close()
    got = out[0]["replicas_mixed"]
    assert got["results"] == want
    assert all(r[0] == "done" for r in want)
    assert got["dispatched_by"] == dispatched


def test_tp2_threaded_drive_is_token_exact(run):
    """Under ``start()`` several threads announce device calls at once; the
    plan's lock keeps the ranks' collectives in one order, so the tokens
    are lm_generate's and nothing hangs."""
    inp, out = run
    case = inp["threads"]
    want = _oracle(case["params"], np.stack(case["prompts"]),
                   case["max_new"])
    for kind in ("disagg", "replicas"):
        got = out[0]["threads"][kind]
        assert [s for s, _ in got] == ["done"] * len(want), (kind, got)
        assert [t for _, t in got] == want, kind


def test_tp2_followers_follow_and_leader_releases_them(run):
    """Every case on rank 1 ran the leader's ops and returned from
    ``follow()``; a leader whose loop raised still released its
    follower, and both ranks met in the next collective."""
    _, out = run
    for name, res in out[1].items():
        if name == "threads":
            for kind, r in res.items():
                assert r[0] == "followed" and r[1] > 0, (name, kind, r)
        elif name != "leader_raises":
            assert res[0] == "followed" and res[1] > 0, (name, res)
    lead, follow = out[0]["leader_raises"], out[1]["leader_raises"]
    assert lead[:2] == ("raised", "on_token failed"), lead
    assert follow[0] == "followed" and follow[1] > 0
    assert lead[-1] == follow[-1] == float(WORLD)


def test_tp2_spilled_prefix_pull_packs_the_global_slab(run):
    """A spilled prefix served to a pull at TP = 2: ``pack_spilled``
    gathers every rank's spilled columns into the global slab, whose rows
    are the TP = 1 engine's spill payload's (the same prompt and
    weights) and whose length is the prefix's."""
    from chainermn_tpu_torch.convert import from_jax
    from chainermn_tpu_torch.serving import ServingEngine
    from chainermn_tpu_torch.serving.transfer import KvTransferPlane

    inp, out = run
    case, got = inp["threads"], out[0]["spill_pull"]
    eng = ServingEngine(from_jax(case["params"], device="cpu"),
                        device="cpu", spill_bytes=1 << 20,
                        **case["replica_kw"])
    try:
        h = eng.submit(case["prompts"][0], case["max_new"])
        eng.run()
        seq = list(eng.prefix_cache.entries()[0].seq)
        eng.prefix_cache.evict_lru()
        data = KvTransferPlane.open_payload(
            eng.spill.covering(seq), eng.pool.n_layers, eng.pool.kv_dim,
            eng.pool.max_total)
    finally:
        eng.close()
    assert got["tokens"] == h.tokens and got["seq"] == seq
    assert got["length"] == int(data["pos"]) == len(seq)
    for g_kv, w_kv in zip(got["rows"], data["rows"]):
        for g, w in zip(g_kv, w_kv):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


_PROMPT_LINE = re.compile(r"^prompt \[.*\] -> (\[.*\]) \(true", re.M)


@pytest.mark.parametrize("topology", [["--disagg", "1:1"],
                                      ["--replicas", "2"]],
                         ids=["disagg", "replicas"])
def test_serve_cli_devices_tp2_matches_jax_cli(topology, capsys,
                                               monkeypatch):
    """``serve --devices 2 --tp 2`` starts its two ranks itself and prints
    JAX's summary keys with JAX's tokens.  Both serve the JAX CLI's
    initial model (``--train-steps 0``): JAX inits it from ``--seed``, the
    port loads the same weights."""
    from chainermn_tpu.serve import main as jax_main
    from chainermn_tpu_torch.serve import run as torch_run

    argv = ["--devices", "2", "--tp", "2", "--train-steps", "0",
            "--requests", "6", *topology]
    # JAX's --devices appends to XLA_FLAGS (a no-op once jax is up):
    # restored after the test so later subprocesses see this one's value
    monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    assert jax_main(argv) == 0
    cap = capsys.readouterr()
    want = json.loads(cap.out.strip().splitlines()[-1])
    want_tokens = [json.loads(m) for m in _PROMPT_LINE.findall(cap.err)]
    # the JAX CLI's init: its defaults (vocab 64, d 32, 4 heads, 2 layers,
    # max_len = max(seq_len 24, prompt 6 + new 8))
    init = jax.tree_util.tree_map(np.asarray, jax_init(
        jax.random.PRNGKey(0), 64, 32, 4, 2, max_len=24))
    got = torch_run(argv, params=init)
    assert set(want) <= set(got)
    assert got["tp"] == 2 and got["world"] == 2 and got["device"] == "cpu"
    assert [r["tokens"] for r in got["requests"]] == want_tokens
    # request ids count per process, TTFTs are wall clock
    for g, w in zip(got["requests"], want["requests"]):
        assert {k: g[k] for k in w if k not in ("id", "ttft_ms")} == \
            {k: v for k, v in w.items() if k not in ("id", "ttft_ms")}
    assert set(got["metrics"]) == set(want["metrics"])
    assert set(got["goodput"]) == set(want["goodput"])
    for key in ("engine_steps", "replicas", "disagg", "fleet_procs",
                "fleet_exit_codes", "mean_continuation_accuracy"):
        assert got[key] == want[key], key
