"""The port's prefix cache, host spill tier and driver loop vs JAX's engine.

JAX's ``ServingEngine`` and the port's (``device="cpu"``), both with the
prefix cache and the spill tier on (JAX's defaults), serve the same
schedules with the same weights: a shared system prompt (hits copy the
cached slot and feed the suffix through the tick; half the requests
sampled), a scavenging one (more prefixes than slots, two admissions a
tick: pinned matches, the give-up on an own match, requeues) and a
spill / restore one (a scavenged prefix spills, a later prompt restores
it, and a corrupted payload is refused and prefilled).  Every request's
tokens, every ``serving/prefix/*`` and ``serving/spill/*`` counter,
``prefill_calls`` / ``prefix_copies`` and the slots' states must be
equal.  Also: the spilled payload holds the slot's bytes, the driver
thread serves what ``run()`` serves, the engine's observability faces,
and TP = 2 over gloo (prefix hits, a spill, a restore and a refusal on
the follower's own payload) against TP = 1.
"""

import json
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.serving import ServingEngine as JaxServingEngine
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_tp_worker import prefix_schedule  # noqa: E402
from test_torch_functions import launch  # noqa: E402

VOCAB, D, HEADS, LAYERS = 64, 32, 4, 2
HEAD_DIM = D // HEADS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0, pos_impl="learned"):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=64, pos_impl=pos_impl)
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jp, host, from_jax(host, device="cpu")


def _mesh():
    return mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])


def _pair(jp, tp, **kw):
    return (JaxServingEngine(jp, head_dim=HEAD_DIM, mesh=_mesh(), **kw),
            ServingEngine(tp, head_dim=HEAD_DIM, device="cpu", **kw))


def _flip(payload):
    """One bit of the first K row flipped, the CRC stamp as packed."""
    data = pickle.loads(payload)
    k, v = data["rows"][0]
    k = np.array(k, copy=True)
    k.view(np.uint8).flat[0] ^= 1
    data["rows"][0] = (k, v)
    return pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)


# ---- the schedules: each drives one engine and returns its handles ----

def _shared_prefix(eng, rng_seed=1):
    rng = np.random.RandomState(rng_seed)
    system = rng.randint(0, VOCAB, 10).tolist()
    prompts = [system + rng.randint(0, VOCAB, 3).tolist() for _ in range(6)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(6)]
    handles = [eng.submit(prompts[0], 5)]
    eng.run()
    for i in range(1, 6):           # hits, the odd ones sampled
        kw = ({"temperature": 0.8, "rng": np.asarray(keys[i])}
              if i % 2 else {})
        handles.append(eng.submit(prompts[i], 5, **kw))
        if i == 3:
            eng.step()
    eng.run()
    return handles


def _scavenging(eng, rng_seed=2):
    rng = np.random.RandomState(rng_seed)
    fams = [rng.randint(0, VOCAB, 6).tolist() for _ in range(4)]
    handles = []
    for rnd in range(3):
        for f in fams:
            handles.append(eng.submit(f + rng.randint(0, VOCAB, 2).tolist(),
                                      3 + rnd))
        for _ in range(3):
            eng.step()
    eng.run()
    return handles


def _spill_restore(eng, corrupt=False, rng_seed=3):
    rng = np.random.RandomState(rng_seed)
    hot = rng.randint(0, VOCAB, 10).tolist()
    handles = [eng.submit(hot, 6)]
    eng.run()
    for _ in range(3):          # distinct prompts scavenge (and spill) it
        handles.append(eng.submit(rng.randint(0, VOCAB, 10).tolist(), 2))
        eng.run()
    if corrupt:
        seq = next(s for s, _ in eng.spill.entries()
                   if s[:10] == tuple(hot))
        eng.spill.put(seq, len(seq), _flip(eng.spill.get(seq)))
    handles.append(eng.submit(hot + [7, 8], 6))      # a spill hit
    eng.run()
    handles.append(eng.submit(hot + [7, 9], 4))      # a device hit on it
    eng.run()
    return handles


SCHEDULES = {
    "shared_prefix": (_shared_prefix, dict(n_slots=3, max_total=32)),
    "scavenging": (_scavenging, dict(n_slots=3, max_total=16,
                                     max_prefills_per_tick=2,
                                     spill_bytes=0)),
    "spill_restore": (_spill_restore, dict(n_slots=2, max_total=48)),
    "spill_corrupt": (lambda e: _spill_restore(e, corrupt=True),
                      dict(n_slots=2, max_total=48)),
}


def _counters(eng):
    m = eng.metrics()
    return {k: v for k, v in m.items()
            if k.startswith(("serving/prefix/", "serving/spill/"))}


def _slots(eng):
    a = eng.pool.allocator
    a.check_invariants()
    return (sorted(a._free), sorted(a._busy), dict(a._cached),
            eng.pool.pos.tolist(),
            sorted((e.seq, e.slot, e.length)
                   for e in eng.prefix_cache.entries()))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_engine_schedule_equal_jax(name):
    run, kw = SCHEDULES[name]
    jp, _, tp = _params(seed=4)
    jeng, teng = _pair(jp, tp, queue_capacity=16, **kw)
    try:
        want = run(jeng)
        got = run(teng)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.status == w.status == "done", (i, g.status, w.status)
            assert g.tokens == w.tokens, (i, g.tokens, w.tokens)
        jc, tc = _counters(jeng), _counters(teng)
        # a payload's pickle carries its CRC, whose width follows its
        # value; the rows' fp32 bits differ between the two packages in
        # the last place, so the held bytes may differ by a few a payload
        jb, tb = jc.pop("serving/spill/bytes", 0), tc.pop(
            "serving/spill/bytes", 0)
        assert abs(jb - tb) <= 8 * jc.get("serving/spill/entries", 0)
        assert tc == jc
        assert (teng.engine.prefill_calls, teng.engine.prefix_copies) == \
            (jeng.engine.prefill_calls, jeng.engine.prefix_copies)
        assert _slots(teng) == _slots(jeng)
        assert teng.prefix_cache.total_refcount() == 0
        if name == "shared_prefix":
            assert tc["serving/prefix/hits"] >= 3.0
            assert teng.engine.prefix_copies == tc["serving/prefix/hits"]
        if name == "scavenging":
            assert tc["serving/prefix/evictions"] > 0
        if name == "spill_restore":
            assert tc["serving/spill/restores"] == 1.0
        if name == "spill_corrupt":
            assert tc["serving/spill/crc_refusals"] == 1.0
            assert tc["serving/spill/restores"] == 0.0
    finally:
        jeng.close()
        teng.close()


def test_spilled_payload_holds_the_slot_bytes_and_restores():
    """A scavenged donation spills the slot's rows byte for byte; the
    restore lands them in the new slot and the request's tokens equal
    the first run's (the same prompt prefilled)."""
    _, _, tp = _params(seed=5)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=2, max_total=48,
                        device="cpu")
    rng = np.random.RandomState(6)
    hot = rng.randint(0, VOCAB, 10).tolist()
    first = eng.submit(hot, 6)
    eng.run()
    entry = eng.prefix_cache.entries()[0]
    rows0 = [(k[entry.slot, :entry.length].clone(),
              v[entry.slot, :entry.length].clone())
             for k, v in eng.pool.caches]
    for _ in range(3):
        eng.submit(rng.randint(0, VOCAB, 10).tolist(), 2)
        eng.run()
    assert eng.spill.spills >= 1
    packed = pickle.loads(eng.spill.covering(entry.seq))
    for (k0, v0), (kp, vp) in zip(rows0, packed["rows"]):
        assert k0.numpy().tobytes() == kp.tobytes()
        assert v0.numpy().tobytes() == vp.tobytes()
    calls = eng.engine.prefill_calls
    again = eng.submit(hot, 6)
    eng.run()
    assert again.tokens == first.tokens
    assert eng.spill.restores == 1 and eng.engine.prefill_calls == calls
    eng.close()


def test_background_loop_serves_what_run_serves():
    _, _, tp = _params(seed=7)
    rng = np.random.RandomState(8)
    system = rng.randint(0, VOCAB, 8).tolist()
    prompts = [system + rng.randint(0, VOCAB, 2).tolist() for _ in range(5)]
    kw = dict(head_dim=HEAD_DIM, n_slots=2, max_total=24, device="cpu")
    ref = ServingEngine(tp, **kw)
    want = []
    for p in prompts:
        want.append(ref.submit(p, 4))
        ref.run()
    ref.close()
    eng = ServingEngine(tp, **kw)
    eng.start()
    try:
        got = []
        for p in prompts:        # one at a time: the same cache states
            got.append(eng.submit(p, 4))
            assert got[-1].wait(timeout=30)
    finally:
        eng.stop()
    assert [h.tokens for h in got] == [h.tokens for h in want]
    assert eng.metrics()["serving/prefix/hits"] == 4.0
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(prompts[0], 2)
    # run(drain=False) stops at its budget with work still pending;
    # after stop() it runs nothing
    eng = ServingEngine(tp, **kw)
    h = eng.submit(prompts[0], 8)
    assert eng.run(steps_budget=3, drain=False) == 3
    assert h.status == "running" and len(h.tokens) == 1 + 3
    eng.stop()
    assert eng.run(steps_budget=3, drain=False) == 0
    eng.close()


def test_observability_faces(tmp_path):
    from chainermn_tpu_torch.observability import (flight, read_metrics_jsonl,
                                                   trace)
    from chainermn_tpu_torch.observability.export import (
        MetricsWriter, parse_prometheus_text)
    from chainermn_tpu_torch.observability.slo import SLOTracker

    _, _, tp = _params(seed=9)
    writer = MetricsWriter(str(tmp_path / "serve.jsonl"))
    slo = SLOTracker(ttft_target_ms=1e6, tokens_per_sec_target=1e-3,
                     min_observations=1)
    eng = ServingEngine(tp, head_dim=HEAD_DIM, n_slots=2, max_total=24,
                        metrics_writer=writer, slo=slo, device="cpu")
    rng = np.random.RandomState(10)
    system = rng.randint(0, VOCAB, 8).tolist()
    trace.reset()
    trace.enable()
    try:
        handles = []
        for _ in range(3):
            handles.append(eng.submit(system + rng.randint(0, VOCAB,
                                                           2).tolist(), 3))
            eng.run()
    finally:
        trace.disable()
    m = eng.metrics()
    for key in ("serving/prefix/hits", "serving/prefix/cached_slots",
                "serving/spill/capacity_bytes", "serving/goodput/compute_s",
                "serving/goodput/coverage_frac", "serving/tick_gap_p99_ms",
                "serving/tick_gap_variance_ms2", "serving/ttft_p50_ms"):
        assert key in m, key
    assert m["serving/spill/capacity_bytes"] == float(32 << 20)
    assert eng.goodput.report()["coverage_frac"] >= 0.9
    # the trace: one trace id per request across the prefix hit's spans
    hit = handles[1]
    names = {ev["name"] for ev in trace.get_tracer().events()
             if (ev.get("args") or {}).get("trace_id") == hit.trace_id}
    for want in ("request/queue_wait", "serving/prefix_copy",
                 "request/decode_tick", "serving/request/prefix_hit",
                 "serving/request/first_token"):
        assert want in names, (want, sorted(names))
    phases = {ev["ph"] for ev in trace.get_tracer().events()
              if ev.get("id") == hit.trace_id}
    assert {"b", "n", "e"} <= phases
    # /requestz, the flight provider, Prometheus, the JSONL stream
    table = eng.requests_table()
    assert [r["trace_id"] for r in table["recent"]] == \
        [h.trace_id for h in reversed(handles)]
    state = flight.provider_snapshots()["serving"]
    assert state["prefix_copies"] == 2 and state["prefix_cache"]["hits"] == 2
    assert state["slo"]["targets"]["ttft_ms"] == 1e6
    text = eng.write_prometheus(str(tmp_path / "serve.prom"))
    samples = {n: v for n, _, v in parse_prometheus_text(text)["samples"]}
    assert samples["chainermn_tpu_serving_prefix_hits"] == 2.0
    assert "chainermn_tpu_serving_tokens_total_total" in samples
    eng.finalize_metrics()
    writer.close()
    recs = read_metrics_jsonl(str(tmp_path / "serve.jsonl"))
    assert recs[-1]["kind"] == "serving_summary"
    assert recs[-1]["serving/prefix/hits"] == 2.0
    assert sum(r["kind"] == "serving_step" for r in recs) == eng._ticks
    eng.reset_stats()
    assert eng.metrics()["serving/prefix/hits"] == 0.0
    assert eng.prefix_cache.n_entries >= 1      # the warm cache stays
    eng.close()
    assert "serving" not in flight.provider_snapshots()
    json.dumps(state)


def test_tp2_prefix_schedule_equals_tp1(tmp_path):
    """TP = 2 over gloo (rank 0 leads; rank 1 copies, packs, drops and
    lands its own columns under the leader's plan) serves the prefix
    schedule with a spill and a restore to TP = 1's tokens and counters;
    a CRC refusal of the follower's own payload refuses the restore on
    both ranks, and the request prefills."""
    _, host, tp = _params(seed=11, pos_impl="rope")
    rng = np.random.RandomState(12)
    system = rng.randint(0, VOCAB, 8).tolist()
    prompts = [system + rng.randint(0, VOCAB, 2).tolist() for _ in range(3)]
    prompts += [rng.randint(0, VOCAB, 10).tolist() for _ in range(3)]
    prompts += [system + rng.randint(0, VOCAB, 2).tolist() for _ in range(2)]
    max_new = [4, 3, 3, 2, 2, 2, 4, 3]
    kw = dict(head_dim=HEAD_DIM, n_slots=2, max_total=24,
              queue_capacity=8, spill_bytes=1 << 20)
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump({"prefix": dict(params=host, prompts=prompts,
                                    max_new=max_new, kw=kw)}, fh)
    outs, _ = launch("_torch_tp_worker.py", "prefix", 2, tmp_path)
    eng = ServingEngine(tp, device="cpu", **kw)
    want = prefix_schedule(eng, prompts, max_new)
    want_counters = _counters(eng)
    assert want_counters["serving/spill/restores"] == 1.0
    assert want_counters["serving/prefix/hits"] >= 2.0
    for corrupt in (False, True):
        rows, counters, copies, prefills = outs[0][corrupt]
        assert [t for _, t in rows] == [h.tokens for h in want], corrupt
        assert all(s == "done" for s, _ in rows)
        follower = outs[1][corrupt]
        assert follower[0] == "followed"
        assert follower[2:] == (copies, prefills)    # the same pool calls
        if not corrupt:
            # the leader's store holds its own half of the KV columns
            half = counters.pop("serving/spill/bytes")
            assert half < 0.6 * want_counters["serving/spill/bytes"]
            assert counters == {k: v for k, v in want_counters.items()
                                if k != "serving/spill/bytes"}
            assert (copies, prefills) == (eng.engine.prefix_copies,
                                          eng.engine.prefill_calls)
        else:
            assert counters["serving/spill/crc_refusals"] == 1.0
            assert counters["serving/spill/restores"] == 0.0
            assert prefills == eng.engine.prefill_calls + 1
    eng.close()
