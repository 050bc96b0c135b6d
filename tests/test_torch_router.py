"""The port's serving router and ``serve --replicas`` vs the JAX package's.

Two replicas on each side (``Replica.build`` over the same weights, the
prefix cache and the spill tier on) take the same schedule through
``ServingRouter``: every dispatch choice (``prefix_match_len −
backlog_tokens``, then the emptier queue, then round-robin), every
request's tokens and the fleet counters must be equal.  The rejection
payloads (``queue_full`` with its ``retry_after_ms`` and ``queue_depth``,
``too_long``, the deadline-infeasible and SLO-burn ``shed_slo``) and
their JSONL records match JAX's; the engine's and the router's gauges
survive ``parse_prometheus_text(prometheus_text(...))`` in both
packages.  ``serve --replicas 2`` serves every request the JAX CLI's
tokens.  The CPU only, width 32, 2 layers.
"""

import re

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.observability import export as jexport
from chainermn_tpu.observability.slo import SLOTracker as JaxSLOTracker
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.serving import AdmissionError as JaxAdmissionError
from chainermn_tpu.serving import Replica as JaxReplica
from chainermn_tpu.serving import ServingRouter as JaxServingRouter
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.observability import export as texport
from chainermn_tpu_torch.observability.slo import SLOTracker
from chainermn_tpu_torch.serving import (AdmissionError, Replica,
                                         ServingRouter, build_fleet)

VOCAB, D, HEADS, LAYERS = 64, 32, 4, 2
HEAD_DIM = D // HEADS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed):
    jp = jax_init(jax.random.PRNGKey(seed), VOCAB, D, HEADS, LAYERS,
                  max_len=64)
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")


def _routers(seed, n=2, slo=None, jslo=None, writers=(None, None), **kw):
    jp, tp = _params(seed)
    mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
    jreps = [JaxReplica.build(jp, f"replica{i}", head_dim=HEAD_DIM,
                              mesh=mesh, slo=jslo, **kw) for i in range(n)]
    treps = [Replica.build(tp, f"replica{i}", head_dim=HEAD_DIM,
                           device="cpu", slo=slo, **kw) for i in range(n)]
    return (JaxServingRouter(jreps, slo=jslo, metrics_writer=writers[0]),
            ServingRouter(treps, slo=slo, metrics_writer=writers[1]))


def _dispatch(router, prompt, new, **kw):
    """Submit; returns (handle, the replica it went to)."""
    before = dict(router._dispatched_by)
    h = router.submit(prompt, new, **kw)
    went = [k for k, v in router._dispatched_by.items() if v != before[k]]
    return h, went[0]


def _schedule(router):
    rng = np.random.RandomState(3)
    fam_a = rng.randint(0, VOCAB, 10).tolist()
    fam_b = rng.randint(0, VOCAB, 10).tolist()
    out = []
    # two families, drained between submits: each lands where its prefix
    # is (after the first of each, which the backlog score places)
    for fam in (fam_a, fam_b, fam_a, fam_b, fam_a):
        out.append(_dispatch(router, fam + rng.randint(0, VOCAB, 2).tolist(),
                             4))
        router.run(steps_budget=200)
    # a burst without draining: backlog competes with affinity
    for i in range(6):
        fam = (fam_a, fam_b)[i % 2]
        out.append(_dispatch(router, fam + rng.randint(0, VOCAB, 2).tolist(),
                             3 + i % 3))
        if i % 3 == 2:
            router.step()
    router.run(steps_budget=400)
    return out


def test_dispatch_and_tokens_equal_jax():
    jr, tr = _routers(1, n_slots=2, max_total=32, queue_capacity=8)
    try:
        want, got = _schedule(jr), _schedule(tr)
        assert [r for _, r in got] == [r for _, r in want]
        for i, ((g, _), (w, _)) in enumerate(zip(got, want)):
            assert g.status == w.status == "done", i
            assert g.tokens == w.tokens, (i, g.tokens, w.tokens)
            assert g.trace_id.startswith("req-") and "rt" in g.trace_id
        jm, tm = jr.metrics(), tr.metrics()
        assert set(tm) == set(jm)
        for key in ("router/dispatched_total",
                    "router/affinity_dispatches_total",
                    "router/rejected_total", "router/replicas"):
            assert tm[key] == jm[key], key
        assert tm["router/affinity_dispatches_total"] >= 5.0
        for i in range(2):
            for k in ("prefix/hits", "prefix/misses", "prefix/insertions",
                      "prefix/evictions", "spill/spills", "spill/restores",
                      "tokens_total"):
                key = f"router/replica{i}/{k}"
                assert tm[key] == jm[key], key
            assert tr.replicas[i].engine.engine.prefix_copies == \
                jr.replicas[i].engine.engine.prefix_copies
        assert [ld["backlog_tokens"] for ld in
                (r.load() for r in tr.replicas)] == [0, 0]
    finally:
        jr.close()
        tr.close()


def _payload(err):
    d = err.to_dict()
    d["detail"] = re.sub(r"[0-9.]+x", "Nx", d["detail"])
    return d


def test_rejection_payloads_equal_jax(tmp_path):
    jw = jexport.MetricsWriter(str(tmp_path / "jax.jsonl"))
    tw = texport.MetricsWriter(str(tmp_path / "torch.jsonl"))
    jr, tr = _routers(2, n_slots=1, max_total=16, queue_capacity=1,
                      writers=(jw, tw))
    rng = np.random.RandomState(4)
    p = rng.randint(0, VOCAB, 4).tolist()
    got = {}
    try:
        for name, router, err_t in (("jax", jr, JaxAdmissionError),
                                    ("torch", tr, AdmissionError)):
            out = []
            with pytest.raises(err_t) as e:      # too_long first
                router.submit(rng.randint(0, VOCAB, 10).tolist(), 10)
            out.append(e.value.to_dict())
            router.submit(p, 4)
            router.submit(p, 4)                  # both queues full now
            with pytest.raises(err_t) as e:
                router.submit(p, 4)
            # no token yet: the hint prices the backlog at 20 ms a token,
            # jittered by the router's seeded generator
            out.append(e.value.to_dict())
            router.step()
            with pytest.raises(err_t) as e:      # no replica in time
                router.submit(p, 4, deadline_s=1e-9)
            assert e.value.retry_after_ms >= 1.0
            d = e.value.to_dict()
            d.pop("retry_after_ms")              # the measured drain rate
            out.append(d)
            router.run(steps_budget=200)
            router.finalize_metrics()
            out.append(router.rejection_counters())
            got[name] = out
        assert got["torch"] == got["jax"]
        assert got["torch"][1]["reason"] == "queue_full"
        assert got["torch"][1]["queue_depth"] == 2
        assert got["torch"][1]["retry_after_ms"] >= 1.0
        assert got["torch"][2]["reason"] == "shed_slo"
    finally:
        jr.close()
        tr.close()
        jw.close()
        tw.close()
    jrecs = jexport.read_metrics_jsonl(str(tmp_path / "jax.jsonl"))
    trecs = texport.read_metrics_jsonl(str(tmp_path / "torch.jsonl"))
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j)
        if t["kind"] == "router_rejection":
            assert (t["reason"], t["router/queue_depth"]) == \
                (j["reason"], j["router/queue_depth"])


def test_slo_burn_sheds_like_jax():
    trackers = [cls(ttft_target_ms=1e-6, windows_s=(30.0, 300.0),
                    min_observations=2, burn_threshold=1e9)
                for cls in (JaxSLOTracker, SLOTracker)]
    jr, tr = _routers(5, n=1, slo=trackers[1], jslo=trackers[0],
                      n_slots=1, max_total=16, queue_capacity=8)
    rng = np.random.RandomState(6)
    p = rng.randint(0, VOCAB, 4).tolist()
    out = {}
    try:
        for name, router, slo, err_t in (
                ("jax", jr, trackers[0], JaxAdmissionError),
                ("torch", tr, trackers[1], AdmissionError)):
            for _ in range(3):
                h = router.submit(p, 2)
                router.run(steps_budget=60)
                assert h.status == "done"
            assert slo.burn_rate("ttft", 30.0) > 1.0 and not slo.findings
            router.submit(p, 6)
            with pytest.raises(err_t) as e:
                router.submit(p, 6)
            assert e.value.retry_after_ms >= 1.0
            d = _payload(e.value)
            d.pop("retry_after_ms")
            router.run(steps_budget=400)
            out[name] = (d, router.rejection_counters(),
                         slo.status()["ttft"]["observations"])
    finally:
        jr.close()
        tr.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["reason"] == "shed_slo"


def test_prometheus_round_trip_of_engine_and_router_gauges(tmp_path):
    jr, tr = _routers(7, n_slots=2, max_total=32, queue_capacity=8)
    rng = np.random.RandomState(8)
    system = rng.randint(0, VOCAB, 8).tolist()
    try:
        for router in (jr, tr):
            for _ in range(3):
                router.submit(system + rng.randint(0, VOCAB, 2).tolist(), 3)
                router.run(steps_budget=100)
        for router, exp in ((jr, jexport), (tr, texport)):
            for gauges in (router.metrics(),
                           router.replicas[0].engine.metrics()):
                for parse in (jexport.parse_prometheus_text,
                              texport.parse_prometheus_text):
                    doc = parse(exp.prometheus_text(gauges))
                    samples = {n: v for n, lab, v in doc["samples"]
                               if not lab}
                    for key, value in gauges.items():
                        name = exp._prom_name(key)
                        assert samples[name] == pytest.approx(value), key
                        assert doc["families"][name]["type"] == "gauge"
        tm, jm = tr.metrics(), jr.metrics()
        t_names = {texport._prom_name(k) for k in tm}
        assert t_names == {jexport._prom_name(k) for k in jm}
        text = tr.write_prometheus(str(tmp_path / "router.prom"))
        assert (tmp_path / "router.prom").read_text() == text
        assert "chainermn_tpu_router_rejected_queue_full 0.0" in text
        assert "chainermn_tpu_router_replica0_prefix_hits" in text
    finally:
        jr.close()
        tr.close()


def test_router_tables_threads_and_fleet_builder():
    from chainermn_tpu_torch.observability import flight

    _, tp = _params(9)
    router = build_fleet(tp, 2, head_dim=HEAD_DIM, n_slots=2, max_total=24,
                         queue_capacity=4, device="cpu")
    assert [r.name for r in router.replicas] == ["replica0", "replica1"]
    rng = np.random.RandomState(10)
    router.start()
    try:
        handles = [router.submit(rng.randint(0, VOCAB, 5).tolist(), 3)
                   for _ in range(4)]
        assert all(h.wait(timeout=30) for h in handles)
    finally:
        router.stop()
    assert all(h.status == "done" for h in handles)
    table = router.requests_table()
    assert table["fleet"] and set(table["replicas"]) == {"replica0",
                                                         "replica1"}
    recent = [r["trace_id"] for t in table["replicas"].values()
              for r in t["recent"]]
    assert sorted(recent) == sorted(h.trace_id for h in handles)
    state = flight.provider_snapshots()["router"]
    assert state["dispatched"] == 4 and set(state["replica_state"]) == \
        {"replica0", "replica1"}
    router.reset_stats()
    assert router.metrics()["router/dispatched_total"] == 0.0
    router.close()
    assert "router" not in flight.provider_snapshots()
    with pytest.raises(ValueError, match="unique"):
        ServingRouter([router.replicas[0], router.replicas[0]])


def test_serve_cli_replicas_tokens_equal_jax(capsys):
    """``serve --replicas 2 --train-steps 0`` serves JAX's initial
    weights: every request's tokens equal the JAX CLI's."""
    from chainermn_tpu.serve import main as jax_main
    from chainermn_tpu_torch.serve import run

    argv = ["--replicas", "2", "--train-steps", "0", "--requests", "8",
            "--n-slots", "2", "--prompt-len", "8"]
    jax_main(argv)
    err = capsys.readouterr().err
    want = [eval(m.group(1)) for m in
            re.finditer(r"^prompt \[[^\]]*\] -> (\[[^\]]*\])", err, re.M)]
    assert len(want) == 8
    params = jax_init(jax.random.PRNGKey(0), 64, 32, 4, 2, max_len=24)
    summary = run(["--device", "cpu", *argv],
                  params=jax.tree_util.tree_map(np.asarray, params))
    assert summary["replicas"] == 2
    assert [r["tokens"] for r in summary["requests"]] == want
    assert all(r["status"] == "done" for r in summary["requests"])
    assert set(summary["goodput"]) == {"replica0", "replica1"}
    assert summary["metrics"]["router/dispatched_total"] == 8.0
