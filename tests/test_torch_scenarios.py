"""The port's scenario engine vs the JAX package's.

``serving/scenarios.py`` is a copy: every generator family's event stream
(``stream_digest``) and every prompt it materialises are held equal to
JAX's at several seeds, and so are its refusals.  ``run_scenario`` replays
one stream (a burst of requests, then a worker kill) against the port's
``build_local_fleet`` and against JAX's on the same weights, each fleet
stepped by the driver's ``sleep`` so both see the same drive: the same
requests reach the same workers, decode to the same tokens, and the kill
has the same effect (one detection, every request done on the survivor).
The CPU only, torch in one thread.
"""

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.serving import fleet as jfleet
from chainermn_tpu.serving import scenarios as jsc
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.serving import build_local_fleet
from chainermn_tpu_torch.serving import scenarios as tsc

VOCAB, D, HEADS, LAYERS = 32, 16, 4, 2
HEAD_DIM = D // HEADS

FAMILIES = {
    "staggered": lambda m, seed: m.staggered(12, 0.01, seed=seed,
                                             tenant="t", deadline_s=1.0),
    "diurnal": lambda m, seed: m.diurnal(seed, jitter_frac=0.3),
    "flash_crowd": lambda m, seed: m.flash_crowd(seed),
    "adversarial": lambda m, seed: m.adversarial(seed),
    "mixed_deadlines": lambda m, seed: m.mixed_deadlines(seed),
    "composed_chaos": lambda m, seed: m.composed_chaos(seed),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stream_digest_equal_jax(family, seed):
    got = FAMILIES[family](tsc, seed)
    want = FAMILIES[family](jsc, seed)
    assert tsc.stream_digest(got) == jsc.stream_digest(want)
    assert got == want
    assert tsc.check_stream(got) == len(want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_materialize_prompt_equal_jax(family):
    for ev in FAMILIES[family](tsc, 3):
        if ev["kind"] == "request":
            for vocab in (32, 32768):
                assert tsc.materialize_prompt(ev["prompt"], vocab) == \
                    jsc.materialize_prompt(ev["prompt"], vocab)


def test_registry_and_builders_equal_jax():
    assert tsc.SCENARIO_SCHEMA == jsc.SCENARIO_SCHEMA
    assert sorted(tsc.SCENARIOS) == sorted(jsc.SCENARIOS)
    for name in tsc.SCENARIOS:
        assert tsc.stream_digest(tsc.build_scenario(name, seed=5)) == \
            jsc.stream_digest(jsc.build_scenario(name, seed=5))
    # the family's own keyword arguments ride build_scenario
    kw = dict(prompt_len=512, crowd_prefix_len=448, max_new_tokens=64,
              crowd_n=16, n_background=8)
    assert tsc.stream_digest(tsc.build_scenario("flash_crowd", 2, **kw)) \
        == jsc.stream_digest(jsc.build_scenario("flash_crowd", 2, **kw))
    s = tsc.merge(tsc.staggered(3, 0.0, seed=1), tsc.finalize(
        [tsc.fault_event(0.0, "kill", 0)]))
    j = jsc.merge(jsc.staggered(3, 0.0, seed=1), jsc.finalize(
        [jsc.fault_event(0.0, "kill", 0)]))
    assert s == j


@pytest.mark.parametrize("bad", [
    "not a dict", {"schema": "x"}, {"schema": jsc.SCENARIO_SCHEMA},
    {"schema": jsc.SCENARIO_SCHEMA, "kind": "request", "t": -1},
    {"schema": jsc.SCENARIO_SCHEMA, "kind": "request", "t": 0,
     "prompt": {"len": 0}},
    {"schema": jsc.SCENARIO_SCHEMA, "kind": "fault", "t": 0,
     "fault": {"action": "melt", "target": 0}}])
def test_refusals_equal_jax(bad):
    msgs = []
    for mod in (jsc, tsc):
        with pytest.raises(ValueError) as e:
            mod.validate_event(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown scenario"):
        tsc.build_scenario("nope")


class _Recording:
    """The router run_scenario sees, recording each accepted request's
    handle and the worker it was dispatched to."""

    def __init__(self, router):
        self._router = router
        self.handles, self.went = [], []

    def __getattr__(self, name):
        return getattr(self._router, name)

    def submit(self, *args, **kw):
        h = self._router.submit(*args, **kw)
        with self._router._lock:
            self.went.append(self._router._inflight[h.trace_id]["worker"])
        self.handles.append(h)
        return h


def _replay(name, events):
    jp = jax_init(jax.random.PRNGKey(0), VOCAB, D, HEADS, LAYERS,
                  max_len=64, pos_impl="rope")
    if name == "jax":
        mesh = mn.make_nd_mesh(("model",), (1,), jax.devices()[:1])
        router, runtimes = jfleet.build_local_fleet(
            jp, {"engine": 2}, head_dim=HEAD_DIM, beat_interval_s=0.02,
            miss_beats=4, worker_kwargs=dict(n_slots=4, max_total=24,
                                             mesh=mesh))
        sc = jsc
    else:
        tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        router, runtimes = build_local_fleet(
            tp, {"engine": 2}, head_dim=HEAD_DIM, beat_interval_s=0.02,
            miss_beats=4, worker_kwargs=dict(n_slots=4, max_total=24,
                                             device="cpu"))
        sc = tsc

    def drive(_seconds):
        for rt in runtimes:
            rt.step()
        router.step()

    rec = _Recording(router)
    try:
        for _ in range(3):
            drive(0)
        row = sc.run_scenario(events, rec, vocab=VOCAB, time_scale=0.0,
                              runtimes=runtimes, max_attempts=1,
                              settle_timeout_s=60.0, sleep=drive)
    finally:
        for rt in runtimes:
            rt.finished = True
        router.close()
    return row, rec


def test_run_scenario_on_local_fleet_equal_jax():
    events = tsc.merge(
        tsc.staggered(6, 0.0, seed=4, prompt_len=5, max_new_tokens=6),
        tsc.finalize([tsc.fault_event(0.0, "kill", 1)]))
    out = {name: _replay(name, events) for name in ("jax", "torch")}
    (jrow, jrec), (trow, trec) = out["jax"], out["torch"]
    assert trec.went == jrec.went and set(trec.went) == {"engine0",
                                                          "engine1"}
    assert [h.tokens for h in trec.handles] == \
        [h.tokens for h in jrec.handles]
    assert all(h.status == "done" and len(h.tokens) == 6
               for h in trec.handles)
    for key in ("digest", "n_events", "n_requests", "n_faults",
                "offered_shed", "terminal_frac", "fault_log",
                "worker_lost_detections", "shed_by_tenant",
                "final_workers", "peak_workers"):
        assert trow[key] == jrow[key], key
    assert trow["fault_log"] == [{"t": 0.0, "action": "kill", "target": 1}]
    assert trow["worker_lost_detections"] == 1 and trow["final_workers"] == 1
    assert set(trow) == set(jrow)
