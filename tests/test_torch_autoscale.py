"""The port's fleet autoscaler vs the JAX package's.

``AutoscalePolicy`` is held to JAX's on the same signal traces with an
injected clock: JAX's oscillating trace (zero flaps), the ramp to max then
sustained calm back to min, below-min, every overload signal, and a calm
clock that a blip restarts.  ``FleetAutoscaler`` is held to JAX's over one
scripted fleet (the same leases, counters and clock): the same decisions,
signals, spawns and drain victims, the same ``metrics()`` and ``state()``,
and one ``autoscale_decision`` flight event a decision.  On the port's own
``build_local_fleet`` with ``local_spawn_factory`` a burst scales up and
the idle tail drains back down, JAX's sequence of decisions, nothing shed.
``serve --autoscale`` refuses as JAX's CLI does, and over a worker-process
fleet on the CPU reports the autoscaler's state with every worker's exit
code 0.  torch in one thread.
"""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.parallel import init_tp_transformer_lm
from chainermn_tpu.serving import autoscale as jas
from chainermn_tpu_torch.convert import from_jax
from chainermn_tpu_torch.observability import flight
from chainermn_tpu_torch.serving import autoscale as tas
from chainermn_tpu_torch.serving import build_local_fleet

VOCAB, D, HEADS, LAYERS = 32, 16, 4, 2
HEAD_DIM = D // HEADS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here and in the workers this file spawns."""
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


def test_module_names_and_bands_equal_jax():
    assert tas.UP_SIGNALS == jas.UP_SIGNALS
    assert tas.NOT_PORTED == {}
    for kw in (dict(up_backlog_tokens_per_worker=8.0,
                    down_backlog_tokens_per_worker=8.0),
               dict(up_queue_depth_per_worker=1.0,
                    down_queue_depth_per_worker=2.0),
               dict(min_workers=3, max_workers=2),
               dict(up_cooldown_s=0.0)):
        msgs = []
        for mod in (jas, tas):
            with pytest.raises(ValueError) as e:
                mod.AutoscalePolicy(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _osc(n_steps=600, dt=0.1, period=4):
    """JAX's oscillating trace: hot for ``period`` steps, calm for as many."""
    return [(i * dt, {"backlog_tokens": 600 if (i // period) % 2 == 0
                      else 0,
                      "queue_depth": 8 if (i // period) % 2 == 0 else 0,
                      "shed_rate": 0.0,
                      "occupancy_frac": 1.0 if (i // period) % 2 == 0
                      else 0.0}) for i in range(n_steps)]


HOT = {"backlog_tokens": 900, "queue_depth": 9, "shed_rate": 0.0}
COLD = {"backlog_tokens": 0, "queue_depth": 0, "shed_rate": 0.0,
        "occupancy_frac": 0.0}

TRACES = {
    "oscillating": (dict(min_workers=1, max_workers=4, up_cooldown_s=1.0,
                         down_cooldown_s=2.0, down_stable_s=2.0), _osc()),
    "ramp_then_low": (
        dict(min_workers=1, max_workers=3, max_step=1, up_cooldown_s=0.5,
             down_cooldown_s=1.0, down_stable_s=1.0),
        [(i * 0.1, HOT) for i in range(40)]
        + [(20.0 + i * 0.1, COLD) for i in range(400)]),
    "below_min": (dict(min_workers=2, max_workers=4,
                       up_tick_gap_p99_ms=50.0),
                  [(i * 0.5, {}) for i in range(20)]),
    "signals": (dict(min_workers=1, max_workers=8, up_shed_rate=0.01,
                     up_burn_rate=1.0, up_tick_gap_p99_ms=50.0,
                     up_cooldown_s=0.2, down_cooldown_s=0.4,
                     down_stable_s=0.4),
                [(t * 0.5, s) for t, s in enumerate(
                    [{"shed_rate": 0.5}, {"burn_rate_short": 2.0},
                     {"tick_gap_p99_ms": 80.0}, {"queue_depth": 100},
                     COLD, COLD, COLD, {"burn_rate_short": 0.6}, COLD,
                     COLD, COLD, COLD])]),
    "blip_restarts_calm": (
        dict(min_workers=1, max_workers=2, up_cooldown_s=0.5,
             down_cooldown_s=1.0, down_stable_s=1.0),
        [(0.0, COLD), (0.9, COLD), (1.0, HOT), (1.1, COLD), (1.9, COLD),
         (2.2, COLD)]),
}


def _run(mod, kw, trace, live0):
    policy = mod.AutoscalePolicy(**kw)
    live, decisions = live0, []
    for now, sig in trace:
        dec = policy.decide(dict(sig, live_workers=live), now)
        if dec is not None:
            live = dec["target"]      # an ideal actuator
            decisions.append(dec)
    return decisions, policy.flap_count(), policy.state(), live


@pytest.mark.parametrize("name", sorted(TRACES))
def test_policy_decisions_equal_jax(name):
    kw, trace = TRACES[name]
    live0 = {"below_min": 0, "blip_restarts_calm": 2}.get(name, 1)
    got = _run(tas, kw, trace, live0)
    assert got == _run(jas, kw, trace, live0)
    decisions, flaps, _, live = got
    assert decisions and flaps == 0
    if name == "ramp_then_low":
        assert [d["direction"] for d in decisions] == ["up"] * 2 + \
            ["down"] * 2 and live == 1
    if name == "below_min":
        assert decisions[0]["reason"] == "below_min"
    if name == "signals":
        assert [d["reason"] for d in decisions[:4]] == [
            "shed_rate", "burn_rate_short", "tick_gap_p99_ms",
            "queue_depth_per_worker"]


class _Worker:
    def __init__(self, name, role):
        self.name, self.role = name, role
        self.state = "live"
        self.last_lease = {}
        self.sent_since_lease = 0


class _Router:
    """The face FleetAutoscaler drives: workers with their last leases,
    the rejection and dispatch counters, in-flight entries, ``add_worker``
    and ``drain`` (recorded)."""

    def __init__(self):
        self.workers = {"engine0": _Worker("engine0", "engine")}
        self._lock = threading.Lock()
        self._rejected = {"queue_full": 0, "shed_slo": 0,
                          "shed_tenant_budget": 0}
        self._dispatched = 0
        self._inflight = {}
        self.slo = None
        self.autoscaler = None
        self.log = []

    def add_worker(self, wc):
        self.workers[wc.name] = wc
        self.log.append(("add", wc.name))

    def drain(self, name):
        self.workers[name].state = "draining"
        self.log.append(("drain", name))


def _script(mod):
    """One scripted run: a burst's leases, sheds and dispatches, then the
    calm tail, one tick every 0.1 s of an injected clock."""
    clock = {"t": 0.0}
    router = _Router()
    spawned = []

    def spawn(name, role):
        if name.endswith("as2"):
            raise RuntimeError("no capacity")     # a failed spawn
        spawned.append((name, role))
        return _Worker(name, role)

    auto = mod.FleetAutoscaler(
        router, spawn, policies=[mod.AutoscalePolicy(
            role="engine", min_workers=1, max_workers=3,
            up_cooldown_s=0.3, down_cooldown_s=0.6, down_stable_s=0.5)],
        interval_s=0.05, clock=lambda: clock["t"])
    assert router.autoscaler is auto
    applied = []
    for i in range(80):
        clock["t"] = i * 0.1
        hot = 5 <= i < 30
        for j, w in enumerate(router.workers.values()):
            w.last_lease = {"queue_depth": 6 if hot else 0,
                            "backlog_tokens": 400 if hot else j,
                            "busy_slots": 2 if hot else 0,
                            "free_slots": 0 if hot else 2,
                            "last_step_age_s": 0.01 * j,
                            "tick_gap_p99_ms": 9.5 + j}
            w.sent_since_lease = 1 if hot and j == 0 else 0
        router._inflight = ({"a": {"worker": "engine0"}} if hot else {})
        router._dispatched += 3
        if hot:
            router._rejected["queue_full"] += 1
            router._rejected["shed_tenant_budget"] += 5
        for dec in (auto.maybe_tick() if i % 2 else
                    auto.tick(now=clock["t"])):
            applied.append(dec)
    return (applied, spawned, router.log, auto.metrics(), auto.state(),
            auto.target_sizes())


def test_fleet_autoscaler_scripted_fleet_equal_jax():
    flight.get_flight_recorder().clear()
    got = _script(tas)
    want = _script(jas)
    assert got == want
    applied, spawned, log, metrics, state, _ = got
    assert [d["direction"] for d in applied][:1] == ["up"]
    assert "down" in [d["direction"] for d in applied]
    assert spawned and any(op == "drain" for op, _ in log)
    assert metrics["autoscale/engine/flap"] == 0.0
    assert metrics["autoscale/spawn_failures"] >= 1.0
    assert state["policies"]["engine"]["flaps"] == 0
    # one machine-readable flight event a decision, its signal named
    events = [e for e in flight.get_flight_recorder().events()
              if e["kind"] == "autoscale_decision"]
    assert len(events) == len(applied)
    assert [e["reason"] for e in events] == [d["reason"] for d in applied]


def _jax_params():
    jp = init_tp_transformer_lm(jax.random.PRNGKey(0), VOCAB, D, HEADS,
                                LAYERS, max_len=64, pos_impl="rope")
    return jax.tree_util.tree_map(np.asarray, jp)


def test_fleet_autoscaler_scales_up_then_drains_down(tmp_path):
    """JAX's live-fleet test on the port: a burst on one engine drives a
    scale-up (the spawned worker admitted with a fresh epoch), the idle
    tail a scale-down that is a drain (nothing in flight shed), every
    decision machine-readable."""
    jp = _jax_params()
    tp = from_jax(jp, device="cpu")
    wk = dict(n_slots=2, max_total=24, queue_capacity=16, device="cpu")
    router, runtimes = build_local_fleet(
        tp, {"engine": 1}, head_dim=HEAD_DIM, beat_interval_s=0.02,
        miss_beats=8, worker_kwargs=wk, bundle_dir=str(tmp_path / "b"))
    auto = tas.FleetAutoscaler(
        router,
        tas.local_spawn_factory(tp, router, head_dim=HEAD_DIM,
                                beat_interval_s=0.02, worker_kwargs=wk,
                                runtimes=runtimes),
        policies=[tas.AutoscalePolicy(
            role="engine", min_workers=1, max_workers=2,
            up_backlog_tokens_per_worker=24.0,
            down_backlog_tokens_per_worker=4.0,
            up_queue_depth_per_worker=2.0,
            down_queue_depth_per_worker=0.5, up_cooldown_s=0.1,
            down_cooldown_s=0.2, down_stable_s=0.2)],
        interval_s=0.02)
    assert router.autoscaler is auto
    threads = [threading.Thread(target=rt.run, daemon=True)
               for rt in runtimes]
    for t in threads:
        t.start()
    router.start()
    try:
        rng = np.random.RandomState(0)
        handles = [router.submit(rng.randint(0, VOCAB, 5).astype(np.int32),
                                 8) for _ in range(10)]
        policy = auto.policies["engine"]

        def wait(pred, what, timeout=60):
            t0 = time.time()
            while not pred():
                assert time.time() - t0 < timeout, what
                time.sleep(0.01)

        wait(lambda: any(d["direction"] == "up" and "spawned" in d
                         for d in list(policy.decisions)), "scale-up")
        up = next(d for d in list(policy.decisions)
                  if d["direction"] == "up")
        assert up["reason"] in ("backlog_tokens_per_worker",
                                "queue_depth_per_worker")
        assert up["spawned"] and up["spawned"][0] in router.workers
        wait(lambda: all(h.status in ("done", "evicted") for h in handles),
             "requests")
        assert all(h.status == "done" for h in handles)
        wait(lambda: any(d["direction"] == "down" and "drained" in d
                         for d in list(policy.decisions)), "scale-down")
        down = next(d for d in list(policy.decisions)
                    if d["direction"] == "down")
        assert down["reason"] == "sustained_low_load" and down["drained"]
        victim = down["drained"][0]
        wait(lambda: router.workers[victim].state == "drained", "drain")
        m = router.metrics()
        assert router.last_detection is None
        assert m.get("fleet/shed_inflight_total", 0) == 0
        assert m["autoscale/engine/ups"] >= 1
        assert m["autoscale/engine/downs"] >= 1
        assert m["autoscale/engine/flap"] == 0
        st = router.introspect_state()
        assert st["autoscale"]["target_sizes"]["engine"] == 1
        assert st["autoscale"]["drains_requested"] >= 1
    finally:
        router.stop()
        for rt in runtimes:
            rt.finished = True
        for t in threads:
            t.join(timeout=5)
        router.close()


def test_proc_spawn_factory_spawns_on_the_asked_device(monkeypatch):
    from chainermn_tpu_torch.serving import fleet as tfleet

    calls = []
    monkeypatch.setattr(tfleet, "spawn_worker",
                        lambda *a, **kw: calls.append((a, kw)) or "proc")
    spawn = tas.proc_spawn_factory("/lanes", "/lanes/p.pkl",
                                   beat_interval_s=0.1)
    wc = spawn("engine-as1", "engine")
    assert wc.name == "engine-as1" and wc.proc == "proc"
    assert calls[0][1]["device"] == "cuda"        # the card by default
    tas.proc_spawn_factory("/lanes", "/lanes/p.pkl", device="cpu")(
        "engine-as2", "engine")
    assert calls[1][0][:4] == ("/lanes", "/lanes/p.pkl", "engine-as2",
                               "engine")
    assert calls[1][1]["device"] == "cpu"


def test_serve_autoscale_refusals_in_jax_words():
    from chainermn_tpu.serve import main as jax_main
    from chainermn_tpu_torch.serve import run

    base = ["--train-steps", "0", "--requests", "1"]
    for extra in (["--autoscale", "1:2"],
                  ["--fleet-procs", "1", "--autoscale", "x"],
                  ["--fleet-procs", "1", "--autoscale", "3:2"],
                  ["--fleet-procs", "1", "--autoscale", "1:2:3"]):
        msgs = []
        for fn, dev in ((jax_main, []), (run, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                fn([*dev, *base, *extra])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], extra


def test_serve_fleet_procs_autoscale_statusz(tmp_path, capsys):
    """``serve --fleet-procs 1 --autoscale 1:2 --statusz-port 0`` over
    worker processes on the CPU: the summary carries the autoscaler's
    state (JAX's keys), and every worker exits 0 after the drain."""
    from chainermn_tpu_torch.serve import run

    summary = run(["--device", "cpu", "--train-steps", "0", "--requests",
                   "3", "--fleet-procs", "1", "--autoscale", "1:2",
                   "--statusz-port", "0", "--lane-dir",
                   str(tmp_path / "lanes")])
    err = capsys.readouterr().err
    assert "autoscale: 1:2 attached" in err and "statusz] serving" in err
    st = summary["autoscale"]
    assert set(st) == {"target_sizes", "policies", "spawn_failures",
                       "drains_requested", "interval_s"}
    assert st["policies"]["engine"]["min_workers"] == 1
    assert st["policies"]["engine"]["max_workers"] == 2
    assert st["policies"]["engine"]["flaps"] == 0
    assert summary["fleet_exit_codes"] and \
        set(summary["fleet_exit_codes"].values()) == {0}
    assert all(r["status"] == "done" for r in summary["requests"])
    json.dumps(summary)
