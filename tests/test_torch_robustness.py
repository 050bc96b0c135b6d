"""The port's watchdog, except hook, preemption handler, flight recorder and
lanes against the JAX package's (CPU, no card).

* the watchdog: JAX's ``TestWatchdog`` (fires on a stall, not on
  heartbeats; slow but progressing extensions; disarmed on a crash;
  finalize; a bad timeout; a real run), and its abort path in a
  subprocess: the evidence files, a ``watchdog_abort`` bundle, exit 43;
* the except hook: passes through at world 1; at world 2 over gloo a
  raising rank exits 1, loudly, within its bound (subprocesses,
  ``tests/_torch_robustness_worker.py except``); the demo CLI's ``run``
  puts the handlers and the hook back when it returns;
* preemption: JAX's ``TestPreemptionHandler`` cases, the signal install
  in a subprocess;
* the flight bundle: for the same notes, the files and every field of
  the manifest, the ring and the health snapshot (its comm ledger
  included) equal JAX's, apart from the environment snapshot
  (``env.json``: torch and CUDA where JAX reports its backend);
* the lanes: classification, retries, backoff and the injected faults
  (``set_lane_fault_injector`` and ``CHAINERMN_TPU_LANE_FAULT``) give
  JAX's outcomes and flight notes for the same faults.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import chainermn_tpu.communicators.base as jbase
import chainermn_tpu.observability.flight as jflight
from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.communicators import NaiveCommunicator
from chainermn_tpu_torch.communicators import base as tbase
from chainermn_tpu_torch.extensions import (PreemptionExit,
                                            PreemptionHandler, Watchdog,
                                            create_multi_node_checkpointer)
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.observability import flight as tflight
from chainermn_tpu_torch.training import StandardUpdater, Trainer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_robustness_worker as worker  # noqa: E402


def _run_py(code, tmp_path, timeout=60):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=timeout)


# ---- the watchdog (JAX's TestWatchdog) ----

class TestWatchdog:
    def test_fires_on_stall_and_not_on_heartbeat(self):
        fired = []
        wd = Watchdog(timeout=0.3, poll_interval=0.05,
                      action=lambda gap, to: fired.append((gap, to)))
        wd.initialize(trainer=None)
        for _ in range(4):
            time.sleep(0.1)
            wd.observe(trainer=None)
        assert not fired
        time.sleep(0.6)
        assert fired and fired[0][0] > 0.3
        wd.finalize()

    def test_finalize_stops_thread_before_timeout(self):
        fired = []
        wd = Watchdog(timeout=0.5, poll_interval=0.05,
                      action=lambda *a: fired.append(a))
        wd.initialize(trainer=None)
        wd.finalize()
        time.sleep(0.7)
        assert not fired

    def test_slow_but_progressing_extensions_do_not_fire(self):
        class FakeTrainer:
            last_progress = None

        fired = []
        tr = FakeTrainer()
        wd = Watchdog(timeout=0.3, poll_interval=0.05,
                      action=lambda *a: fired.append(a))
        wd.initialize(tr)
        wd.observe(tr)
        for _ in range(6):
            time.sleep(0.15)
            tr.last_progress = time.monotonic()
        assert not fired
        wd.finalize()

    def test_disarmed_when_trainer_crashes(self, tmp_path):
        fired = []
        ds = [(np.zeros((2,), np.float32), 0)] * 16

        def exploding_step(state, batch):
            raise RuntimeError("boom at step 1")

        trainer = Trainer(
            StandardUpdater(SerialIterator(ds, 8, shuffle=False),
                            exploding_step, state=None, shard=False,
                            device="cpu"),
            (2, "epoch"), out=str(tmp_path))
        wd = Watchdog(timeout=0.3, poll_interval=0.05,
                      action=lambda *a: fired.append(a))
        trainer.extend(wd)
        with pytest.raises(RuntimeError, match="boom"):
            trainer.run()
        time.sleep(0.6)
        assert not fired
        assert wd._thread is None

    def test_rejects_bad_timeout(self):
        with pytest.raises(ValueError):
            Watchdog(timeout=0)

    def test_composes_with_trainer(self, tmp_path):
        fired = []
        ds = [(np.zeros((2,), np.float32), 0)] * 16

        def step_fn(state, batch):
            return state, {"loss": 0.0}

        trainer = Trainer(StandardUpdater(SerialIterator(ds, 8,
                                                         shuffle=False),
                                          step_fn, state=None, shard=False,
                                          device="cpu"),
                          (2, "epoch"), out=str(tmp_path))
        trainer.extend(Watchdog(timeout=60.0,
                                action=lambda *a: fired.append(a)))
        trainer.run()
        assert not fired


def test_watchdog_abort_dumps_evidence_and_exits_43(tmp_path):
    """The default action: stacks, the health snapshot, a
    ``watchdog_abort`` bundle naming the last phase, exit 43."""
    out = _run_py(f"""
        import time
        import numpy as np
        from chainermn_tpu_torch.extensions import Watchdog
        from chainermn_tpu_torch.iterators import SerialIterator
        from chainermn_tpu_torch.training import StandardUpdater, Trainer

        ds = [(np.zeros((2,), np.float32), 0)] * 16
        n = [0]
        def step(state, batch):
            n[0] += 1
            if n[0] == 2:
                time.sleep(30)        # the hang
            return state, {{}}
        tr = Trainer(StandardUpdater(SerialIterator(ds, 8), step, None,
                                     shard=False, device="cpu"),
                     (4, "epoch"), out={str(tmp_path)!r})
        tr.extend(Watchdog(timeout=0.5, poll_interval=0.05))
        tr.run()
        """, tmp_path)
    assert out.returncode == 43, out.stderr[-3000:]
    assert "no step completed" in out.stderr
    assert "last completed phase" in out.stderr
    health = json.loads((tmp_path / "watchdog_health.json").read_text())
    assert health["watchdog"]["timeout_s"] == 0.5
    # the ledger's report (empty: tracing was off), as JAX's snapshot has
    assert health["comm"] == {"per_op": {}, "bytes": 0, "calls": 0,
                              "host_time_s": 0.0}
    assert health["last_step_comm"] is None and health["iteration"] == 1
    (bundle,) = tflight.find_bundles(str(tmp_path))
    b = tflight.read_bundle(bundle)
    assert b["manifest"]["reason"] == "watchdog_abort"
    assert any(ev["kind"] == "watchdog_abort" for ev in b["flight"])
    assert any(ev["kind"] == "phase" and ev["name"] == "update"
               for ev in b["flight"])


# ---- the except hook ----

def test_except_hook_install_remove_and_passthrough():
    orig = sys.excepthook
    global_except_hook.add_hook()
    assert sys.excepthook is not orig
    global_except_hook.add_hook()
    try:
        raise ValueError("boom")
    except ValueError:
        info = sys.exc_info()
    global_except_hook._global_except_hook(*info)   # must not os._exit
    global_except_hook.remove_hook()
    assert sys.excepthook is orig


def test_except_hook_aborts_world_2_within_its_bound(tmp_path):
    rcs, logs, seconds = worker.launch("except", tmp_path, timeout=60)
    assert rcs[1] == 1, "\n".join(logs)[-4000:]
    assert "uncaught exception on process 1/2" in logs[1]
    assert "boom on rank 1" in logs[1]
    assert rcs[0] == 0
    assert seconds < 40
    (bundle,) = tflight.find_bundles(str(tmp_path))
    b = tflight.read_bundle(bundle)
    assert b["manifest"]["reason"] == "uncaught_exception"
    crash = [ev for ev in b["flight"] if ev["kind"] == "crash"]
    assert crash and crash[0]["exc_type"] == "RuntimeError"


def test_demo_run_puts_handlers_and_hook_back(tmp_path):
    """``train.run`` with a dump directory installs the flight recorder's
    signal handlers and the except hook for the run only: called
    in-process (as the tests and the smoke call it), it leaves them as it
    found them."""
    out = _run_py(f"""
        import signal, sys
        from chainermn_tpu_torch import train
        before = (sys.excepthook, signal.getsignal(signal.SIGTERM),
                  signal.getsignal(signal.SIGUSR1))
        train.run(["--device", "cpu", "--steps", "2",
                   "--flight-dump-dir", {str(tmp_path / "d")!r},
                   "--out", {str(tmp_path / "o")!r}])
        after = (sys.excepthook, signal.getsignal(signal.SIGTERM),
                 signal.getsignal(signal.SIGUSR1))
        assert after == before, (before, after)
        print("ok")
        """, tmp_path)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-3000:]


# ---- preemption (JAX's TestPreemptionHandler) ----

class _Ledger:
    def __init__(self):
        self.b = {}

    def add(self, bucket, seconds):
        self.b[bucket] = self.b.get(bucket, 0.0) + seconds


class TestPreemptionHandler:
    def _handler(self, tmp_path, with_ckpt=True, grace_s=30.0, **kw):
        import signal as _signal

        exits = []
        h = PreemptionHandler(
            create_multi_node_checkpointer(
                "job", NaiveCommunicator(size=8),
                path=str(tmp_path / "ckpt")) if with_ckpt else None,
            grace_s=grace_s, dump_dir=str(tmp_path / "dump"),
            exit_fn=exits.append, **kw)
        return h, exits, _signal

    def test_signal_sets_flag_only(self, tmp_path):
        h, exits, signal = self._handler(tmp_path)
        assert not h.requested
        h._on_signal(signal.SIGTERM, None)
        assert h.requested and not h.completed
        assert exits == []
        h.completed = True      # stop the deadline thread

    def test_finish_saves_books_dumps_and_exits_zero(self, tmp_path):
        ledger = _Ledger()
        h, exits, signal = self._handler(tmp_path, ledger=ledger)
        h._on_signal(signal.SIGTERM, None)
        with pytest.raises(PreemptionExit) as ei:
            h.check({"w": np.arange(4.0)}, iteration=11)
        assert ei.value.code == 0 and ei.value.generation == 11
        assert h.completed
        loaded, it = h.checkpointer.maybe_load()
        assert it == 11
        np.testing.assert_array_equal(loaded["w"], np.arange(4.0))
        assert ledger.b["checkpoint"] > 0
        bundles = os.listdir(tmp_path / "dump")
        assert len(bundles) == 1 and "-preempt" in bundles[0]
        extra = tflight.read_bundle(str(tmp_path / "dump" / bundles[0]))[
            "manifest"]["extra"]["preempt"]
        assert extra["signal"] == "SIGTERM"
        assert extra["generation_saved"] == 11
        assert extra["why_not_saved"] is None
        assert extra["grace_used_s"] <= h.grace_s
        assert "resume" in extra["resume_hint"]

    def test_grace_deadline_bounds_a_wedged_step(self, tmp_path):
        h, exits, signal = self._handler(tmp_path, grace_s=0.3)
        h._on_signal(signal.SIGTERM, None)
        deadline = time.monotonic() + 5.0
        while not exits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert exits == [0]
        bundles = os.listdir(tmp_path / "dump")
        assert len(bundles) == 1
        extra = tflight.read_bundle(str(tmp_path / "dump" / bundles[0]))[
            "manifest"]["extra"]
        assert "grace budget exhausted" in extra["preempt"]["why_not_saved"]
        assert extra["preempt"]["generation_saved"] is None

    def test_no_checkpointer_still_bounded_exit_zero(self, tmp_path):
        h, exits, signal = self._handler(tmp_path, with_ckpt=False,
                                         grace_s=5.0)
        h._on_signal(signal.SIGTERM, None)
        with pytest.raises(PreemptionExit) as ei:
            h.check({"x": 1}, iteration=2)
        assert ei.value.code == 0 and ei.value.generation is None

    def test_save_failure_still_exits_zero_with_reason(self, tmp_path):
        h, exits, signal = self._handler(tmp_path)
        h._on_signal(signal.SIGTERM, None)
        with pytest.raises(PreemptionExit) as ei:
            h.check({"bad": lambda: None}, iteration=4)
        assert ei.value.code == 0 and ei.value.generation is None
        bundles = os.listdir(tmp_path / "dump")
        extra = tflight.read_bundle(str(tmp_path / "dump" / bundles[0]))[
            "manifest"]["extra"]
        assert "save failed" in extra["preempt"]["why_not_saved"]

    def test_rejects_nonpositive_grace(self):
        with pytest.raises(ValueError, match="grace_s"):
            PreemptionHandler(None, grace_s=0)


def test_preemption_install_uninstall_restores_disposition(tmp_path):
    """Signal handlers change the interpreter: checked in a subprocess."""
    out = _run_py(f"""
        import signal
        from chainermn_tpu_torch.extensions import PreemptionHandler
        from chainermn_tpu_torch.observability import flight
        prev = signal.getsignal(signal.SIGTERM)
        h = PreemptionHandler(None, dump_dir={str(tmp_path)!r})
        h.install()
        assert signal.getsignal(signal.SIGTERM) == h._on_signal
        h.install()
        h.uninstall()
        assert signal.getsignal(signal.SIGTERM) == prev
        flight.install_signal_handlers({str(tmp_path)!r})
        flight.install_signal_handlers()      # idempotent
        assert signal.getsignal(signal.SIGTERM) is flight._signal_dump
        assert flight._prev_handlers[signal.SIGTERM] == prev
        print("ok")
        """, tmp_path)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---- the flight bundle against JAX's ----

def _notes(mod):
    rec = mod.get_flight_recorder()
    rec.clear()
    mod.note("phase", name="update", iteration=1)
    mod.note("dcn_lane_retry", lane="kv/x", attempt=1, backoff_s=0.05,
             error="RuntimeError('timed out')")
    mod.note("preempt", signal="SIGTERM", generation=7, saved=True)
    mod.register_provider("p", lambda: {"a": [1, 2]})
    mod.register_provider("broken", lambda: 1 / 0)


def _strip(ev):
    return {k: v for k, v in ev.items() if k != "t"}


@pytest.fixture
def clean_ledgers():
    """Both packages' comm ledgers empty and their flight providers set
    aside for the test: the bundle's ``health`` carries the ledgers and
    its ``providers`` every registered provider, and another test in this
    process may have booked either ledger or left a provider (a schedule
    execution registers ``calibration`` in its own package only).  The
    providers are put back afterwards."""
    from chainermn_tpu.observability import comm as jcomm
    from chainermn_tpu_torch.observability import comm as tcomm

    saved = [(mod, dict(mod._PROVIDERS)) for mod in (jflight, tflight)]
    for mod, _ in saved:
        mod._PROVIDERS.clear()
    for acct in (jcomm.get_accountant(), tcomm.get_accountant()):
        acct.reset()
    try:
        yield
    finally:
        for acct in (jcomm.get_accountant(), tcomm.get_accountant()):
            acct.reset()
        for mod, providers in saved:
            mod._PROVIDERS.clear()
            mod._PROVIDERS.update(providers)


@pytest.mark.parametrize("ring", [3, 4096])
def test_bundle_files_and_fields_equal_jax(tmp_path, ring, clean_ledgers):
    bundles = {}
    for name, mod in (("jax", jflight), ("port", tflight)):
        rec = mod.get_flight_recorder()
        saved = rec.capacity, rec._ring
        rec.capacity = ring
        rec._ring = type(rec._ring)(maxlen=ring)
        try:
            _notes(mod)
            path = mod.dump_bundle(str(tmp_path / name), "watchdog_abort",
                                   rank=3, extra={"gap_s": 1.5})
            bundles[name] = mod.read_bundle(path)
            assert os.path.basename(path).endswith(
                "-watchdog_abort-rank00003")
        finally:
            mod.unregister_provider("p")
            mod.unregister_provider("broken")
            rec.capacity, rec._ring = saved
            rec.clear()
    jb, pb = bundles["jax"], bundles["port"]
    assert sorted(os.listdir(jb["path"])) == sorted(os.listdir(pb["path"]))
    for key in ("schema", "reason", "rank", "files", "ring_events",
                "ring_capacity", "ring_dropped_from_head",
                "ring_dropped_by_kind", "extra"):
        assert pb["manifest"][key] == jb["manifest"][key], key
    assert [_strip(e) for e in pb["flight"]] == \
        [_strip(e) for e in jb["flight"]]
    assert pb["providers"] == jb["providers"]
    assert set(pb["health"]) == set(jb["health"])
    for key in ("schema", "kind", "tracing_enabled"):
        assert pb["health"][key] == jb["health"][key]
    for key in ("comm", "last_step_comm"):     # the comm ledger's
        assert pb["health"][key] == jb["health"][key], key
    env = pb["env"]
    assert env["pid"] == os.getpid() and "torch_version" in env
    assert not any(k.startswith(("JAX_", "XLA_")) for k in env["env"])


def test_tracer_tee_and_find_bundles(tmp_path):
    from chainermn_tpu_torch.observability import trace

    rec = tflight.get_flight_recorder()
    rec.clear()
    tr = trace.Tracer()
    tr.enable()
    tflight.install_tracer_tee(tr)
    with tr.span("step", cat="step", iteration=1):
        pass
    tr.instant("mark", cat="instant")
    tflight.uninstall_tracer_tee(tr)
    kinds = [(e["kind"], e["name"]) for e in rec.events()]
    assert kinds == [("span", "step"), ("instant", "mark")]
    os.makedirs(tmp_path / "bundle-x.tmp-1")
    tflight.dump_bundle(str(tmp_path), "probe")
    found = tflight.find_bundles(str(tmp_path))
    assert len(found) == 1 and found[0].endswith("-probe")
    rec.clear()


# ---- the lanes against JAX's ----

@pytest.fixture()
def clean_lanes():
    for mod in (jbase, tbase):
        mod.set_lane_fault_injector(None)
    jflight.get_flight_recorder().clear()
    tflight.get_flight_recorder().clear()
    yield
    for mod in (jbase, tbase):
        mod.set_lane_fault_injector(None)
    os.environ.pop("CHAINERMN_TPU_LANE_FAULT", None)
    for mod in (jbase, tbase):
        mod._ENV_FAULT = None


def test_classification_equals_jax():
    msgs = list(tbase.TRANSIENT_LANE_PATTERNS) + [
        "Wait timeout", "boom", "DEADLINE_EXCEEDED: x", "Connection reset "
        "by peer", "socket timed out", "key not found"]
    assert tbase.TRANSIENT_LANE_PATTERNS == jbase.TRANSIENT_LANE_PATTERNS
    for m in msgs:
        assert tbase.classify_lane_error(RuntimeError(m)) == \
            jbase.classify_lane_error(RuntimeError(m)), m


def _drive(mod, flight_mod, faults, cfg_kw, env=None):
    """Run one lane call under an injected fault schedule; return the
    outcome, the attempts the injector saw and the flight notes."""
    seen = []

    def injector(lane, attempt):
        seen.append((lane, attempt))
        if attempt < len(faults) and faults[attempt]:
            raise RuntimeError(faults[attempt])

    mod.set_lane_fault_injector(injector if faults else None)
    if env:
        os.environ["CHAINERMN_TPU_LANE_FAULT"] = env
    mod._ENV_FAULT = None
    cfg = mod.LaneConfig(backoff_base_s=0.001, backoff_max_s=0.004,
                         **cfg_kw)
    try:
        out = ("ok", mod.lane_call("kv_store/get/test", lambda: "payload",
                                   cfg))
    except mod.DcnLaneError as e:
        out = ("DcnLaneError", e.lane, e.attempts, str(e.cause))
    finally:
        mod.set_lane_fault_injector(None)
        os.environ.pop("CHAINERMN_TPU_LANE_FAULT", None)
    notes = [{k: v for k, v in ev.items() if k not in ("t", "seq")}
             for ev in flight_mod.get_flight_recorder().events()]
    flight_mod.get_flight_recorder().clear()
    return out, seen, notes


LANE_CASES = {
    "clean": ([], {"max_retries": 3}, None),
    "transient_then_ok": (["deadline exceeded", "connection reset", None],
                          {"max_retries": 3}, None),
    "transient_exhausted": (["unavailable"] * 6, {"max_retries": 2}, None),
    "permanent": (["disk on fire"], {"max_retries": 3}, None),
    "env_transient": ([], {"max_retries": 3},
                      "kv_store/*:transient:2"),
    "env_permanent_after": ([], {"max_retries": 3},
                            "get/test:permanent:1:after=0"),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_lane_retries_equal_jax(clean_lanes, case):
    faults, cfg_kw, env = LANE_CASES[case]
    want = _drive(jbase, jflight, faults, cfg_kw, env)
    got = _drive(tbase, tflight, faults, cfg_kw, env)
    assert got == want
