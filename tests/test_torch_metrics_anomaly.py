"""The port's detectors, health monitor, step breakdown and metrics stream
against the JAX package's (CPU).

* The four detectors and ``HealthMonitor`` fed the same numpy-seeded
  streams (step times with spikes, losses with a divergence and a NaN,
  comm bytes with a drift, MFU with a sustained drop) give JAX's findings
  field for field, and the monitor JAX's counts, health record and log
  lines (the time stamp and the package prefix aside).
* ``StepBreakdownReport`` through a ``Trainer`` publishes JAX's
  observation keys, ``perf/mfu`` with ``peak_flops`` passed; a NaN loss
  trips ``LossAnomalyDetector`` in a trainer run, and ``MetricsReport``
  streams JAX's records (step records, then the summary with the
  finding).
* The peak table: ``NVIDIA H100 80GB HBM3`` gives 989e12 bf16 FLOP/s and
  3.35e12 B/s; a PCIe or NVL H100, the CPU and JAX's TPU kinds give None.
"""

import io
import json

import numpy as np
import pytest
import torch

from chainermn_tpu.observability import anomaly as janomaly
from chainermn_tpu.observability import export as jexport
from chainermn_tpu.observability import metrics as jmetrics
from chainermn_tpu.observability import trace as jtrace
from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch.observability import anomaly, export, metrics


def _js(x):
    """A finding list as JSON text: NaN values compare equal so."""
    return json.dumps(x, sort_keys=True)


def _streams(seed=0, n=40):
    rng = np.random.RandomState(seed)
    step = 0.1 + 0.005 * rng.randn(n)
    step[[12, 25, 26]] = [0.9, 1.4, 1.5]
    loss = 2.0 * np.exp(-0.05 * np.arange(n)) + 0.01 * rng.randn(n)
    loss[30] = 40.0
    loss[35] = np.nan
    comm = np.full(n, 4096.0) + rng.randint(0, 8, n)
    comm[20:] *= 2.5
    mfu = 0.4 + 0.01 * rng.randn(n)
    mfu[15:22] = 0.05
    return {"step_time_s": step, "loss": loss, "comm_bytes": comm,
            "mfu": mfu}


DETECTORS = {
    "spike": lambda m: m.StepTimeSpikeDetector(warmup=3, threshold_z=3.0),
    "spike_default": lambda m: m.StepTimeSpikeDetector(),
    "loss": lambda m: m.LossAnomalyDetector(warmup=3,
                                            divergence_factor=3.0),
    "loss_default": lambda m: m.LossAnomalyDetector(),
    "drift": lambda m: m.CommBytesDriftDetector(warmup=3, rel_tol=0.25),
    "mfu": lambda m: m.MFUDropDetector(warmup=2, patience=3, frac=0.5),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(DETECTORS))
def test_detector_findings_equal_jax(name, seed):
    streams = _streams(seed)
    got = {}
    for mod in (anomaly, janomaly):
        det = DETECTORS[name](mod)
        values = streams[det.metric]
        got[mod] = [f for i, v in enumerate(values)
                    if (f := det.update(float(v), i)) is not None]
        got[mod].append(det.update(None, len(values)))   # absent: skipped
    assert _js(got[anomaly]) == _js(got[janomaly])
    assert len(got[anomaly]) > 1


class _FakeTrainer:
    """What the monitor reads of a trainer."""

    def __init__(self):
        self.updater = type("U", (), {})()
        self.observation = {}
        self.iteration = 0
        self.last_extension_time = None


def _drive_monitor(mod, acct, streams, loss_as):
    log = io.StringIO()
    escalated = []
    mon = mod.HealthMonitor(escalate=escalated.append, log_stream=log,
                            max_findings=5)
    tr = _FakeTrainer()
    for i in range(len(streams["loss"])):
        tr.iteration = i + 1
        tr.updater.phase_times = {"data": 0.01,
                                  "compute": streams["step_time_s"][i]}
        tr.last_extension_time = 0.002 if i else None
        tr.observation = {"main/loss": loss_as(streams["loss"][i]),
                          "perf/mfu": float(streams["mfu"][i])}
        acct.last_step_report = {"bytes": float(streams["comm_bytes"][i]),
                                 "calls": 3, "host_time_s": 0.0,
                                 "per_op": {}}
        mon.observe(tr)
    lines = []
    for line in log.getvalue().splitlines():
        rec = json.loads(line.split("] ", 1)[1])
        rec.pop("ts")
        lines.append(rec)
    return mon, escalated, lines


@pytest.mark.parametrize("seed", [0, 3])
def test_health_monitor_equals_jax(seed):
    streams = _streams(seed)
    try:
        port = _drive_monitor(anomaly, obs.get_accountant(), streams,
                              lambda v: torch.tensor(v))
        jax = _drive_monitor(janomaly, janomaly.get_accountant(), streams,
                             float)
    finally:
        obs.get_accountant().reset()
        janomaly.get_accountant().reset()
    (pm, pesc, plines), (jm, jesc, jlines) = port, jax
    assert _js(pm.findings) == _js(jm.findings) and len(pm.findings) == 5
    assert pm.counts == jm.counts
    assert _js(pm.health()) == _js(jm.health())
    assert pm.health()["findings_dropped"]
    assert _js(pesc) == _js(jesc) and _js(plines) == _js(jlines)
    assert pm.state_dict() == jm.state_dict()
    assert {"loss_nonfinite", "step_time_spike", "comm_bytes_drift",
            "mfu_drop"} <= set(pm.counts)


class _ListIterator:
    def __init__(self, batches):
        self.batches, self.i = batches, 0
        self.epoch, self.is_new_epoch = 0, False

    def next(self):
        self.i += 1
        return self.batches[(self.i - 1) % len(self.batches)]

    @property
    def epoch_detail(self):
        return self.i / len(self.batches)


def _toy_trainer(port, step_fn, n_iter, extensions, out):
    if port:
        from chainermn_tpu_torch.training import StandardUpdater, Trainer
        kw = {"device": "cpu"}
    else:
        from chainermn_tpu.training.trainer import Trainer
        from chainermn_tpu.training.updaters import StandardUpdater
        kw = {}
    batch = (np.ones((4, 2), np.float32), np.zeros(4, np.int32))
    updater = StandardUpdater(_ListIterator([[batch]]), step_fn, state=0,
                              shard=False, **kw)
    trainer = Trainer(updater, (n_iter, "iteration"), out=str(out))
    for ext in extensions:
        trainer.extend(ext)
    return trainer


@pytest.mark.parametrize("peak", [None, 2e9])
def test_step_breakdown_keys_equal_jax(peak, tmp_path):
    seen = {}
    for port, mod in ((True, metrics), (False, jmetrics)):
        keys = []

        def probe(t, keys=keys):
            keys.append(sorted(t.observation))
        probe.trigger, probe.priority = (1, "iteration"), 50
        trainer = _toy_trainer(
            port, lambda s, b: (s + 1, {"main/loss": 0.5}), 3,
            [mod.StepBreakdownReport(flops_per_item=1e6, peak_flops=peak)],
            tmp_path / str(port))
        trainer.extend(probe, name="probe")
        trainer.run()
        seen[port] = keys
    assert seen[True] == seen[False]
    assert ("perf/mfu" in seen[True][-1]) == (peak is not None)
    assert {"time/data", "time/compute", "time/extensions",
            "throughput/items_per_sec"} <= set(seen[True][-1])


def test_nan_loss_trips_the_monitor_and_lands_in_the_stream(tmp_path):
    """A trainer run with a NaN loss from iteration 4: the monitor's
    findings, the metrics records (step, then the summary carrying the
    finding) and their keys equal JAX's."""
    out = {}
    for port, omod, amod in ((True, export, anomaly),
                             (False, jexport, janomaly)):
        tr_mod = obs if port else jtrace
        tr_mod.reset()
        tr_mod.enable()

        def step_fn(state, batch):
            loss = float("nan") if state >= 3 else 1.0 / (state + 1)
            return state + 1, {"main/loss": loss, "note": "text"}

        mon = amod.HealthMonitor(log_stream=io.StringIO())
        path = tmp_path / f"m{int(port)}.jsonl"
        rep = omod.MetricsReport(str(path), prometheus_path=f"{path}.prom",
                                 monitor=mon, prom_every=1)
        _toy_trainer(port, step_fn, 5, [mon, rep], tmp_path).run()
        tr_mod.disable()
        recs = omod.read_metrics_jsonl(str(path))
        out[port] = (mon.findings, recs, open(f"{path}.prom").read())
    (pf, precs, pprom), (jf, jrecs, jprom) = out[True], out[False]
    assert _js(pf) == _js(jf) and pf[0]["kind"] == "loss_nonfinite"
    assert [r["kind"] for r in precs] == [r["kind"] for r in jrecs] \
        == ["step"] * 5 + ["summary"]
    for p, j in zip(precs, jrecs):
        assert set(p) == set(j)
        assert {k: p[k] for k in ("iteration", "main/loss") if k in p} \
            == {k: j[k] for k in ("iteration", "main/loss") if k in j}
    assert _js(precs[-1]["anomalies"]) == _js(jrecs[-1]["anomalies"])
    assert export.parse_prometheus_text(pprom)["samples"]
    assert "# TYPE chainermn_tpu_" in pprom and "# TYPE chainermn_tpu_" \
        in jprom


@pytest.mark.parametrize("kind,peak,bw", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("nvidia h100 80gb hbm3", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", None, None),
    ("NVIDIA H100 NVL", None, None),
    ("cpu", None, None),
    ("TPU v5 lite", None, None),
    ("TPU v4", None, None),
    ("", None, None),
])
def test_peak_table(kind, peak, bw):
    assert metrics.peak_flops_for(kind) == peak
    assert metrics.hbm_bw_for(kind) == bw
    # JAX holds TPU figures only: an H100 and the CPU are unknown kinds
    if "TPU" not in kind:
        assert jmetrics.peak_flops_for(kind) is None
