"""The port's cost-model calibration (``analysis/calibrate.py``) against the
JAX package's, on the same records (CPU).

* ``fit_calibration``, ``drift_report`` and ``schedule_critical_path``
  equal JAX's at rtol 1e-12 on synthetic records with known per-link
  constants, on records with noise, and on the records of a profiled
  execution of every fleet pair's verified schedule (the port's profiler
  run, fed to both);
* ``read_exec_records`` keeps and drops the same lines (torn tails,
  foreign schemas, journal envelopes);
* ``save_calibration`` / ``load_calibration`` round-trip, a stale schema
  is refused by both, and ``price_schedule(calibration=)`` prices a
  schedule as JAX's does;
* ``calibrate.main`` keeps JAX's 0/1/2 contract and the ``calibration``
  stage rides ``python -m chainermn_tpu_torch.analysis --gate``.
"""

import json

import numpy as np
import pytest

from chainermn_tpu.analysis import calibrate as JC
from chainermn_tpu.analysis import schedule as JS
from chainermn_tpu.analysis import schedule_check as JSC
from chainermn_tpu_torch.analysis import calibrate as TC
from chainermn_tpu_torch.analysis import schedule as TS
from chainermn_tpu_torch.analysis import schedule_check as TSC

RTOL = 1e-12
SIZES = [1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18]
TRUE = {"ici": (2e-6, 8e9), "dcn": (30e-6, 1.5e9), "copy": (1e-6, 20e9)}


def _rec(op, arg, link, nbytes, wall_us, rank=0, run="run0", seq=0):
    return {"schema": TSC.SCHEDULE_EXEC_SCHEMA, "fingerprint": "f" * 16,
            "schedule": "synthetic", "sched_kind": "chunked",
            "run": run, "seq": seq, "op": op, "arg": arg, "rank": rank,
            "link": link, "bytes": int(nbytes), "t_us": 0.0,
            "wall_us": float(wall_us)}


def _synthetic(noise=0.0, seed=0):
    rng = np.random.RandomState(seed)
    recs = []
    for link in ("ici", "dcn"):
        alpha, bw = TRUE[link]
        for i, b in enumerate(SIZES):
            w = (alpha + b / bw) * 1e6 * (1 + noise * rng.randn())
            recs.append(_rec("start", f"t_{link}_{i}", link, b, w,
                             seq=2 * i))
            recs.append(_rec("done", f"t_{link}_{i}", link, b,
                             abs(noise * rng.randn()), rank=1,
                             seq=2 * i + 1))
    for i, b in enumerate(SIZES):
        alpha, bw = TRUE["copy"]
        recs.append(_rec("copy", f"c{i}", "copy", b,
                         (alpha + b / bw) * 1e6 * (1 + noise * rng.randn()),
                         seq=100 + i))
    return recs


def _profiled_records():
    """The port's profiler over every fleet pair's verified schedule."""
    recs = []
    for name, src, dst, sw, dw in TSC.FLEET_PAIRS:
        sched, _ = TSC.compile_verified((24, 4), "float32", src, dst, sw,
                                        dw, TSC.fleet_pair_topology(sw, dw))
        _, prof = TSC.execute_profiled(sched, reps=2)
        recs.extend(prof.records)
    return recs


def _close(a, b, path="$"):
    """Structural equality, floats at RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _fit_without_tool(cal):
    """The artifact's comment names the package that fitted it."""
    return {k: v for k, v in cal.items() if k != "comment"}


RECORD_SETS = {
    "synthetic": lambda: _synthetic(),
    "noisy": lambda: _synthetic(noise=0.05, seed=3),
    "profiled": _profiled_records,
}


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_fit_calibration_equals_jax(name):
    recs = RECORD_SETS[name]()
    got, want = TC.fit_calibration(recs), JC.fit_calibration(recs)
    _close(_fit_without_tool(got), _fit_without_tool(want))
    assert len(got["comment"]) == len(want["comment"])
    _close(TC.transfer_samples(recs), JC.transfer_samples(recs))


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_drift_report_equals_jax(name):
    recs = RECORD_SETS[name]()
    cal = JC.fit_calibration(recs)
    _close(TC.drift_report(recs, cal), JC.drift_report(recs, cal))
    rotten = json.loads(json.dumps(cal))
    for link in rotten["links"]:
        rotten["links"][link]["bw"] *= 1e3
        rotten["links"][link]["alpha_s"] = 0.0
    got, want = TC.drift_report(recs, rotten), JC.drift_report(recs, rotten)
    _close(got, want)
    if name != "profiled":
        assert not got["ok"]


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_critical_path_equals_jax(name):
    recs = RECORD_SETS[name]()
    _close(TC.schedule_critical_path(recs), JC.schedule_critical_path(recs))


def test_critical_path_hand_built_chain():
    recs = [
        _rec("copy", "c0", "copy", 64, 10.0, rank=0, seq=0),
        _rec("start", "t0", "ici", 64, 5.0, rank=0, seq=1),
        _rec("done", "t0", "ici", 64, 20.0, rank=1, seq=2),
        _rec("copy", "c1", "copy", 64, 1.0, rank=1, seq=3),
    ]
    got = TC.schedule_critical_path(recs)
    _close(got, JC.schedule_critical_path(recs))
    assert got["critical_path_us"] == pytest.approx(36.0)
    assert got["dominant_link"] == "ici"


def test_read_exec_records_equals_jax(tmp_path):
    recs = _synthetic()
    raw = tmp_path / "records.jsonl"
    lines = [json.dumps(r) for r in recs]
    lines.insert(3, json.dumps({"schema": "someone.else.v1", "x": 1}))
    lines.append('{"schema": "chainermn_tpu.schedule_exec.v1", "op": "st')
    raw.write_text("\n".join(lines))
    jdir = tmp_path / "journal"
    jdir.mkdir()
    (jdir / "journal-w0.jsonl").write_text("\n".join(
        json.dumps({"schema": "chainermn_tpu.journal.v1", "kind":
                    "schedule_exec", "hlc": [1, i], "worker": "w0",
                    **{k: v for k, v in r.items() if k != "schema"}})
        for i, r in enumerate(recs)) + "\n")
    for p in (raw, jdir):
        got, want = TC.read_exec_records(str(p)), JC.read_exec_records(str(p))
        assert got == want
        assert len(got) == len(recs)


def test_save_load_round_trip_and_stale_schema(tmp_path):
    cal = TC.fit_calibration(_synthetic())
    path = tmp_path / "cal.json"
    TC.save_calibration(cal, str(path))
    assert TC.load_calibration(str(path)) == cal
    assert _fit_without_tool(JC.load_calibration(str(path))) == \
        _fit_without_tool(cal)
    stale = dict(cal, schema="chainermn_tpu.calibration.v0")
    TC.save_calibration(stale, str(path))
    for mod in (TC, JC):
        with pytest.raises(ValueError):
            mod.load_calibration(str(path))
    with pytest.raises(ValueError):
        TS.price_schedule(TS.lower_single((24, 4), "float32", 0, 1, 4, 4,
                                          TS.Topology(2, 2)),
                          calibration=stale)


def test_calibrated_pricing_equals_jax():
    cal = JC.fit_calibration(_synthetic())
    for kind in ("single", "chunked", "hierarchical"):
        kw = {} if kind == "single" else dict(n_chunks=2)
        t = TS.GENERATORS[kind]((24, 4), "float32", 0, None, 4, 4,
                                TS.Topology(2, 2), **kw)
        j = JS.GENERATORS[kind]((24, 4), "float32", 0, None, 4, 4,
                                JS.Topology(2, 2), **kw)
        _close(TS.price_schedule(t, calibration=cal),
               JS.price_schedule(j, calibration=cal))
    got = TSC.compile_verified((24, 4), "float32", 0, None, 4, 4,
                               TS.Topology(2, 2), calibration=cal)
    want = JSC.compile_verified((24, 4), "float32", 0, None, 4, 4,
                                JS.Topology(2, 2), calibration=cal)
    assert got[0].fingerprint() == want[0].fingerprint()
    _close(got[1], want[1])


def test_cli_exit_contract_as_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CHAINERMN_SCHEDULE_EXEC_RECORDS", raising=False)
    monkeypatch.delenv("CHAINERMN_CALIBRATION", raising=False)
    for mod in (TC, JC):
        assert mod.main(["--gate"]) == 0
        assert mod.main([]) == 2
    recs = tmp_path / "records.jsonl"
    recs.write_text("\n".join(json.dumps(r) for r in _synthetic()) + "\n")
    out = tmp_path / "calibration.json"
    assert TC.main([str(recs), "--fit-out", str(out), "--gate"]) == 0
    cal = TC.load_calibration(str(out))
    for link in ("ici", "dcn"):
        cal["links"][link]["bw"] *= 1e3
        cal["links"][link]["alpha_s"] = 0.0
    rotten = tmp_path / "rotten.json"
    TC.save_calibration(cal, str(rotten))
    for mod in (TC, JC):
        assert mod.main([str(recs), "--calibration", str(rotten),
                         "--gate"]) == 1
    cal["schema"] = "chainermn_tpu.calibration.v0"
    TC.save_calibration(cal, str(rotten))
    for mod in (TC, JC):
        assert mod.main([str(recs), "--calibration", str(rotten)]) == 2


def test_calibration_stage_rides_the_gate(tmp_path, monkeypatch):
    from chainermn_tpu_torch.analysis.cli import GATE_STAGES, gate_main

    assert "calibration" in GATE_STAGES
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CHAINERMN_SCHEDULE_EXEC_RECORDS", raising=False)
    assert gate_main(["--stages", "calibration"]) == 0
    recs = tmp_path / "schedule_exec.jsonl"
    recs.write_text("\n".join(json.dumps(r) for r in _synthetic()) + "\n")
    assert gate_main(["--stages", "calibration"]) == 0
