"""The port's collective schedule IR, verifier and scheduled reshard against
the JAX package's (CPU).

* every generator's schedule (JSON document and fingerprint) and its price
  equal JAX's over a grid of shapes, dtypes (bf16 included: the port holds
  its elements as int16 under JAX's name), spec pairs, worlds and
  topologies, and the verifier's verdict on each is JAX's;
* the checked-in corpus (``tests/fixtures/schedules/``) verifies the same
  in both packages (ok, phases, violations, counterexample), and every
  seeded fault mutates and is caught the same;
* ``run_schedule`` moves the same bytes as JAX's (fp32 and bf16);
* ``reshard_host(schedule=k)`` for every kind equals the direct path and
  JAX's, for numpy, fp32 torch and bf16 torch leaves (a torch leaf comes
  back a torch tensor of its dtype);
* the schedule-execution records (journal) and the ``schedule_exec/*``
  gauges carry JAX's keys, ``/metricsz`` shows them, and the calibration
  provider reads as JAX's.
"""

import importlib
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.analysis import schedule as JS
from chainermn_tpu.analysis import schedule_check as JSC
from chainermn_tpu_torch.analysis import schedule as TS
from chainermn_tpu_torch.analysis import schedule_check as TSC


jr = importlib.import_module("chainermn_tpu.parallel.reshard")
tr = importlib.import_module("chainermn_tpu_torch.parallel.reshard")

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "schedules")
KINDS = ("single", "chunked", "pipelined", "hierarchical")

#: (shape, src spec, dst spec, src world, dst world, topology (slices,
#: per slice) or None)
GRID = [
    ((24, 4), 0, None, 4, 4, (2, 2)),
    ((24, 4), 0, 1, 4, 4, (4, 1)),
    ((24, 4), 0, 0, 4, 2, None),
    ((24, 4), 0, 0, 2, 4, (2, 2)),
    ((12, 6, 2), 1, 0, 3, 2, None),
    ((16,), 0, 0, 4, 1, None),
    ((8, 8), None, 0, 2, 4, (2, 2)),
]
DTYPES = ("float32", "bfloat16", "int32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topo(mod, t):
    return None if t is None else mod.Topology(*t)


def _verdict(res):
    return (res.ok, dict(res.phases), list(res.violations),
            list(res.counterexample or []))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", range(len(GRID)))
def test_generators_equal_jax(kind, case):
    shape, src, dst, sw, dw, topo = GRID[case]
    for dtype in DTYPES:
        kw = dict(n_chunks=2) if kind != "single" else {}
        if kind == "pipelined":
            kw["depth"] = 2
        try:
            want = JS.GENERATORS[kind](shape, dtype, src, dst, sw, dw,
                                       _topo(JS, topo), **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30]):
                TS.GENERATORS[kind](shape, dtype, src, dst, sw, dw,
                                    _topo(TS, topo), **kw)
            continue
        got = TS.GENERATORS[kind](shape, dtype, src, dst, sw, dw,
                                  _topo(TS, topo), **kw)
        assert got.to_json() == want.to_json()
        assert got.fingerprint() == want.fingerprint()
        assert TS.price_schedule(got) == JS.price_schedule(want)
        if dtype == "float32":
            assert _verdict(TSC.verify_schedule(got)) == \
                _verdict(JSC.verify_schedule(want))


@pytest.mark.parametrize("name,src,dst,sw,dw", TSC.FLEET_PAIRS,
                         ids=[p[0] for p in TSC.FLEET_PAIRS])
def test_fleet_pairs_compile_as_jax(name, src, dst, sw, dw):
    assert TSC.FLEET_PAIRS == JSC.FLEET_PAIRS
    got, grep = TSC.compile_verified((24, 4), "float32", src, dst, sw, dw,
                                     TSC.fleet_pair_topology(sw, dw))
    want, wrep = JSC.compile_verified((24, 4), "float32", src, dst, sw, dw,
                                      JSC.fleet_pair_topology(sw, dw))
    assert got.fingerprint() == want.fingerprint()
    assert grep == wrep


def _fixture_files():
    return sorted(f for f in os.listdir(FIXTURES) if f.endswith(".json"))


@pytest.mark.parametrize("fname", _fixture_files())
def test_fixture_corpus_verifies_as_jax(fname):
    with open(os.path.join(FIXTURES, fname)) as f:
        doc = json.load(f)
    got = TSC.verify_schedule(TS.Schedule.from_json(doc))
    want = JSC.verify_schedule(JS.Schedule.from_json(doc))
    assert _verdict(got) == _verdict(want)
    assert got.ok == fname.startswith("clean_")


@pytest.mark.parametrize("fault", sorted(JSC.SEEDED_FAULTS))
def test_seeded_faults_mutate_and_are_caught_as_jax(fault):
    assert sorted(TSC.SEEDED_FAULTS) == sorted(JSC.SEEDED_FAULTS)
    bases = [(JS.lower_hierarchical((24, 4), "float32", 0, None, 4, 4,
                                    JS.Topology(2, 2), n_chunks=2),
              TS.lower_hierarchical((24, 4), "float32", 0, None, 4, 4,
                                    TS.Topology(2, 2), n_chunks=2)),
             (JS.lower_chunked((24, 4), "float32", 0, None, 4, 4,
                               JS.Topology(2, 2), n_chunks=2),
              TS.lower_chunked((24, 4), "float32", 0, None, 4, 4,
                               TS.Topology(2, 2), n_chunks=2))]
    for jbase, tbase in bases:
        try:
            jbad = JSC.seed_fault(jbase, fault)
        except ValueError:
            with pytest.raises(ValueError):
                TSC.seed_fault(tbase, fault)
            continue
        tbad = TSC.seed_fault(tbase, fault)
        assert tbad.to_json() == jbad.to_json()
        got, want = TSC.verify_schedule(tbad), JSC.verify_schedule(jbad)
        assert not got.ok
        assert _verdict(got) == _verdict(want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_schedule_bytes_equal_jax(kind, dtype):
    shape = (24, 4)
    kw = {} if kind == "single" else dict(n_chunks=2)
    jsched = JS.GENERATORS[kind](shape, dtype, 0, 0, 4, 2,
                                 JS.Topology(2, 2), **kw)
    tsched = TS.GENERATORS[kind](shape, dtype, 0, 0, 4, 2,
                                 TS.Topology(2, 2), **kw)
    rng = np.random.RandomState(3)
    base = rng.randn(*shape).astype(np.float32)
    jbase = base.astype(jax.numpy.bfloat16) if dtype == "bfloat16" \
        else base
    want = JSC.run_schedule(jsched, JSC.make_input_blocks(jsched, jbase))
    # the port moves bf16 as its int16 bytes
    tbase = np.asarray(jbase).view(np.int16) if dtype == "bfloat16" \
        else base
    got = TSC.run_schedule(tsched, TSC.make_input_blocks(tsched, tbase))
    for g, w in zip(got, want):
        assert g.tobytes() == np.asarray(w).tobytes()


def _shards(sw, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(24, 4).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    return [{"w": x, "b": y} for x, y in zip(np.array_split(w, sw),
                                             np.array_split(b, sw))]


def _as_np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ("auto",) + KINDS)
@pytest.mark.parametrize("sw,dw", [(4, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("leaf", ["numpy", "fp32", "bf16"])
def test_reshard_host_schedule_equals_direct_and_jax(kind, sw, dw, leaf):
    shards = _shards(sw)
    layout = {"w": 0, "b": 0}
    want = jr.reshard_host(
        [{k: (v.astype(jax.numpy.bfloat16) if leaf == "bf16" else v)
          for k, v in s.items()} for s in shards],
        layout, layout, dw, schedule=kind)
    if leaf == "numpy":
        ours = shards
    else:
        dt = torch.bfloat16 if leaf == "bf16" else torch.float32
        ours = [{k: torch.from_numpy(v).to(dt) for k, v in s.items()}
                for s in shards]
    via = tr.reshard_host(ours, layout, layout, dw, schedule=kind)
    direct = tr.reshard_host(ours, layout, layout, dw)
    for d in range(dw):
        for k in ("w", "b"):
            if leaf != "numpy":
                assert isinstance(via[d][k], torch.Tensor)
                assert via[d][k].dtype == ours[0][k].dtype
            assert _as_np(via[d][k]).tobytes() == \
                _as_np(direct[d][k]).tobytes()
            assert _as_np(via[d][k]).tobytes() == \
                _as_np(want[d][k]).tobytes(), (kind, d, k)


def test_replicated_and_per_rank_leaves_keep_the_direct_path():
    reps = [{"r": torch.full((3, 3), float(i)), "p": np.int64(i)}
            for i in range(2)]
    out = tr.reshard_host(reps, {"r": None, "p": "per_rank"},
                          {"r": None, "p": "per_rank"}, 4, schedule="auto")
    for d in range(4):
        assert torch.equal(out[d]["r"], reps[0]["r"])
        assert out[d]["p"] == d % 2


def test_lower_schedule_names_dtypes_as_jax():
    for dt, name in [(torch.bfloat16, "bfloat16"),
                     (torch.float32, "float32"),
                     (np.dtype("float16"), "float16"), ("int32", "int32")]:
        got = tr.lower_schedule((24, 4), dt, 0, 0, 4, 2, kind="chunked",
                                topology=TS.Topology(2, 2))
        want = jr.lower_schedule((24, 4), name, 0, 0, 4, 2,
                                 kind="chunked",
                                 topology=JS.Topology(2, 2))
        assert got.dtype == name
        assert got.fingerprint() == want.fingerprint()
        assert TSC.verify_schedule(got).ok


def _run_journaled(tmp_path, comm, journal, reshard_host, shards):
    comm.reset_schedule_exec()
    journal.reset()
    try:
        journal.configure(str(tmp_path), "w0")
        out = reshard_host(shards, {"w": 0, "b": 0}, {"w": 0, "b": 0}, 2,
                           schedule="auto")
        events = [e for e in journal.read_journal(
            journal.get_journal().path) if e.get("kind") == "schedule_exec"]
        return out, events, comm.schedule_exec_gauges()
    finally:
        journal.reset()


def test_schedule_exec_records_and_gauges_match_jax(tmp_path):
    from chainermn_tpu.observability import comm as jcomm
    from chainermn_tpu.observability import journal as jjournal
    from chainermn_tpu_torch.analysis import calibrate as TCA
    from chainermn_tpu_torch.observability import comm as tcomm
    from chainermn_tpu_torch.observability import journal as tjournal
    from chainermn_tpu_torch.observability.introspect import StatusServer

    shards = _shards(4)
    try:
        _, jev, jg = _run_journaled(tmp_path / "j", jcomm, jjournal,
                                    jr.reshard_host, shards)
        out, tev, tg = _run_journaled(tmp_path / "t", tcomm, tjournal,
                                      tr.reshard_host, shards)
        assert tev and len(tev) == len(jev)
        strip = {"t", "t_us", "wall_us", "run", "hlc", "ts", "wall", "pid",
                 "seq", "worker"}
        for a, b in zip(tev, jev):
            assert set(a) == set(b)
            assert {k: v for k, v in a.items() if k not in strip} == \
                {k: v for k, v in b.items() if k not in strip}
        assert set(tg) == set(jg)
        for k in tg:
            if not k.endswith("/wall_us"):
                assert tg[k] == jg[k], k
        assert "schedule_exec" in StatusServer().metricsz()
        snap = tcomm.calibration_snapshot()
        assert set(snap) == {"counters", "calibration"}
        assert set(snap["counters"]) == set(jg)
        recs = TCA.read_exec_records(str(tmp_path / "t"))
        assert len(recs) == len(tev) and TCA.fit_calibration(recs)["links"]
        cal = TCA.fit_calibration(recs)
        tcomm.set_active_calibration(cal)
        assert tcomm.calibration_snapshot()["calibration"]["links"] == \
            cal["links"]
    finally:
        tcomm.reset_schedule_exec()
        jcomm.reset_schedule_exec()
    assert tcomm.schedule_exec_gauges() == {}


def test_no_journal_no_profiler():
    from chainermn_tpu_torch.observability import comm as tcomm
    from chainermn_tpu_torch.observability import journal as tjournal
    from chainermn_tpu_torch.observability import trace as ttrace

    assert not tjournal.enabled() and not ttrace.get_tracer().enabled
    tcomm.reset_schedule_exec()
    tr.reshard_host(_shards(4), {"w": 0, "b": 0}, {"w": 0, "b": 0}, 2,
                    schedule="auto")
    assert tcomm.schedule_exec_gauges() == {}


@pytest.mark.parametrize("argv,rc", [([], 0), (["--dtype", "bfloat16"], 0)])
def test_schedule_check_cli_exit_as_jax(argv, rc, capsys):
    assert TSC.main(argv) == rc == JSC.main(argv)


def test_schedule_check_cli_unusable_and_violation(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert TSC.main([str(bad)]) == 2 == JSC.main([str(bad)])
    fault = sorted(f for f in os.listdir(FIXTURES)
                   if f.startswith("fault_"))[0]
    assert TSC.main([os.path.join(FIXTURES, fault)]) == 1
    assert JSC.main([os.path.join(FIXTURES, fault)]) == 1


def test_grid_covers_every_generator_and_dtype():
    assert set(KINDS) == set(TS.GENERATORS) == set(JS.GENERATORS)
    assert len(list(itertools.product(GRID, DTYPES, KINDS))) >= 80
