"""The port's trace-shard merge and cross-rank skew report against the JAX
package's (CPU).

* ``shard_path`` / ``find_shards`` name and find the same files;
  ``merge_trace_shards`` of the same shards (written by the port's tracer
  at three ranks, with out-of-order stamps, an unreadable shard and a
  missing one) gives JAX's document, from the base path or from a list,
  with ``expected_ranks`` or without, and the same warnings; the journal's
  Perfetto export goes through it and gives JAX's export of the same
  journal.
* ``local_rank_summary`` reads the same step spans and ledger totals, and
  ``cross_rank_report`` of the same per-rank summaries (numpy-seeded, a
  straggler, a single controller's duplicate entries) equals JAX's.  At
  world 2 over gloo it is held to JAX's in
  ``tests/test_torch_observability.py``.
"""

import json

import numpy as np
import pytest

from chainermn_tpu.observability import aggregate as jagg
from chainermn_tpu.observability import journal as jjournal
from chainermn_tpu.observability import trace as jtrace
from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch.observability import aggregate, journal, trace


def _shards(tmp_path, n=3, seed=0):
    """``n`` rank shards of the port's tracer: spans, counters, instants
    at seeded, interleaving stamps."""
    rng = np.random.RandomState(seed)
    base = str(tmp_path / "trace.json")
    for rank in range(n):
        tr = trace.Tracer()
        tr.enable()
        for i in range(4):
            tr.complete_event("step", int(rng.randint(0, 10_000)),
                              int(rng.randint(1, 500)), cat="step",
                              iteration=i)
            tr.instant("mark", step=i)
        tr.add_counter("comm/psum/bytes", 32 * (rank + 1))
        tr.export_chrome_trace(base, rank=rank)
    return base


def test_shard_paths_equal_jax(tmp_path):
    base = _shards(tmp_path)
    for rank in (0, 7, 12345):
        assert aggregate.shard_path(base, rank) == jagg.shard_path(base,
                                                                   rank)
    assert aggregate.shard_path("t", 2) == jagg.shard_path("t", 2)
    assert aggregate.find_shards(base) == jagg.find_shards(base)
    assert sorted(aggregate.find_shards(base)) == [0, 1, 2]


@pytest.mark.parametrize("expected", [None, 3, 5])
@pytest.mark.parametrize("from_base", [True, False])
def test_merge_equals_jax(tmp_path, capsys, from_base, expected):
    base = _shards(tmp_path, seed=expected or 1)
    arg = base if from_base else [
        aggregate.shard_path(base, r) for r in (2, 0, 1)]
    got = aggregate.merge_trace_shards(arg, out_path=str(tmp_path / "p.json"),
                                       expected_ranks=expected)
    perr = capsys.readouterr().err
    want = jagg.merge_trace_shards(arg, out_path=str(tmp_path / "j.json"),
                                   expected_ranks=expected)
    jerr = capsys.readouterr().err
    assert got == want
    assert json.load(open(tmp_path / "p.json")) == \
        json.load(open(tmp_path / "j.json"))
    assert perr.replace("chainermn_tpu_torch", "chainermn_tpu") == jerr
    ts = [e["ts"] for e in got["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts) and {e["pid"] for e in got["traceEvents"]} \
        == {0, 1, 2}
    assert ("missing ranks" in perr) == (expected == 5)


def test_merge_tolerates_missing_and_unreadable_shards(tmp_path, capsys):
    ok = tmp_path / "t.rank00000.json"
    ok.write_text(json.dumps({
        "traceEvents": [
            {"name": "b", "ph": "X", "ts": 50, "dur": 1, "pid": 9, "tid": 0},
            {"name": "a", "ph": "X", "ts": 10, "dur": 1, "pid": 9, "tid": 0},
        ],
        "metadata": {"rank": 0}}))
    (tmp_path / "t.rank00001.json").write_text("{not json")
    paths = [str(ok), str(tmp_path / "t.rank00001.json"),
             str(tmp_path / "t.rank00002.json")]
    got = aggregate.merge_trace_shards(paths, expected_ranks=3)
    err = capsys.readouterr().err
    assert got == jagg.merge_trace_shards(paths, expected_ranks=3)
    assert "unreadable" in err and "missing ranks [1, 2]" in err
    assert [e["name"] for e in got["traceEvents"]] == ["a", "b"]


def test_journal_perfetto_export_equals_jax(tmp_path):
    """The journal's Perfetto rendering rides aggregate's merge: the same
    journal renders to JAX's document."""
    jdir = tmp_path / "journal"
    jdir.mkdir()
    a = journal.Journal(str(jdir / "journal.router.jsonl"), "router")
    b = journal.Journal(str(jdir / "journal.w0.jsonl"), "w0")
    wire = a.wire_emit("mbx_send", mailbox="ctl.w0", mseq=1)
    b.recv_emit(wire, "mbx_recv", mailbox="ctl.w0", mseq=1)
    b.emit("schedule_exec", op="psum", arg="x", wall_us=12.5)
    a.emit("fleet", event="finished", trace_id="t1")
    a.close()
    b.close()
    got = journal.export_perfetto(journal.merge_journals(str(jdir)),
                                  str(tmp_path / "p.json"))
    want = jjournal.export_perfetto(jjournal.merge_journals(str(jdir)),
                                    str(tmp_path / "j.json"))
    assert got == want
    assert not hasattr(journal, "AGGREGATE_SCHEMA")    # one merge, in aggregate


def test_local_rank_summary_equals_jax():
    for tr in (trace, jtrace):
        tr.reset()
        tr.enable()
        for i, dur in enumerate((1500, 2500, 900)):
            tr.complete_event("step", 1000 * i, dur, cat="step")
            tr.complete_event("step/data", 1000 * i, 10, cat="phase")
    obs.get_accountant().record("psum", "mn", 64, "float32",
                                latency_s=0.25)
    jagg.get_accountant().record("psum", "mn", 64, "float32", False,
                                 latency_s=0.25)
    try:
        got = aggregate.local_rank_summary(rank=3)
        assert got == jagg.local_rank_summary(rank=3)
        assert got["steps"] == 3 and got["comm_bytes"] == 64
    finally:
        for tr in (trace, jtrace):
            tr.disable()
            tr.reset()
        obs.get_accountant().reset()
        jagg.get_accountant().reset()


class _Gathered:
    def __init__(self, objs, rank=None):
        self.objs, self.rank = objs, rank

    def allgather_obj(self, obj):
        return list(self.objs)


def _summaries(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for r in range(n):
        k = int(rng.randint(0, 5))
        out.append({"rank": r if seed % 2 else None, "steps": k,
                    "step_time_s": [float(v) for v in
                                    0.1 + rng.rand(k) * (1 + (r == 2))],
                    "comm_bytes": int(rng.randint(0, 1 << 20)),
                    "comm_calls": int(rng.randint(0, 9)),
                    "comm_wait_s": float(rng.rand()) if r else 0.0})
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [1, 3, 4])
def test_cross_rank_report_equals_jax(seed, n):
    per_rank = _summaries(seed, n)
    if seed == 5:                 # a single controller's duplicate entries
        per_rank = per_rank + [dict(per_rank[0])]
    got = aggregate.cross_rank_report(_Gathered(per_rank), per_rank[0])
    assert got == jagg.cross_rank_report(_Gathered(per_rank), per_rank[0])
    assert got["schema"] == "chainermn_tpu.trace_merge.v1"
