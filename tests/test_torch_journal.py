"""The port's causal fleet journal vs the JAX package's.

``chainermn_tpu_torch/observability/journal.py`` is a copy of JAX's
(stdlib only): the same HLC laws, the same ``journal.v1`` lines, the same
happens-before merge.  Held here: HLC ticks and merges stamp for stamp
under one seeded schedule of skewed clocks, the bounded file's compaction
and the torn-tail / foreign-schema reading (each package reading the
other's files), a seeded merge-order fuzz (delayed, duplicated, reordered
deliveries across four processes) on which both packages' ``merge_journals``
agree event for event and edge for edge, ``request_story`` /
``request_critical_path`` and their renderings and ``export_perfetto`` on
the same events, and the flight recorder's tee (notes journaled, tracer
spans and instants not; the slot allocator, leases, epochs and fences
emit).  The CPU only.
"""

import json
import random

import pytest

from chainermn_tpu.observability import journal as jjr
from chainermn_tpu_torch.observability import flight as tflight
from chainermn_tpu_torch.observability import journal as tjr

PACKAGES = {"jax": jjr, "torch": tjr}


@pytest.fixture(autouse=True)
def _journal_off():
    """Every test starts and ends with both global journals off."""
    jjr.reset()
    tjr.reset()
    yield
    jjr.reset()
    tjr.reset()


def _strip_t(evs):
    """Events without their wall-clock ``t`` (the one field two writers
    of the same schedule do not share)."""
    return [{k: v for k, v in e.items() if k != "t"} for e in evs]


# ---------------------------------------------------------------------------
# HLC laws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hlc_stamps_equal_jax_under_one_schedule(seed):
    """Ticks and merges under skewed, sometimes frozen clocks: the same
    stamps from both packages, each strictly increasing, every receive
    after its send."""
    stamps = {}
    for name, mod in PACKAGES.items():
        rng = random.Random(seed)
        t = [rng.randrange(5000)]
        h = mod.HLC(now_us=lambda: t[0])
        out = [h.tick()]
        for _ in range(300):
            t[0] += rng.choice([0, 0, 1, 50, -20])
            if rng.random() < 0.5:
                out.append(h.tick())
            else:
                wire = (rng.randrange(6000), rng.randrange(4))
                got = h.merge(wire)
                assert got > wire
                out.append(got)
        assert all(a < b for a, b in zip(out, out[1:]))
        assert h.merge(None) > out[-1]
        stamps[name] = out
    assert stamps["torch"] == stamps["jax"]


def test_hlc_merge_orders_receive_after_send():
    sender = tjr.HLC(now_us=lambda: 5000)
    receiver = tjr.HLC(now_us=lambda: 10)      # its clock far behind
    wire = sender.tick()
    recv = receiver.merge(wire)
    assert recv > wire and receiver.tick() > recv


# ---------------------------------------------------------------------------
# the journal file: bounded, line-buffered, torn-tail tolerant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [7, 40])
def test_journal_file_stays_bounded_as_jax(tmp_path, capacity):
    files = {}
    for name, mod in PACKAGES.items():
        path = str(tmp_path / name / "journal.w0.jsonl")
        j = mod.Journal(path, "w0", capacity=capacity)
        j.hlc = mod.HLC(now_us=lambda: 1000)
        for i in range(300):
            j.emit("slot", op="acquire", slot=i % 4, alloc=0)
        j.close()
        evs = mod.read_journal(path)
        assert len(evs) <= 2 * capacity and j.dropped > 0
        seqs = [e["seq"] for e in evs]
        assert seqs == sorted(seqs) and seqs[-1] == 300
        files[name] = (path, j.dropped)
    assert files["torch"][1] == files["jax"][1]
    # each package reads the other's file to the same events
    tp, jp = files["torch"][0], files["jax"][0]
    assert _strip_t(jjr.read_journal(tp)) == _strip_t(tjr.read_journal(tp))
    assert _strip_t(tjr.read_journal(tp)) == _strip_t(tjr.read_journal(jp))


def test_read_journal_skips_torn_tail_refuses_foreign_schema(tmp_path):
    path = str(tmp_path / "journal.w0.jsonl")
    j = tjr.Journal(path, "w0")
    j.emit("beat", worker="w0")
    j.close()
    with open(path, "a") as f:
        f.write('{"schema": "chainermn_tpu.journal.v1", "proc": "w0", '
                '"kind": "beat", "hlc": [1,')   # killed mid-write
    for mod in PACKAGES.values():
        assert len(mod.read_journal(path)) == 1
    with open(path, "a") as f:
        f.write('\n{"schema": "someone.else.v9", "kind": "x"}\n')
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="refusing journal line"):
            mod.read_journal(path)


# ---------------------------------------------------------------------------
# the merge: one seeded fuzz, both packages' merges equal
# ---------------------------------------------------------------------------

def _fuzz(tmp_path, seed):
    """Four processes' journals (the port's writer) under skewed clocks,
    with delayed, duplicated and reordered mailbox deliveries; returns
    the number of events written."""
    rng = random.Random(seed)
    procs = ["router", "w0", "w1", "w2"]
    clocks = {p: [rng.randrange(0, 5000)] for p in procs}
    js = {p: tjr.Journal(str(tmp_path / f"journal.{p}.jsonl"), p,
                         capacity=10_000) for p in procs}
    for p in procs:
        js[p].hlc = tjr.HLC(now_us=lambda p=p: clocks[p][0])
    in_flight, mseq, n = [], {p: 0 for p in procs}, 0
    for _ in range(500):
        src = rng.choice(procs)
        if rng.random() < 0.4:
            clocks[src][0] += rng.choice([0, 0, 1, 7, 100])
        op = rng.random()
        if op < 0.3:
            js[src].emit("slot", op="acquire", slot=0, alloc=0)
            n += 1
        elif op < 0.45:
            w = rng.choice(procs[1:])
            wire = js[w].wire_emit("beat", worker=w, epoch=1,
                                   lseq=mseq[w] + 1000)
            js["router"].recv_emit(wire, "lease_judged", worker=w,
                                   epoch=1, lseq=mseq[w] + 1000,
                                   admitted=True)
            mseq[w] += 1
            n += 2
        elif op < 0.75:
            dst = rng.choice([p for p in procs if p != src])
            mseq[dst] += 1
            wire = js[src].wire_emit("mbx_send", mailbox=f"ctl.{dst}",
                                     mseq=mseq[dst], msg_kind="submit")
            n += 1
            in_flight.append((dst, mseq[dst], wire))
            if rng.random() < 0.15:                 # duplicated
                in_flight.append((dst, mseq[dst], wire))
        elif in_flight:                             # reordered
            dst, k, wire = in_flight.pop(rng.randrange(len(in_flight)))
            if rng.random() < 0.6:
                clocks[dst][0] += rng.choice([0, 1, 30])
            js[dst].recv_emit(wire, "mbx_recv", mailbox=f"ctl.{dst}",
                              mseq=k, msg_kind="submit")
            n += 1
    while in_flight:
        dst, k, wire = in_flight.pop(rng.randrange(len(in_flight)))
        js[dst].recv_emit(wire, "mbx_recv", mailbox=f"ctl.{dst}", mseq=k,
                          msg_kind="submit")
        n += 1
    for j in js.values():
        j.close()
    return n


@pytest.mark.parametrize("seed", [0x17C, 5])
def test_merge_fuzz_equal_jax(tmp_path, seed):
    n = _fuzz(tmp_path, seed)
    out_t = str(tmp_path / "merged.torch.json")
    got = tjr.merge_journals(str(tmp_path), out_path=out_t)
    want = jjr.merge_journals(str(tmp_path))
    assert got["schema"] == want["schema"] == tjr.MERGE_SCHEMA
    assert got["procs"] == want["procs"] == ["router", "w0", "w1", "w2"]
    assert got["events"] == want["events"] and len(got["events"]) == n
    assert got["edges"] == want["edges"]
    with open(out_t) as f:
        assert json.load(f)["edges"] == want["edges"]
    evs = got["events"]
    keys = [tjr.sort_key(e) for e in evs]
    assert keys == sorted(keys)
    for p in got["procs"]:
        stamps = [tuple(e["hlc"]) for e in evs if e["proc"] == p]
        assert all(a < b for a, b in zip(stamps, stamps[1:]))
    recvs = sum(e["kind"] in ("mbx_recv", "lease_judged") for e in evs)
    assert len(got["edges"]) == recvs
    for ed in got["edges"]:
        assert tuple(evs[ed["src"]]["hlc"]) < tuple(evs[ed["dst"]]["hlc"])
    # explicit paths merge as the directory does
    paths = tjr.find_journals(str(tmp_path))
    assert tjr.merge_journals(paths)["events"] == got["events"]


# ---------------------------------------------------------------------------
# one request's story, its critical path, the Perfetto export
# ---------------------------------------------------------------------------

def _synthetic_run(tmp_path):
    """One request's life across a router and a worker journal, written by
    the port (JAX's test fixture, frozen clocks)."""
    t = {"router": [100], "w0": [40]}
    router = tjr.Journal(str(tmp_path / "journal.router.jsonl"), "router")
    w0 = tjr.Journal(str(tmp_path / "journal.w0.jsonl"), "w0")
    for name, j in (("router", router), ("w0", w0)):
        j.hlc = tjr.HLC(now_us=lambda name=name: t[name][0])
    tid = "req-t-00000001"
    router.emit("fleet", event="submitted", trace_id=tid, worker="w0")
    t["router"][0] += 7
    wire = router.wire_emit("mbx_send", mailbox="ctl.w0", mseq=1,
                            msg_kind="submit", trace_id=tid)
    w0.recv_emit(wire, "mbx_recv", mailbox="ctl.w0", mseq=1,
                 msg_kind="submit", trace_id=tid)
    t["w0"][0] += 500
    w0.emit("slot", op="init", alloc=0, n_slots=2)
    w0.emit("slot", op="acquire", alloc=0, slot=0)
    beat = w0.wire_emit("beat", worker="w0", epoch=1, lseq=1)
    router.recv_emit(beat, "lease_judged", worker="w0", epoch=1,
                     lseq=1, admitted=True)
    w0.emit("slot", op="release", alloc=0, slot=0)
    t["router"][0] += 900
    router.emit("fleet", event="finished", trace_id=tid, worker="w0",
                reason="eos")
    router.close()
    w0.close()
    return tid


def test_request_story_and_critical_path_equal_jax(tmp_path):
    tid = _synthetic_run(tmp_path)
    merged = tjr.merge_journals(str(tmp_path))
    assert merged == jjr.merge_journals(str(tmp_path))
    story = tjr.request_story(merged, tid)
    assert story == jjr.request_story(merged, tid)
    assert story["procs"] == ["router", "w0"]
    assert story["outcome"] == {"kind": "done", "worker": "w0",
                                "reason": "eos"}
    text = tjr.render_request_story(story)
    assert text == jjr.render_request_story(story)
    assert "happens-after" in text and "outcome: done on w0" in text
    cp = tjr.request_critical_path(merged, tid)
    assert cp == jjr.request_critical_path(merged, tid)
    assert cp["dominant"]["us"] == max(s["us"] for s in cp["segments"])
    assert tjr.render_critical_path(cp) == jjr.render_critical_path(cp)
    empty = tjr.request_critical_path(merged, "req-nope")
    assert tjr.render_critical_path(empty) == \
        jjr.render_critical_path(jjr.request_critical_path(merged,
                                                           "req-nope"))


def test_export_perfetto_equal_jax(tmp_path):
    _synthetic_run(tmp_path)
    j = tjr.Journal(str(tmp_path / "journal.w1.jsonl"), "w1")
    j.hlc = tjr.HLC(now_us=lambda: 60)
    j.emit("schedule_exec", fingerprint="ab" * 8, op="copy", arg="c0",
           rank=0, link="copy", bytes=256, t_us=0.0, wall_us=12.5)
    j.emit("phase", name="reshard")
    j.close()
    merged = tjr.merge_journals(str(tmp_path))
    docs = {}
    for name, mod in PACKAGES.items():
        out = str(tmp_path / name / "journal_trace.json")
        (tmp_path / name).mkdir()
        docs[name] = mod.export_perfetto(merged, out)
        with open(out) as f:
            assert json.load(f) == docs[name]
    assert docs["torch"] == docs["jax"]
    names = {e["args"]["name"] for e in docs["torch"]["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert names == {"journal:router", "journal:w0", "journal:w1"}
    xs = [e for e in docs["torch"]["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == 1 and xs[0]["tid"] == 1 and xs[0]["dur"] == 12


# ---------------------------------------------------------------------------
# the flight tee and the emitters
# ---------------------------------------------------------------------------

def test_flight_tee_journals_notes_but_not_spans(tmp_path):
    tjr.configure(str(tmp_path), "p0")
    assert tjr.configure(str(tmp_path), "p0") is tjr.get_journal()
    tflight.note("span", name="x", dur_ms=1.0)
    tflight.note("instant", name="y")
    tflight.note("fleet", event="submitted", trace_id="t")
    tjr.reset()
    tflight.note("fleet", event="after_reset", trace_id="t")
    evs = tjr.read_journal(str(tmp_path / "journal.p0.jsonl"))
    assert [e["kind"] for e in evs] == ["fleet"]
    assert evs[0]["event"] == "submitted" and evs[0]["proc"] == "p0"
    assert tjr.wire_emit("x") is None and not tjr.enabled()


def test_configure_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(tjr.ENV_DIR, raising=False)
    assert tjr.configure_from_env() is None
    monkeypatch.setenv(tjr.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(tjr.ENV_PROC, "w/7")
    j = tjr.configure_from_env()
    assert j.path == tjr.journal_path(str(tmp_path), "w/7") == \
        jjr.journal_path(str(tmp_path), "w/7")


def test_allocator_lease_epoch_fence_emits_as_jax(tmp_path):
    """The slot allocator's transitions and the health plane's beats,
    releases, epochs and fences land in the journal as JAX's do."""
    from chainermn_tpu.health import EpochFence as JFence
    from chainermn_tpu.health import HeartbeatPublisher as JPub
    from chainermn_tpu.serving.cache_pool import SlotAllocator as JAlloc
    from chainermn_tpu_torch.health import EpochFence, HeartbeatPublisher
    from chainermn_tpu_torch.serving.cache_pool import SlotAllocator
    from chainermn_tpu_torch.serving.transfer import InProcessLaneStore

    kinds = {}
    for name, mod, alloc_cls, fence_cls, pub_cls in (
            ("jax", jjr, JAlloc, JFence, JPub),
            ("torch", tjr, SlotAllocator, EpochFence, HeartbeatPublisher)):
        d = tmp_path / name
        mod.configure(str(d), "w0")
        a = alloc_cls(2)
        s = a.acquire()
        a.cache(s)
        a.retain(s)
        a.unretain(s)
        a.uncache(s)
        r = a.reserve()
        a.commit_reservation(r)
        a.release(r)
        a.cancel_reservation(a.reserve())
        f = fence_cls()
        f.new_epoch("w0")
        f.fence("w0")
        pub = pub_cls(InProcessLaneStore(), "w0", "engine", 1)
        lease = pub.beat(queue_depth=0)
        assert lease["hlc"][0] > 0
        pub.release()
        mod.reset()
        evs = mod.read_journal(str(d / "journal.w0.jsonl"))
        kinds[name] = [(e["kind"], e.get("op"), e.get("slot"),
                        e.get("epoch"), e.get("lseq")) for e in evs]
    assert kinds["torch"] == kinds["jax"]
    assert [k[1] for k in kinds["torch"] if k[0] == "slot"] == [
        "init", "acquire", "cache", "retain", "unretain", "uncache",
        "reserve", "commit_reservation", "release", "reserve",
        "cancel_reservation"]
    assert [k[0] for k in kinds["torch"] if k[0] != "slot"] == [
        "epoch_minted", "fence", "beat", "lease_release"]
