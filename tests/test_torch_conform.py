"""The port's conformance monitor against the JAX package's (CPU).

The same journals, written by the port's ``observability.journal`` (one
request's life across a router and a worker, as JAX's
``tests/test_journal.py`` records it, clean and with a shed after done, a
double finish, a fenced zombie beat, a leaked or aliased slot), go
through the port's ``check_dir`` and JAX's, with no model mutated and
under a mutated model (``mutate``: the lease fence landing every write,
a slot release that does not free the slot, an acquire that leaves its
slot on the free list).  The reports are equal, violations, causal chains and
offending edges included, and so are their renderings.  The port's copy
of the protocol models checks clean as JAX's does.
"""

import pytest

from chainermn_tpu.analysis import protocol as jprotocol
from chainermn_tpu.observability import conform as jconform
from chainermn_tpu_torch.analysis import protocol
from chainermn_tpu_torch.observability import conform, journal


def _run(tmp_path, *, zombie=False, double_finish=False,
         shed_after_done=False, slot_alias=False, second_request=False):
    """One request's life across a router and a worker journal (the
    port's journal; JAX's ``_synthetic_run`` recipe)."""
    d = tmp_path / "journal"
    d.mkdir()
    router = journal.Journal(str(d / "journal.router.jsonl"), "router")
    w0 = journal.Journal(str(d / "journal.w0.jsonl"), "w0")
    tid = "req-t-00000001"
    router.emit("fleet", event="submitted", trace_id=tid, worker="w0")
    wire = router.wire_emit("mbx_send", mailbox="ctl.w0", mseq=1,
                            msg_kind="submit", trace_id=tid)
    w0.recv_emit(wire, "mbx_recv", mailbox="ctl.w0", mseq=1,
                 msg_kind="submit", trace_id=tid)
    w0.emit("slot", op="init", alloc=0, n_slots=2)
    w0.emit("slot", op="acquire", alloc=0, slot=0)
    if slot_alias:
        w0.emit("slot", op="acquire", alloc=0, slot=0)
    beat = w0.wire_emit("beat", worker="w0", epoch=1, lseq=1)
    router.recv_emit(beat, "lease_judged", worker="w0", epoch=1,
                     lseq=1, admitted=True)
    w0.emit("slot", op="release", alloc=0, slot=0)
    router.emit("fleet", event="finished", trace_id=tid, worker="w0",
                reason="eos")
    if second_request:
        t2 = "req-t-00000002"
        router.emit("fleet", event="submitted", trace_id=t2, worker="w0")
        w0.emit("slot", op="acquire", alloc=0, slot=0)
        w0.emit("slot", op="release", alloc=0, slot=0)
        router.emit("fleet", event="finished", trace_id=t2, worker="w0",
                    reason="eos")
    if double_finish:
        router.emit("fleet", event="finished", trace_id=tid,
                    worker="w0", reason="eos")
    if shed_after_done:
        router.emit("fleet", event="shed", trace_id=tid)
    if zombie:
        router.emit("fence", worker="w0", epoch=1)
        beat2 = w0.wire_emit("beat", worker="w0", epoch=1, lseq=2)
        router.recv_emit(beat2, "lease_judged", worker="w0", epoch=1,
                         lseq=2, admitted=False)
    router.close()
    w0.close()
    return str(d)


def _land_all(mod):
    def mutate(model):
        def apply(s):
            e, z = s.pending[0]
            return s._replace(pending=s.pending[1:],
                              landed=s.landed + ((e, z),))
        return model.replace("fence.deliver_write", apply=apply)
    return mutate


def _leak_release(mod):
    def mutate(model):
        # release(0) drops the slot from busy but never frees it: a leak
        return model.replace("release(0)",
                             apply=lambda s: s._replace(busy=s.busy - {0}))
    return mutate


def _free_acquire(mod):
    def mutate(model):
        # acquire hands out the lowest slot without taking it off the
        # free list: the next acquire aliases it
        return model.replace(
            "acquire", apply=lambda s: s._replace(busy=s.busy | {s.free[0]}))
    return mutate


JOURNALS = {
    "clean": {},
    "zombie": {"zombie": True},
    "shed_after_done": {"shed_after_done": True},
    "double_finish": {"double_finish": True},
    "slot_alias": {"slot_alias": True},
    "two_requests": {"second_request": True},
}
MUTATORS = {
    "none": None,
    "lease_fence": ("lease_fence", _land_all),
    "slot_leak": ("slot_lifecycle", _leak_release),
    "slot_alias": ("slot_lifecycle", _free_acquire),
}


def _mutate(spec, mod):
    if spec is None:
        return None
    model, make = spec
    return {model: make(mod)}


@pytest.mark.parametrize("mut", list(MUTATORS))
@pytest.mark.parametrize("case", list(JOURNALS))
def test_check_dir_equals_jax(tmp_path, case, mut):
    jdir = _run(tmp_path, **JOURNALS[case])
    got = conform.check_dir(jdir, mutate=_mutate(MUTATORS[mut], protocol))
    want = jconform.check_dir(jdir, mutate=_mutate(MUTATORS[mut],
                                                   jprotocol))
    assert got == want
    assert conform.render_report(got) == jconform.render_report(want)
    if case in ("clean", "zombie", "two_requests") and mut == "none":
        assert got["ok"], conform.render_report(got)
    if case in ("shed_after_done", "double_finish", "slot_alias"):
        assert not got["ok"]
    if case == "two_requests" and mut.startswith("slot"):
        assert [v["model"] for v in got["violations"]] == ["slot_lifecycle"]
    if case == "zombie" and mut == "lease_fence":
        v = next(v for v in got["violations"] if v["model"] == "lease_fence")
        assert "FENCED WRITER LANDED" in v["reason"]
        assert v["edge"]["kind"] == "lease" and v["chain"]


def test_replays_equal_jax_on_one_merge(tmp_path):
    """The three replays of one merged journal, model by model."""
    jdir = _run(tmp_path, zombie=True, second_request=True)
    merged = journal.merge_journals(jdir)
    for name in ("replay_done_xor_shed", "replay_lease_fence",
                 "replay_slot_lifecycle"):
        assert getattr(conform, name)(merged) == \
            getattr(jconform, name)(merged), name
    assert conform.check_conformance(merged) == \
        jconform.check_conformance(merged)


def test_protocol_models_check_clean_as_jax():
    for make in ("make_done_xor_shed_model", "make_lease_fence_model",
                 "make_slot_model"):
        got = protocol.check(getattr(protocol, make)())
        want = jprotocol.check(getattr(jprotocol, make)())
        fields = ("ok", "n_states", "n_edges", "n_terminal", "complete",
                  "violation")
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields], make
        assert got.ok and got.n_states > 1
