"""The port's trace engine (``analysis/trace_engine.py``) and its registered
entry points (``analysis/entrypoints.py``) against JAX's jaxpr engine
(CPU, ``size="tiny"``).

Each of JAX's 17 registrations is ported under its name.  Where JAX's side
runs on this jax (0.9), the port's collective sequence and program count
are held to it: the sequence is JAX's jaxpr read by JAX's own walker
(``_iter_eqns`` / ``_axis_names``), with one reading that jax 0.9 forces —
it names a psum whose result is invariant over the axis
``psum_invariant``, a primitive JAX's engine's list does not hold, so its
engine drops the equation; read here as the ``psum`` it is.  Standing
differences, stated per entry below:

* ``train.step``: JAX's program holds the loss psum, then one psum per
  gradient leaf (autodiff's transposes, four for the tiny MLP); the port's
  step means the gradients in ONE bucketed all-reduce (booked as the
  noted ``grad_allreduce_ad``) after the backward, then the loss.  Both
  are psums over ``mn`` only.

Where JAX's side fails on jax 0.9 (``shard_map``'s replication check
refuses the builds of the decode tick and its four host-probe variants,
the prefill family, the reshard and the quantized step — checked live
below), the port is held to what JAX's docstrings state: one program
across value variants for the tick and its variants, the reshard and the
quantized step; one program per prompt length, allowlisted, for the
prefill family; the reshard's S(0)→R all_gather and S(0)→S(1)
all_to_all.  At TP = 1 the port's tensor-parallel layers elide the size-1
model axis (``parallel/_factory.model_axis``), so the tick and the
prefill book no collective, and their sequences are empty.

The seeded unbound-axis, recompile and entrypoint-error fixtures fire in
both engines (JAX's unbound-axis fixture surfaces as ``entrypoint-error``
on jax 0.9: its tracer raises an AssertionError where older jax raised
the NameError the rule reads); the port's twins are
``tests/fixtures/torch_trace/``.
"""

import importlib.util
import json
import os

import pytest
import torch

from chainermn_tpu.analysis import entrypoints as JE
from chainermn_tpu.analysis.jaxpr_engine import (_axis_names, _iter_eqns,
                                                 check_entrypoint as jcheck)
from chainermn_tpu_torch.analysis import entrypoints as TE
from chainermn_tpu_torch.analysis import trace_engine as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: entries whose JAX side runs on jax 0.9
JAX_RUNS = ["ops.collective.ring", "train.step", "train.demo_step",
            "serving.prefix_copy", "serving.kv_transfer",
            "serving.worker_lane", "serving.kv_spill",
            "serving.remote_pull", "observability.flight_ring"]
#: entries whose JAX side fails on jax 0.9, and what JAX's docstring
#: states of each: (collective sequence, program count)
TICK = ([], 1)
JAX_DOCSTRING = {
    "parallel.decode.lm_decode_tick": TICK,
    "serving.router_tick": TICK,
    "serving.supervisor_tick": TICK,
    "serving.autoscale_tick": TICK,
    "serving.tick_with_tracing": TICK,
    "serving.prefill_family": ([], 2),
    "parallel.reshard": ([("all_gather", ("mn",)),
                          ("all_to_all", ("mn",))], 1),
    # the ring short-circuits at world 1: the loss mean is the one psum
    "train.quantized_step": ([("psum", ("mn",))], 1),
}
#: JAX's jaxpr primitives that are collectives, as jax 0.9 names them
_JAX_PRIMS = {"psum", "pmax", "pmin", "ppermute", "all_gather",
              "all_to_all", "reduce_scatter", "psum_scatter"}
_RENAMED = {"psum_invariant": "psum"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_sequence(ep):
    import jax

    spec = ep.build()
    fn, args = spec["trace"]
    out = []
    for eqn in _iter_eqns(jax.make_jaxpr(fn)(*args)):
        name = _RENAMED.get(eqn.primitive.name, eqn.primitive.name)
        if name in _JAX_PRIMS:
            out.append((name, _axis_names(eqn.params)))
    return out


@pytest.fixture(scope="module")
def port():
    out = {}
    for ep in TE.ENTRYPOINTS:
        out[ep.name] = TT.check_entrypoint(ep, device="cpu", size="tiny")
    return out


@pytest.fixture(scope="module")
def jax_side():
    by = {ep.name: ep for ep in JE.ENTRYPOINTS}
    out = {}
    for name in JAX_RUNS:
        findings, report = jcheck(by[name])
        assert findings == [] and report.error is None, (name, findings)
        out[name] = (_jax_sequence(by[name]), report.n_compiles)
    return out


def test_registry_is_jax_s():
    assert [ep.name for ep in TE.ENTRYPOINTS] == \
        [ep.name for ep in JE.ENTRYPOINTS]
    assert len(TE.ENTRYPOINTS) == 17
    for t, j in zip(TE.ENTRYPOINTS, JE.ENTRYPOINTS):
        assert (t.allow_recompile, t.shardflow) == \
            (j.allow_recompile, j.shardflow), t.name
    assert set(JAX_RUNS) | set(JAX_DOCSTRING) == \
        {ep.name for ep in TE.ENTRYPOINTS}
    assert TE.NOT_PORTED == {}
    eps, err = TE.select_entrypoints(["nope"])
    assert eps is None and "unknown entry point" in err


@pytest.mark.parametrize("name", [ep.name for ep in TE.ENTRYPOINTS])
def test_every_entry_is_clean_on_the_cpu(port, name):
    findings, report = port[name]
    assert findings == [], [f.message for f in findings]
    assert report.error is None
    assert report.launches == {}        # the plain versions launch nothing
    assert report.calls >= 1


@pytest.mark.parametrize("name", JAX_RUNS)
def test_sequence_and_programs_equal_jax(port, jax_side, name):
    _, report = port[name]
    seq, n = jax_side[name]
    assert report.n_compiles == n
    if name == "train.step":
        # the standing difference: JAX's loss psum then one psum per
        # gradient leaf; the port's one bucketed gradient mean, then the
        # loss (module docstring)
        assert seq == [("psum", ("mn",))] * 5
        assert report.collectives == [("psum", ("mn",))] * 2
        return
    assert report.collectives == seq


def test_shard_flow_keys_kept_for_a13c(jax_side):
    by = {ep.name: ep for ep in JE.ENTRYPOINTS}
    for name in JAX_RUNS:
        want = by[name].build()
        got = dict(TE.select_entrypoints([name])[0][0].build(device="cpu"))
        got.pop("teardown", lambda: None)()
        for key in ("data_axis", "arg_labels", "noted"):
            assert got.get(key) == want.get(key), (name, key)
        assert set(got.get("expected_replication", {})) == \
            set(want.get("expected_replication", {})), name


@pytest.mark.parametrize("name", sorted(JAX_DOCSTRING))
def test_held_to_jax_docstring(port, name):
    _, report = port[name]
    seq, n = JAX_DOCSTRING[name]
    assert report.collectives == seq
    assert report.n_compiles == n


@pytest.mark.parametrize("name", ["parallel.reshard", "train.quantized_step",
                                  "serving.prefill_family",
                                  "parallel.decode.lm_decode_tick"])
def test_jax_side_fails_on_this_jax(name):
    """The entries held to JAX's docstrings really do fail to build or
    trace on this jax: if that changes, they move to JAX_RUNS."""
    by = {ep.name: ep for ep in JE.ENTRYPOINTS}
    findings, report = jcheck(by[name])
    assert [f.rule for f in findings] == ["entrypoint-error"]
    assert "shard_map" in report.error


def test_prefill_family_counts_as_the_engine_does():
    """The serving engine's ``prefill_compiles`` counts the padded prompt
    lengths it prefilled: two lengths, two programs, as the trace engine
    counts the family."""
    from chainermn_tpu_torch.serving.cache_pool import CachePool
    from chainermn_tpu_torch.serving.engine import DecodeEngine

    params, cfg = TE._tiny_lm("cpu")
    pool = CachePool(2, cfg["total"], cfg["n_layers"],
                     cfg["n_heads"] * cfg["head_dim"], torch.float32, "cpu")
    eng = DecodeEngine(params, pool, head_dim=cfg["head_dim"])
    for slot, s in enumerate(cfg["prompts"]):
        eng.prefill_into_slot(list(range(1, s + 1)), slot)
    ep = TE.select_entrypoints(["serving.prefill_family"])[0][0]
    _, report = TT.check_entrypoint(ep, device="cpu")
    assert eng.prefill_compiles == report.n_compiles == 2


def test_tick_values_share_one_signature():
    from chainermn_tpu_torch.ops._dispatch import record_signatures

    ep = TE.select_entrypoints(["parallel.decode.lm_decode_tick"])[0][0]
    spec = ep.build(device="cpu")
    try:
        fn, arg_sets = spec["variants"]
        progs = []
        for a in arg_sets:
            with record_signatures() as sigs:
                fn(*a)
            progs.append(tuple(sigs))
        assert progs[0] == progs[1]
        assert [s[0] for s in progs[0]] == ["decode_append_attend"]
        with record_signatures():
            with pytest.raises(RuntimeError, match="do not nest"):
                with record_signatures():
                    pass
    finally:
        spec["teardown"]()


def test_recording_brackets_do_not_nest():
    from chainermn_tpu_torch.observability.comm import record_collectives

    with record_collectives():
        with pytest.raises(RuntimeError, match="do not nest"):
            with record_collectives():
                pass


def test_keep_outputs_and_calls(port):
    ep = TE.select_entrypoints(["serving.prefill_family"])[0][0]
    _, report = TT.check_entrypoint(ep, device="cpu", keep_outputs=True)
    h, caches = report.outputs
    assert h.shape == (1, 2, TE.SIZES["tiny"]["d_model"])
    assert len(caches) == 1
    assert report.calls == 3           # the trace call + two variants
    assert port["serving.prefill_family"][1].outputs is None


def test_entry_points_default_to_the_card():
    """Without ``device`` an entry runs on the card: here, with none, the
    build raises and the engine reports it (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    ep = TE.select_entrypoints(["parallel.decode.lm_decode_tick"])[0][0]
    findings, report = TT.check_entrypoint(ep)
    assert [f.rule for f in findings] == ["entrypoint-error"]
    assert "cuda" in report.error.lower()


def _load(root, dirname, which):
    path = os.path.join(REPO, "tests", "fixtures", root, dirname,
                        which + ".py")
    spec = importlib.util.spec_from_file_location(
        f"trace_fixture_{root}_{dirname}_{which}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ENTRYPOINT


#: rule -> (fixture dir, the rule JAX's engine reports on jax 0.9)
FIXTURES = {
    "unbound-axis": ("unbound_axis", "entrypoint-error"),
    "recompile-hazard": ("recompile_hazard", "recompile-hazard"),
    "entrypoint-error": ("entrypoint_error", "entrypoint-error"),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_seeded_fixture_fires_in_both(rule):
    d, jax_rule = FIXTURES[rule]
    jf, _ = jcheck(_load("spmd_lint", d, "bad"))
    assert jax_rule in {f.rule for f in jf}
    tf, _ = TT.check_entrypoint(_load("torch_trace", d, "bad"),
                                device="cpu")
    assert rule in {f.rule for f in tf}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_clean_fixture_is_silent_in_both(rule):
    d, _ = FIXTURES[rule]
    jf, jr = jcheck(_load("spmd_lint", d, "clean"))
    tf, tr = TT.check_entrypoint(_load("torch_trace", d, "clean"),
                                 device="cpu")
    assert jf == [] and tf == [] and tr.error is None
    assert tr.n_compiles == jr.n_compiles


def test_recompile_fixture_counts_programs_and_unhashable():
    findings, report = TT.check_entrypoint(
        _load("torch_trace", "recompile_hazard", "bad"), device="cpu")
    msgs = [f.message for f in findings]
    assert report.n_compiles == 3
    assert any("3 compiled programs" in m for m in msgs)
    assert any("unhashable" in m for m in msgs)


def test_unbound_name_raising_is_unbound_axis():
    """The port's axis lookup raising (a tensor-parallel layer over a name
    no bound mesh has) is the rule's other trigger."""
    from chainermn_tpu_torch.parallel.tensor_parallel import \
        reduce_from_model

    ep = TT.EntryPoint(name="t.unbound", build=lambda device, size: {
        "trace": (lambda x: reduce_from_model(x, "nope"),
                  (torch.ones(2),)), "bound_axes": {"model"}})
    findings, report = TT.check_entrypoint(ep, device="cpu")
    assert [f.rule for f in findings] == ["unbound-axis"]
    assert "unbound axis name" in findings[0].message


def test_cli_runs_one_entry_on_the_cpu(capsys):
    from chainermn_tpu_torch.analysis.cli import main

    fixture = os.path.join(REPO, "tests", "fixtures", "torch_lint",
                           "prng_key_reuse", "clean.py")
    assert main(["--device", "cpu", "--entry", "parallel.reshard",
                 "--json", fixture]) == 0
    doc = json.loads(capsys.readouterr().out)
    (rep,) = doc["entrypoints"]
    assert rep["name"] == "parallel.reshard" and rep["n_compiles"] == 1
    assert rep["collectives"] == [["all_gather", ["mn"]],
                                  ["all_to_all", ["mn"]]]
    assert main(["--device", "cpu", "--entry", "nope", fixture]) == 2


def test_shardflow_names_wait_for_a13c():
    """A13c is ported: the shard-flow names resolve (their own tests are
    ``tests/test_torch_shardflow.py``)."""
    import chainermn_tpu_torch.analysis as ta

    assert set(ta.SHARDFLOW_RULES) == {
        "unexpected-replication", "stale-replication-annotation",
        "comm-ledger-gap", "shardflow-error"}
    assert ta.NOT_PORTED == {}
    assert ta.TRACE_RULES == TT.JAXPR_RULES
    assert set(ta.TRACE_RULES) == {"unbound-axis", "recompile-hazard",
                                   "entrypoint-error"}
