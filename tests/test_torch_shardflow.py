"""The port's shard-flow analyzer (``analysis/shardflow.py`` over
``analysis/dispatch_graph.py``) against JAX's (CPU, ``size="tiny"``).

JAX's analyzer reads a jaxpr; the port's records one call of each entry
point as a dispatch graph.  On this jax (0.9) JAX's analyzer is itself
broken in three ways, so it is read here only where it still works, with
``jax.core.Var = jax.extend.core.Var`` patched into the test process
(``monkeypatch``; nothing in the JAX package changes):

* ``replication_report`` finds nothing (the ``shard_map`` equation carries
  ``in_specs``, not ``in_names``): the port's argument groups are held to
  what JAX's bindings declare, read here from the ``in_specs`` of the
  ``shard_map`` equation of each JAX build that runs;
* ``static_costs`` misses the psum jax 0.9 names ``psum_invariant`` (the
  difference ``tests/test_torch_trace_engine.py`` names): the ring's
  groups are JAX's three, 16 B each, plus the port's ``psum@mn`` 16 B;
* the decode tick, the prefill family, the router tick, the reshard and
  the quantized step fail to build (``shard_map``'s replication check).

Standing differences, each held below:

* ``train.step``'s optimizer state: torch's Adam keeps one fp32 step count
  per parameter (4 × 4 B) where optax keeps one int32 count (4 B), so the
  port's ``opt_state`` is 1,712 B where JAX's is 1,700 B; the moments are
  byte-equal;
* peak live memory: the port's figure is what a program that frees at
  last use holds (a lower bound of the allocator), JAX's the no-fusion
  upper bound of a functional program (whose outputs, the new params and
  state, stay live to the end beside the inputs); the straight-line chain
  and the fan-out are equal;
* a rank's send to itself posts no c10d op (no wire leg); its payload
  counts, as JAX's equation does.

The int8 ring, its ``composite`` declaration and the cross-rank merge of
the comm counters run at world 2 over gloo
(``tests/_torch_shardflow_worker.py``).  Tolerance: 0 bytes throughout.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_tpu.analysis import entrypoints as JE
from chainermn_tpu.analysis import shardflow as JS
from chainermn_tpu_torch.analysis import entrypoints as TE
from chainermn_tpu_torch.analysis import shardflow as S
from chainermn_tpu_torch.analysis.dispatch_graph import record
from chainermn_tpu_torch.analysis.findings import load_baseline
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "chainermn_tpu_torch" / ".shardflow-baseline.json"
JAX_BASELINE = ROOT / ".shardflow-baseline.json"
SHARDFLOW = [ep.name for ep in TE.ENTRYPOINTS if ep.shardflow]
#: the shard-flow entries whose JAX build runs on jax 0.9, by fixture
#: widths: the ring and the MLP entries' are JAX's
JAX_RUNS_SAME_WIDTHS = ["ops.collective.ring", "train.step",
                        "train.demo_step"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread here: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_run():
    """One sweep over the 11 shard-flow entries on the CPU."""
    findings, reports = S.analyze_entrypoints(device="cpu", size="tiny")
    return findings, {r.name: r for r in reports}


@pytest.fixture(scope="module")
def jax_var():
    """``jax.core.Var`` as JAX's analyzer reads it (gone on jax 0.9)."""
    import jax
    import jax.extend

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "Var", jax.extend.core.Var, raising=False)
        yield


def _jax_axes(pspec):
    axes = set()
    for d in pspec:
        if d is None:
            continue
        axes.update(d if isinstance(d, tuple) else (d,))
    return axes


@pytest.fixture(scope="module")
def jax_side(jax_var):
    """Per JAX build that runs: its static groups, its peak live bytes and
    its argument groups as its ``shard_map`` bindings declare them."""
    import jax

    by = {ep.name: ep for ep in JE.ENTRYPOINTS}
    out = {}
    for name in JAX_RUNS_SAME_WIDTHS:
        spec = by[name].build()
        fn, args = spec["trace"]
        jx = jax.make_jaxpr(fn)(*args)
        labels = JS._leaf_labels(args, spec.get("arg_labels"))
        groups, leaves = {}, {}
        for eqn, leaf_map in JS._find_shard_maps(jx):
            for pos, pspec in enumerate(eqn.params["in_specs"]):
                if leaf_map[pos] is None:
                    continue
                label = labels[leaf_map[pos]]
                nbytes = JS._var_nbytes(eqn.invars[pos])
                leaves[label] = nbytes
                root = label.split("[", 1)[0].split("/", 1)[0]
                g = groups.setdefault(root, {"replicated_bytes": 0,
                                             "total_bytes": 0,
                                             "fully_replicated": True})
                g["total_bytes"] += nbytes
                if spec["data_axis"] in _jax_axes(pspec):
                    g["fully_replicated"] = False
                else:
                    g["replicated_bytes"] += nbytes
        for g in groups.values():
            g["fully_replicated"] = (g["fully_replicated"]
                                     and g["total_bytes"] > 0)
        out[name] = {"static": JS.group_bytes(JS.static_costs(jx)),
                     "peak": JS.peak_live_bytes(jx), "groups": groups,
                     "leaves": leaves}
    return out


def _entry(name, build):
    return EntryPoint(name=name, build=build)


def _world1(body, args, **spec):
    """A synthetic entry at world 1 over axis 'mn'."""
    def build(device="cpu", size="tiny"):
        teardown = TE._one_rank_group(device)
        mesh = TE._mesh("mn")
        return dict({"trace": (TE._bound(mesh, body), args),
                     "bound_axes": {"mn"}, "teardown": teardown}, **spec)
    return build


# --------------------------------------------------------------------------
# static <-> dynamic reconciliation
# --------------------------------------------------------------------------

class TestReconciliation:
    def test_the_sweep_is_the_eleven_shard_flow_entries(self, full_run):
        _, by_name = full_run
        assert list(by_name) == SHARDFLOW and len(SHARDFLOW) == 11

    @pytest.mark.parametrize("name", SHARDFLOW)
    def test_every_entrypoint_reconciles(self, full_run, name):
        findings, by_name = full_run
        r = by_name[name]
        assert r.error is None, r.error
        assert r.reconciled is True, (r.static_groups, r.expected_static,
                                      r.ledger_noted)
        bad = [f for f in findings if f.path == f"entrypoint:{name}"
               and f.rule in ("comm-ledger-gap", "shardflow-error")]
        assert bad == [], [f.message for f in bad]

    def test_ring_groups_equal_jax_s(self, full_run, jax_side):
        _, by_name = full_run
        r = by_name["ops.collective.ring"]
        assert jax_side["ops.collective.ring"]["static"] == {
            "psum_scatter@mn": 16, "all_gather@mn": 16, "ppermute@mn": 16}
        # JAX's three, plus the psum jax 0.9 names psum_invariant
        assert r.static_groups == dict(
            jax_side["ops.collective.ring"]["static"], **{"psum@mn": 16})
        assert r.static_groups == r.expected_static == r.ledger_wrapped

    def test_demo_step_psum_equals_jax_s(self, full_run, jax_side):
        _, by_name = full_run
        r = by_name["train.demo_step"]
        assert jax_side["train.demo_step"]["static"] == {"psum@mn": 856}
        assert r.static_groups == r.ledger_wrapped == {"psum@mn": 856}

    def test_train_step_noted_row_held_to_account(self, full_run):
        _, by_name = full_run
        r = by_name["train.step"]
        # the gradient mean JAX's autodiff inserts, booked as a noted row
        # at the params' byte size; the loss mean is the wrapped 4 B
        assert r.ledger_noted == {"grad_allreduce_ad@mn": 848}
        assert r.ledger_noted["grad_allreduce_ad@mn"] == \
            r.replication["args"]["params"]["total_bytes"]
        assert r.ledger_wrapped == {"psum@mn": 4}
        assert r.static_groups == r.expected_static == {"psum@mn": 852}

    def test_serving_tick_books_nothing_at_tp1(self, full_run):
        """At TP = 1 the port's tensor-parallel layers elide the size-1
        model axis: the tick books nothing and its graph holds no
        collective, only the decode kernel's wrapper."""
        _, by_name = full_run
        r = by_name["parallel.decode.lm_decode_tick"]
        assert r.ledger_wrapped == r.static_groups == {}
        assert r.kernels == {"decode_append_attend": 1}
        assert r.launches == {}              # the plain versions on the CPU

    def test_wrong_noted_declaration_is_a_gap(self):
        def build(device="cpu", size="tiny"):
            spec = TE._build_train_step(device, size)
            spec["noted"] = {"grad_allreduce_ad@mn": 1}  # drifted
            return spec

        findings, report = S.analyze_entrypoint(
            _entry("synthetic.bad_noted", build), device="cpu")
        assert report.reconciled is False
        assert any(f.rule == "comm-ledger-gap"
                   and "declares 1" in f.message for f in findings)

    def test_raw_all_reduce_outside_the_face_is_a_gap(self):
        """A raw ``dist.all_reduce`` bypasses the accounted face: the
        ledger never sees it, and the graph holds it outside every
        accounted node."""
        import torch.distributed as dist

        def body(x):
            y = x.clone()
            dist.all_reduce(y)          # raw: the ledger never sees it
            return y

        findings, report = S.analyze_entrypoint(
            _entry("synthetic.raw_psum",
                   _world1(body, (torch.ones(4),))), device="cpu")
        assert report.reconciled is False
        gaps = [f for f in findings if f.rule == "comm-ledger-gap"]
        assert [f.snippet for f in gaps] == ["raw:c10d.allreduce_"]
        assert "psum, 16 bytes" in gaps[0].message
        assert "outside the accounted face" in gaps[0].message

    def test_wire_leg_whose_bytes_differ_is_a_gap(self):
        """An accounted psum whose wire leg carries other bytes than its
        ledger payload."""
        import torch.distributed as dist

        from chainermn_tpu_torch.observability.comm import collective

        def body(x):
            def run():
                y = torch.cat([x, x])   # twice the payload on the wire
                dist.all_reduce(y)
                return y[:4]
            return collective("psum", "mn", x, run)

        findings, report = S.analyze_entrypoint(
            _entry("synthetic.fat_leg", _world1(body, (torch.ones(4),))),
            device="cpu")
        assert report.reconciled is False
        gaps = [f for f in findings if f.rule == "comm-ledger-gap"]
        assert [f.snippet for f in gaps] == ["leg:psum@mn"]
        assert "c10d.allreduce_ 32 B" in gaps[0].message
        assert "16 payload bytes" in gaps[0].message

    def test_broken_build_is_reported_not_raised(self):
        def build(device="cpu", size="tiny"):
            raise RuntimeError("subsystem drifted")

        findings, report = S.analyze_entrypoint(
            _entry("synthetic.broken", build), device="cpu")
        assert report.error and "subsystem drifted" in report.error
        assert [f.rule for f in findings] == ["shardflow-error"]


# --------------------------------------------------------------------------
# replication report
# --------------------------------------------------------------------------

def _group_keys(g):
    return {k: g[k] for k in ("replicated_bytes", "total_bytes",
                              "fully_replicated")}


class TestReplication:
    @pytest.mark.parametrize("name", JAX_RUNS_SAME_WIDTHS)
    def test_arg_groups_equal_jax_bindings(self, full_run, jax_side, name):
        _, by_name = full_run
        got = {root: _group_keys(g) for root, g
               in by_name[name].replication["args"].items()}
        want = jax_side[name]["groups"]
        assert set(got) == set(want)
        if name == "train.step":
            # the standing difference: torch's four fp32 step counts
            # where optax keeps one int32 count; the moments equal JAX's
            assert want["opt_state"]["total_bytes"] == 1700
            assert got.pop("opt_state") == {
                "replicated_bytes": 1712, "total_bytes": 1712,
                "fully_replicated": True}
            want = {k: v for k, v in want.items() if k != "opt_state"}
            leaves = by_name[name].replication["args"]["opt_state"]["leaves"]
            moments = sum(e["nbytes"] for e in leaves
                          if "exp_avg" in e["label"])
            steps = [e["nbytes"] for e in leaves if "step" in e["label"]]
            jleaves = jax_side[name]["leaves"]
            assert moments == sum(b for lab, b in jleaves.items()
                                  if ".mu" in lab or ".nu" in lab)
            assert steps == [4] * 4
            assert [b for lab, b in jleaves.items()
                    if lab.endswith(".count")] == [4]
        assert got == want

    def test_train_step_names_optimizer_state_blowup(self, full_run):
        _, by_name = full_run
        args = by_name["train.step"].replication["args"]
        opt = args["opt_state"]
        assert opt["fully_replicated"] is True
        assert opt["replicated_bytes"] == opt["total_bytes"] > 0
        assert "ZeRO-1" in opt["expected"]
        assert "params" in args and args["params"]["fully_replicated"]
        # the data is actually data-parallel: batch shards over the axis
        assert args["batch"]["replicated_bytes"] == 0

    def test_quantized_step_shards_its_ef_rows(self, full_run):
        """What JAX's quantized entry states: the EF residual rows shard
        over the data axis (0 replicated bytes, no annotation), the inner
        momentum and the stale gradients are annotated, the params are
        the keeper."""
        findings, by_name = full_run
        args = by_name["train.quantized_step"].replication["args"]
        assert args["opt_state.ef"]["replicated_bytes"] == 0
        assert args["opt_state.ef"]["total_bytes"] == 848
        for root in ("opt_state.inner", "opt_state.stale_grads"):
            assert args[root]["fully_replicated"] and "expected" in args[root]
        assert args["params"]["replicated_bytes"] == 848
        assert [f.context for f in findings
                if f.path == "entrypoint:train.quantized_step"] == ["params"]

    def test_tick_tokens_are_int32_as_jax_s(self, full_run):
        _, by_name = full_run
        for name in ("parallel.decode.lm_decode_tick",
                     "serving.router_tick"):
            args = by_name[name].replication["args"]
            assert args["tokens"]["total_bytes"] == 4        # one int32
            assert args["pos"]["total_bytes"] == 4

    def test_unexpected_replication_fires_without_annotation(self):
        findings, _ = S.analyze_entrypoint(
            _synthetic_replicated_entry(expected=None), device="cpu")
        hits = [f for f in findings if f.rule == "unexpected-replication"]
        assert len(hits) == 1 and hits[0].context == "w"

    def test_python_loop_ring_keeps_carry_varying(self):
        """A rank-varying carry through an eager loop (the port's
        while_loop: it unrolls) stays varying at every pass, through the
        shifts and the adds; the psum's result is the one replicated
        value.  The same loop over a replicated input reports its adds."""
        from chainermn_tpu_torch.ops import collective as C
        from chainermn_tpu_torch.parallel._factory import P

        def loop(x):
            c = x
            for _ in range(3):
                c = c + 1.0
            return C.psum(C.shift(c, 1, "mn", size=1), "mn")

        def prims(spec):
            def build(device="cpu", size="tiny"):
                return _world1(loop, (torch.zeros(4),), data_axis="mn",
                               arg_labels=("x",), in_specs=(spec,))(device)

            _, r = S.analyze_entrypoint(_entry("synthetic.loop", build),
                                        device="cpu")
            assert r.reconciled is True
            return [it["primitive"] for it in r.replication["intermediates"]]

        assert prims(P("mn")) == ["psum"]
        assert sorted(prims(P())) == ["add", "add", "add", "psum"]

    def test_annotation_silences_and_stale_annotation_fires(self):
        findings, report = S.analyze_entrypoint(
            _synthetic_replicated_entry(expected={"w": "by design"}),
            device="cpu")
        assert [f for f in findings
                if f.rule == "unexpected-replication"] == []
        assert report.replication["args"]["w"]["expected"] == "by design"
        findings, _ = S.analyze_entrypoint(
            _synthetic_replicated_entry(expected={"x": "sharded already"}),
            device="cpu")
        assert any(f.rule == "stale-replication-annotation"
                   and f.context == "x" for f in findings)


def _synthetic_replicated_entry(expected):
    """JAX's fixture: ``psum(x @ w)`` with x sharded over 'mn' and w fed
    replicated."""
    from chainermn_tpu_torch.ops import collective as C
    from chainermn_tpu_torch.parallel._factory import P

    def body(x, w):
        return C.psum(x @ w, "mn")

    spec = dict(data_axis="mn", arg_labels=("x", "w"),
                in_specs=(P("mn"), P()))
    if expected is not None:
        spec["expected_replication"] = expected
    return _entry("synthetic.replicated", _world1(
        body, (torch.ones(2, 3), torch.ones(3, 4)), **spec))


# --------------------------------------------------------------------------
# cost model + liveness units
# --------------------------------------------------------------------------

class TestCostModel:
    @pytest.mark.parametrize("prim,payload,p", [
        ("psum", 1024, 1), ("psum", 1024, 4), ("psum_scatter", 1024, 4),
        ("all_gather", 256, 4), ("ppermute", 1024, 4), ("all_to_all", 64, 2)])
    def test_ring_formulas_equal_jax_s(self, prim, payload, p):
        from chainermn_tpu.ops.collective import collective_wire_cost as jc
        from chainermn_tpu_torch.ops.collective import \
            collective_wire_cost as tc

        assert tc(prim, payload, p) == jc(prim, payload, p)

    def test_eager_loop_unrolls_with_trip_count_one(self):
        """JAX books a psum inside ``lax.scan`` once with trip count 5;
        an eager loop runs five accounted psums, each its own node."""
        from chainermn_tpu_torch.ops import collective as C

        def body(x):
            for _ in range(5):
                x = C.psum(x, "mn")
            return x

        _, r = S.analyze_entrypoint(
            _entry("synthetic.loop5", _world1(body, (torch.ones(4),))),
            device="cpu")
        assert [c.trip_count for c in r.costs] == [1] * 5
        assert S.group_bytes(r.costs) == {"psum@mn": 80}
        assert S.group_bytes(r.costs, trip_adjusted=True) == {"psum@mn": 80}
        assert r.reconciled is True


def _peak(fn, x):
    graph, _, _ = record(fn, (x,))
    return S.peak_live_bytes(graph)


class TestPeakLive:
    def test_straight_line_chain_equals_jax_s(self, jax_var):
        import jax

        def f(x):
            y = x * 2.0
            return y * 3.0

        x = np.ones((4,), np.float32)
        assert JS.peak_live_bytes(jax.make_jaxpr(f)(x)) == 32
        assert _peak(f, torch.as_tensor(x)) == 32

    def test_fanout_holds_both_operands_as_jax_s(self, jax_var):
        import jax

        def f(x):
            y = x * 2.0
            z = x * 3.0          # x still live here
            return y + z

        x = np.ones((100,), np.float32)
        assert JS.peak_live_bytes(jax.make_jaxpr(f)(x)) == 1200
        assert _peak(f, torch.as_tensor(x)) == 1200

    def test_view_defines_nothing(self):
        def f(x):
            return x.view(2, 2).t() * 2.0

        assert _peak(f, torch.ones(4)) == 32      # x and the product

    def test_inplace_op_defines_nothing(self):
        def f(x):
            y = x * 2.0
            y.add_(1.0)
            return y * 3.0

        graph, _, _ = record(f, (torch.ones(4),))
        assert [len(n.defs) for n in graph.nodes] == [1, 0, 1]
        assert graph.nodes[1].outputs == graph.nodes[0].defs
        assert S.peak_live_bytes(graph) == 32

    def test_created_peak_leaves_out_the_inputs(self):
        """``peak_defined_bytes`` counts only the storages the call
        creates: here the input stays live to the end, so the peak holds
        three vectors and the created peak two."""
        def f(x):
            y = x * 2.0
            z = y * 3.0
            return z + x

        graph, _, _ = record(f, (torch.ones(4),))
        assert S.peak_live_bytes(graph) == 48
        assert S.peak_defined_bytes(graph) == 32
        assert S.peak_defined_bytes(graph, "cuda") == 0

    def test_entrypoint_reports_carry_peak(self, full_run):
        _, by_name = full_run
        for name, r in by_name.items():
            assert r.peak_live_bytes and r.peak_live_bytes > 0, name
        # the train step holds at least params + opt state + batch
        r = by_name["train.step"]
        assert r.peak_live_bytes >= sum(
            g["total_bytes"] for g in r.replication["args"].values())

    def test_ring_peak_equals_jax_s(self, full_run, jax_side):
        _, by_name = full_run
        assert by_name["ops.collective.ring"].peak_live_bytes == \
            jax_side["ops.collective.ring"]["peak"] == 32


# --------------------------------------------------------------------------
# world 2 over gloo: the int8 ring's composite, the cross-rank merge
# --------------------------------------------------------------------------

sys.path.insert(0, str(ROOT / "tests"))
import _torch_shardflow_worker as W  # noqa: E402


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shardflow_w2")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_shardflow_worker.py"),
         str(r), "2", str(tmp / "store"), str(tmp)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out, tmp


class TestWorld2:
    @pytest.mark.parametrize("rank", [0, 1])
    @pytest.mark.parametrize("case", W.RING_CASES)
    def test_quantized_ring_legs_equal_static_groups(self, world2, case,
                                                     rank):
        """JAX's ``composite`` declaration: the ledger row at the
        compressed-wire convention, swapped for the ring's per-primitive
        groups, which its raw legs equal byte for byte; the int8 wire is
        the cost model's wire + scale bytes, the fp32 wire empty, the
        message count the cost model's."""
        from chainermn_tpu.ops.collective import (
            quantized_ring_static_groups as jax_groups)
        from chainermn_tpu_torch.ops.collective import (
            quantized_ring_cost, quantized_ring_static_groups)

        n, block, k = case
        res = world2[0][rank]["rings"][case]
        rep = res["report"]
        assert rep["reconciled"] is True, res["findings"]
        want = quantized_ring_static_groups(n, 2, "mn", "int8", block, k)
        assert want == jax_groups(n, 2, "mn", "int8", block, k)
        assert rep["static_groups"] == rep["expected_static"] == want
        assert rep["ledger_wrapped"] == {
            "quantized_ring_pmean@mn": quantized_ring_cost(
                n, 2, "int8", block, k)["ledger_bytes"]}
        cost = quantized_ring_cost(n, 2, "int8", block, k)
        costs = rep["costs"]
        assert sum(c["wire_bytes"] for c in costs if c["dtype"] == "int8") \
            == cost["wire_bytes"] + cost["scale_bytes"]
        assert sum(c["wire_bytes"] for c in costs
                   if c["dtype"] == "float32") == 0
        assert sum(c["messages"] for c in costs) == cost["messages"]
        assert [f[0] for f in res["findings"]] == ["unexpected-replication"]

    @pytest.mark.parametrize("rank", [0, 1])
    def test_quantized_train_step_reconciles_with_jax_s_declaration(
            self, world2, rank):
        from chainermn_tpu_torch.ops.collective import \
            quantized_ring_static_groups

        res = world2[0][rank]["quantized_step"]
        rep = res["report"]
        assert rep["reconciled"] is True, res["findings"]
        groups = quantized_ring_static_groups(212, 2, "mn", "int8", 8, 2)
        assert rep["static_groups"] == dict(groups, **{"psum@mn": 4})
        assert rep["ledger_wrapped"] == {"quantized_ring_pmean@mn": 212,
                                         "psum@mn": 4}
        args = rep["replication"]["args"]
        assert args["opt_state.ef"]["replicated_bytes"] == 0
        assert [f[1] for f in res["findings"]] == ["replicated:params"]

    def test_cross_rank_merge_sums_to_statics(self, world2):
        """Each rank's comm counters survive the merge on its own lane,
        and equal that rank's static groups; the ranks sum to twice one
        rank's statics."""
        from chainermn_tpu_torch.observability import aggregate

        out, tmp = world2
        merged = aggregate.merge_trace_shards(
            str(tmp / "trace.json"), out_path=str(tmp / "merged.json"))
        assert merged["metadata"]["merged_ranks"] == [0, 1]
        per_pid = {}
        for ev in merged["traceEvents"]:
            name = str(ev.get("name", ""))
            if ev.get("ph") == "C" and name.startswith("comm/") \
                    and name.endswith("/bytes"):
                per_pid[(ev["pid"], name)] = list(ev["args"].values())[0]
        statics = []
        for rank in (0, 1):
            res = out[rank]["ring"]
            assert res["report"]["reconciled"] is True, res["findings"]
            static = sum(res["report"]["static_groups"].values())
            statics.append(static)
            merged_rank = sum(v for (pid, _), v in per_pid.items()
                              if pid == rank)
            assert merged_rank == res["ledger_bytes"] == static > 0
        assert statics[0] == statics[1]
        assert sum(v for v in per_pid.values()) == 2 * statics[0]


# --------------------------------------------------------------------------
# self-run: the registration clean modulo the port's baseline
# --------------------------------------------------------------------------

class TestSelfRun:
    def test_clean_modulo_baseline_with_keepers(self, full_run):
        findings, _ = full_run
        baseline = load_baseline(str(BASELINE))
        new, accepted = baseline.filter(findings)
        assert new == [], "new shardflow findings:\n" + "\n".join(
            f.render() for f in new)
        assert len(accepted) == 5

    def test_fingerprints_are_jax_s(self, full_run):
        findings, _ = full_run
        ours = load_baseline(str(BASELINE))
        jax_s = json.loads(JAX_BASELINE.read_text())
        want = {e["fingerprint"] for e in jax_s["findings"]}
        assert set(ours.entries) == want
        assert {f.fingerprint() for f in findings} == want

    def test_no_stale_baseline_entries(self, full_run):
        findings, _ = full_run
        baseline = load_baseline(str(BASELINE))
        _, accepted = baseline.filter(findings)
        stale = set(baseline.entries) - {f.fingerprint() for f in accepted}
        assert not stale

    def test_every_baseline_entry_has_comment(self):
        baseline = load_baseline(str(BASELINE))
        assert not [e["path"] for e in baseline.entries.values()
                    if not e.get("comment")]

    def test_deleting_baseline_entry_fails_the_gate(self, full_run):
        findings, _ = full_run
        baseline = load_baseline(str(BASELINE))
        doomed = next(fp for fp, e in baseline.entries.items()
                      if e["context"] == "x")
        del baseline.entries[doomed]
        new, _ = baseline.filter(findings)
        assert len(new) == 1 and new[0].fingerprint() == doomed

    def test_default_baseline_is_the_port_s(self):
        assert S.find_shardflow_baseline() == str(BASELINE)


class TestRunnerCLI:
    def test_unknown_entry_is_unusable(self, capsys):
        assert S.main(["--device", "cpu", "--entry", "no.such.entry"]) == 2
        assert "unknown entry point" in capsys.readouterr().err

    def test_explicitly_naming_a_skipped_entry_is_unusable(self, capsys):
        assert S.main(["--device", "cpu", "--entry",
                       "serving.tick_with_tracing"]) == 2
        assert "shardflow=False" in capsys.readouterr().err

    def test_list_entrypoints(self, capsys):
        assert S.main(["--list-entrypoints"]) == 0
        out = capsys.readouterr().out
        assert "train.step" in out and "ops.collective.ring" in out
        assert out.count("[shardflow: skipped]") == 6

    def test_exit_contract_and_json(self, capsys):
        assert S.main(["--device", "cpu", "--entry", "train.demo_step",
                       "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["schema"] == "chainermn_tpu.shardflow.v1"
        assert doc["reports"][0]["reconciled"] is True
        assert S.main(["--device", "cpu", "--entry", "ops.collective.ring",
                       "--no-baseline", "--json"]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert {f["rule"] for f in doc["findings"]} == \
            {"unexpected-replication"}

    def test_partial_fix_baseline_carries_unselected_entries(self, tmp_path):
        bl = tmp_path / "bl.json"
        shutil.copy(BASELINE, bl)
        assert S.main(["--device", "cpu", "--entry", "ops.collective.ring",
                       "--fix-baseline", "--baseline", str(bl)]) == 0
        before = load_baseline(str(BASELINE))
        after = load_baseline(str(bl))
        assert set(after.entries) == set(before.entries)
        for fp, e in after.entries.items():
            assert e["comment"] == before.entries[fp]["comment"]

    def test_the_card_asked_for_without_one_is_unusable(self, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        assert S.main(["--entry", "ops.collective.ring"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_gate_runs_the_shardflow_stage(capsys):
    from chainermn_tpu.analysis.cli import GATE_STAGES as JAX_STAGES
    from chainermn_tpu_torch.analysis.cli import GATE_STAGES, gate_main

    assert GATE_STAGES == JAX_STAGES == (
        "lint", "protocol", "shardflow", "schedules", "calibration")
    assert gate_main(["--stages", "shardflow", "--device", "cpu",
                      "--json"]) == 0
    cap = capsys.readouterr()
    assert json.loads(cap.out)["stages"] == {"shardflow": 0}
    assert "shardflow: no findings (5 accepted by baseline) over 11" \
        in cap.err


def test_analysis_names_resolve():
    import chainermn_tpu.analysis as ja
    import chainermn_tpu_torch.analysis as ta

    assert ta.SHARDFLOW_RULES == ja.SHARDFLOW_RULES == S.SHARDFLOW_RULES
    assert ta.ShardflowReport is S.ShardflowReport
    assert [f.name for f in S.ShardflowReport.__dataclass_fields__.values()
            ][:len(JS.ShardflowReport.__dataclass_fields__)] == \
        list(JS.ShardflowReport.__dataclass_fields__)
    for name in ("CollectiveCost", "static_costs", "group_bytes",
                 "peak_live_bytes", "replication_report",
                 "analyze_entrypoint", "analyze_entrypoints",
                 "find_shardflow_baseline", "main"):
        assert hasattr(S, name) and hasattr(JS, name), name
    assert ta.NOT_PORTED == {} and TE.NOT_PORTED == {}
