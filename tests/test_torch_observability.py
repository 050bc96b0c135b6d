"""The port's comm ledger and demo CLI observability against the JAX package's.

On the same inputs (numpy seeds), with tracing on, every ledger row the
port books (``op@axis``: calls, bytes, dtypes, noted_bytes; host time
is not compared) equals JAX's:

* each collective of ``ops.collective`` (JAX traces them inside
  ``shard_map``), the int8 ring at its wire dtype, the two-tier mean,
  and each eager collective of the communicators (the naive oracle and
  the process-group communicator, whose per-rank block counts ``size``
  times, as JAX books its rank-major stack); an override delegating to
  ``super()`` books once;
* the step report of ``make_demo_step``, ``make_train_step`` (with and
  without aux) and ``make_flax_train_step`` over a BatchNorm model (its
  second step: JAX's cache-hit replay), ``grad_allreduce_ad`` included;
* at world 1 in this process and at world 2 (two gloo processes,
  ``tests/_torch_obs_worker.py``, against JAX on two virtual devices).

A collective inside a JAX ``lax.scan`` runs once a tick and is booked
once a tick here: the ring attention's hops (one stacked (k, v) hop a
step, P - 1 of them, where JAX's scan body holds the k and v ppermutes
and runs P steps) and the 1F1B pipeline's ticks (two ppermutes a tick,
the scan's body times its length).  JAX calls ``jax.lax`` there and its
ledger books none of them.  Disabled tracing books nothing, clears the
step report and never computes a payload.  ``python -m
chainermn_tpu_torch.train --metrics-out --trace-out`` gives JAX's CLI's
result keys and metrics records at world 1 and 2 (at world 2 rank 0 adds
the merge's keys and the records their ``rank``, as JAX's
multi-controller run does).  Every name of JAX's
``observability.__all__`` resolves from the port's.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import chainermn_tpu as mn
from chainermn_tpu import observability as jobs
from chainermn_tpu._compat import shard_map
from chainermn_tpu.communicators.naive import \
    NaiveCommunicator as JaxNaive
from chainermn_tpu.communicators.xla import XlaCommunicator
from chainermn_tpu.ops import collective as jcol
from chainermn_tpu.parallel.pipeline import \
    pipeline_1f1b_grads as jax_1f1b
from chainermn_tpu.parallel.ring_attention import \
    ring_attention as jax_ring
from chainermn_tpu.train import make_demo_step as jax_demo_step
from chainermn_tpu_torch import observability as obs
from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                               create_communicator)
from chainermn_tpu_torch.observability import comm as tcomm
from chainermn_tpu_torch.ops import collective as col

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_obs_worker as W  # noqa: E402

AX = "mn"

#: JAX's side of each of W.OP_CASES
JAX_OPS = {
    "psum": lambda x: jcol.psum(x, AX),
    "psum_tree": lambda x: jcol.psum({"a": x, "b": x[:2].astype(jnp.int32)},
                                     AX),
    "pmean": lambda x: jcol.pmean(x, AX),
    "pmax": lambda x: jcol.pmax(x, AX),
    "pmin": lambda x: jcol.pmin(x, AX),
    "pmean_if_bound": lambda x: jcol.pmean_if_bound(x, AX),
    "all_gather": lambda x: jcol.all_gather(x, AX),
    "reduce_scatter": lambda x: jcol.reduce_scatter(x, AX),
    "all_to_all": lambda x: jcol.all_to_all(x, AX),
    "ppermute": lambda x: jcol.ppermute(
        x, [(i, (i + 1) % jcol.axis_size(AX))
            for i in range(jcol.axis_size(AX))], AX),
    "shift": lambda x: jcol.shift(x, 1, AX),
    "bcast": lambda x: jcol.bcast(x, 0, AX),
    "quantized_ring_pmean": lambda x: jcol.quantized_ring_pmean(x, AX),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ledgers_left_clean():
    """Every test leaves both packages' process-global comm ledgers empty:
    a later test in this process (another file on the same worker) reads
    them as it finds them."""
    yield
    obs.get_accountant().reset()
    jobs.get_accountant().reset()


@pytest.fixture(scope="module")
def comm1():
    """A one-rank gloo group in this process, torn down after the module."""
    comm = create_communicator("xla", device="cpu")
    yield comm
    dist.destroy_process_group()


def _jfresh():
    jobs.reset_all()
    jobs.enable()


def _jmesh(world):
    return mn.make_mesh(jax.devices()[:world])


def _global(shape, dtype, world):
    """The rank-major stack of every rank's ``W.block`` along axis 0."""
    x = np.concatenate([W.block(shape, "float32", r).numpy()
                        for r in range(world)])
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def jax_ops(world):
    mesh, out = _jmesh(world), {}
    for name, (_, shape, dtype) in W.OP_CASES.items():
        _jfresh()
        fn = jax.jit(shard_map(JAX_OPS[name], mesh=mesh, in_specs=P(AX),
                               out_specs=P(AX), check_vma=False))
        fn(_global(shape, dtype, world))
        out[name] = W.rows(jobs.comm_report())
    jobs.disable()
    return out


def jax_comm(world):
    comm = XlaCommunicator(devices=jax.devices()[:world])
    xs = np.stack([W.block((4,), "float32", r).numpy()
                   for r in range(world)])
    size = comm.size
    cases = {
        "allreduce": lambda: comm.allreduce(xs),
        "bcast": lambda: comm.bcast(xs),
        "gather": lambda: comm.gather(xs),
        "allgather": lambda: comm.allgather(xs),
        "alltoall": lambda: comm.alltoall(np.stack([xs] * size, 1)),
        "scatter": lambda: comm.scatter(xs),
        "send": lambda: comm.send(xs, dest=size - 1, source=0),
        "recv": lambda: comm.recv(xs, source=0, dest=size - 1),
        "broadcast_data": lambda: comm.broadcast_data(
            {"weight": np.zeros((2, 4), np.float32),
             "bias": np.zeros((2,), np.float32)}),
        "multi_node_mean_grad": lambda: comm.multi_node_mean_grad(
            [xs, xs[:, :2]]),
    }
    out = {}
    for name, fn in cases.items():
        _jfresh()
        fn()
        out[name] = W.rows(jobs.comm_report())
    jobs.disable()
    return out


class _JaxBN(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(
            nn.Dense(8)(x))
        return nn.Dense(3)(nn.relu(x))


def jax_steps(world):
    """The second step's report of each JAX step builder (its cache hit)."""
    mesh = _jmesh(world)
    x, y, labels = W.step_batch()
    acct, out = jobs.get_accountant(), {}

    def two_steps(name, step, state, batch):
        _jfresh()
        for _ in range(2):
            with acct.step(name):
                res = step(*state, batch)
                state = res[:len(state)]
        out[name] = W.rows(acct.last_step_report)

    opt = optax.sgd(0.1)
    params = {"w1": np.zeros((W.D_IN, 8), np.float32),
              "b1": np.zeros(8, np.float32),
              "w2": np.zeros((8, 10), np.float32),
              "b2": np.zeros(10, np.float32)}
    demo = jax_demo_step(opt, mesh=mesh)
    _jfresh()
    st = mn.replicate((params, opt.init(params)), mesh)
    b = mn.shard_batch((x, labels), mesh)
    for _ in range(2):
        with acct.step("demo"):
            st, _ = demo(st, b)
    out["demo"] = W.rows(acct.last_step_report)

    lin = {"w": np.zeros((W.D_IN, W.D_OUT), np.float32),
           "b": np.zeros(W.D_OUT, np.float32)}

    def mse(p, bb):
        return jnp.mean((bb[0] @ p["w"] + p["b"] - bb[1]) ** 2)

    def mse_aux(p, bb):
        err = bb[0] @ p["w"] + p["b"] - bb[1]
        return jnp.mean(err ** 2), {"mae": jnp.mean(jnp.abs(err))}

    batch = mn.shard_batch((x, y), mesh)
    for name, fn, aux in (("train", mse, False), ("train_aux", mse_aux,
                                                  True)):
        step = mn.make_train_step(fn, opt, mesh=mesh, donate=False,
                                  has_aux=aux)
        two_steps(name, step, (mn.replicate(lin, mesh),
                               mn.replicate(opt.init(lin), mesh)), batch)

    model = _JaxBN()
    variables = model.init(jax.random.PRNGKey(0), x[:2])
    fstep = mn.make_flax_train_step(
        model, lambda o, bb: (jnp.mean((o - bb[1][:, :3]) ** 2),
                              {"acc": o.mean()}), opt, mesh=mesh,
        donate=False)
    two_steps("flax", fstep, (mn.replicate(variables, mesh),
                              mn.replicate(opt.init(variables["params"]),
                                           mesh)), batch)
    jobs.disable()
    return out


def _scan_ppermutes(jaxpr):
    """``(scan length, ppermute equations in its body, their operand
    bytes)`` of the one ``scan`` in a traced program."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            body = eqn.params["jaxpr"].jaxpr
            perms = [e for e in body.eqns if e.primitive.name == "ppermute"]
            nbytes = sum(int(np.prod(v.aval.shape)) * v.aval.dtype.itemsize
                         for e in perms for v in e.invars)
            return eqn.params["length"], len(perms), nbytes
        for v in eqn.params.values():          # shard_map's body
            inner = v if hasattr(v, "eqns") else getattr(v, "jaxpr", None)
            if inner is not None and hasattr(inner, "eqns"):
                got = _scan_ppermutes(inner)
                if got:
                    return got
    return None


def jax_loops(world):
    mesh = _jmesh(world)
    g = torch.Generator().manual_seed(0)
    q, k, v = (jnp.asarray(np.concatenate(
        [torch.randn(1, 8, 2, 4, generator=g).numpy()] * world, 1))
        for _ in range(3))
    ring = shard_map(lambda a, b, c: jax_ring(a, b, c, AX, attn_impl="xla"),
                     mesh=mesh, in_specs=(P(None, AX),) * 3,
                     out_specs=P(None, AX), check_vma=False)
    w = {"w": jnp.zeros((world, 4, 4))}
    xt = jnp.zeros((8, 4))
    pipe = shard_map(
        lambda ww, a, t: jax_1f1b(lambda p, h: jnp.tanh(h @ p["w"]),
                                  lambda yy, tt: jnp.mean((yy - tt) ** 2),
                                  ww, a, t, axis_name=AX,
                                  num_microbatches=4),
        mesh=mesh, in_specs=(P(AX), P(), P()), out_specs=(P(), P(AX)),
        check_vma=False)
    _jfresh()
    out = {"ring": _scan_ppermutes(jax.make_jaxpr(ring)(q, k, v).jaxpr),
           "pipeline": _scan_ppermutes(
               jax.make_jaxpr(pipe)(w, xt, xt).jaxpr),
           "ledger": W.rows(jobs.comm_report())}
    jobs.disable()
    return out


class _Gathered:
    def __init__(self, objs):
        self.objs, self.rank = objs, None

    def allgather_obj(self, obj):
        return list(self.objs)


def _jax_cli(world, out_dir):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")
    d = Path(out_dir)
    return subprocess.Popen(
        [sys.executable, "-m", "chainermn_tpu.train", "--devices",
         str(world), "--steps", "4", "--log-every", "2", "--out",
         str(d / "out"), "--metrics-out", str(d / "m.jsonl"),
         "--trace-out", str(d / "t.json")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _jax_cli_result(proc, out_dir):
    log = proc.communicate(timeout=240)[0]
    assert proc.returncode == 0, log[-3000:]
    return {"result": json.loads(log.strip().splitlines()[-1]),
            "records": obs.read_metrics_jsonl(str(Path(out_dir) / "m.jsonl"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, comm1):
    """The port at world 1 (here) and 2 (two processes), and JAX's CLI at
    both sizes (subprocesses, started together)."""
    tmp = tmp_path_factory.mktemp("obs")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    (tmp / "w2").mkdir()
    workers = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_obs_worker.py"),
         str(r), "2", str(tmp / "store"), str(tmp / "w2")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    clis = {w: _jax_cli(w, tmp / f"jax{w}") for w in (1, 2)}
    try:
        port1 = W.collect(comm1, str(tmp / "w1"))
        jax = {w: {"ops": jax_ops(w), "comm": jax_comm(w),
                   "steps": jax_steps(w), "loops": jax_loops(w)}
               for w in (1, 2)}
        for w in (1, 2):
            jax[w]["cli"] = _jax_cli_result(clis[w], tmp / f"jax{w}")
        logs = [p.communicate(timeout=240)[0] for p in workers]
    finally:
        for p in workers + list(clis.values()):
            p.kill()
    assert [p.returncode for p in workers] == [0, 0], \
        "\n".join(logs)[-4000:]
    port2 = []
    for r in range(2):
        with open(tmp / "w2" / f"rank{r}.pkl", "rb") as fh:
            port2.append(pickle.load(fh))
    return {"port": {1: [port1], 2: port2}, "jax": jax}


SIZES = [(1, 0), (2, 0), (2, 1)]       # (world, rank)


@pytest.mark.parametrize("world,rank", SIZES)
@pytest.mark.parametrize("name", list(W.OP_CASES))
def test_ops_collective_books_as_jax(runs, name, world, rank):
    got = runs["port"][world][rank]["ops"][name]
    assert got == runs["jax"][world]["ops"][name], name
    # a lone rank's int8 ring is its input, booked by neither package
    assert bool(got) != (name == "quantized_ring_pmean" and world == 1)
    if name == "quantized_ring_pmean" and world > 1:
        # the wire dtype: one byte an element, not x's fp32
        assert got == {f"{name}@{AX}": {"calls": 1, "bytes": 16,
                                        "dtypes": ["int8"]}}


@pytest.mark.parametrize("world,rank", SIZES)
@pytest.mark.parametrize("name", ["allreduce", "bcast", "gather",
                                  "allgather", "alltoall", "scatter",
                                  "send", "recv", "broadcast_data",
                                  "multi_node_mean_grad"])
def test_process_group_communicator_books_as_jax(runs, name, world, rank):
    got = runs["port"][world][rank]["comm"][name]
    assert got == runs["jax"][world]["comm"][name]
    assert list(got) == [f"{name}@{AX}"]


@pytest.mark.parametrize("world,rank", SIZES)
@pytest.mark.parametrize("name", ["demo", "train", "train_aux", "flax"])
def test_step_report_equals_jax_cache_hit(runs, name, world, rank):
    got = runs["port"][world][rank]["steps"][name]
    assert got == runs["jax"][world]["steps"][name]
    if name != "demo":
        # the default path's gradient mean, at the gradient tree's size
        row = got[f"grad_allreduce_ad@{AX}"]
        assert row["calls"] == 1 and row["noted_bytes"] == row["bytes"]


@pytest.mark.parametrize("rank", [0, 1])
def test_scan_collectives_booked_once_a_tick(runs, rank):
    jx = runs["jax"][2]["loops"]
    got = runs["port"][2][rank]["loops"]
    assert jx["ledger"] == {}          # JAX's loops call jax.lax directly
    length, perms, nbytes = jx["ring"]
    assert (length, perms) == (2, 2)   # P steps, the k and v ppermutes
    # one stacked (k, v) hop a step but the last: P - 1 hops
    assert got["ring"] == {f"ppermute@sp": {
        "calls": length - 1, "bytes": (length - 1) * nbytes,
        "dtypes": ["float32"]}}
    length, perms, nbytes = jx["pipeline"]
    assert (length, perms) == (4 + 2 * (2 - 1), 2)
    row = got["pipeline"]["ppermute@pp"]
    assert row["calls"] == perms * length
    assert row["bytes"] == nbytes * length
    assert got["pipeline"]["psum@pp"]["calls"] == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_cross_rank_report_equals_jax(runs, rank):
    want = jobs.cross_rank_report(
        _Gathered([W.skew_local(r) for r in range(2)]), W.skew_local(0))
    assert runs["port"][2][rank]["skew"] == want
    assert want["straggler_rank"] == 1


def _keys_by_kind(records, drop=()):
    out = {}
    for r in records:
        out.setdefault(r["kind"], set()).update(set(r) - set(drop))
    return out


@pytest.mark.parametrize("world,rank", SIZES)
def test_demo_cli_metrics_and_result_keys_equal_jax(runs, world, rank):
    port = runs["port"][world][rank]["cli"]
    jx = runs["jax"][world]["cli"]
    merge = {"merged_trace", "merged_ranks"} if (world, rank) == (2, 0) \
        else set()
    assert set(port["result"]) == set(jx["result"]) | merge
    for key in ("goodput", "comm_totals", "straggler_rank",
                "step_time_skew"):
        assert key in port["result"]
    if merge:
        assert port["result"]["merged_ranks"] == [0, 1]
    want = _keys_by_kind(jx["records"])
    if world > 1 and rank:
        want.pop("skew_report")        # rank 0 writes the fleet's
    assert _keys_by_kind(port["records"], drop={"rank"}) == want
    steps = [r for r in port["records"] if r["kind"] == "step"]
    jsteps = [r for r in jx["records"] if r["kind"] == "step"]
    assert [(r["comm/bytes"], r["comm/calls"]) for r in steps] \
        == [(r["comm/bytes"], r["comm/calls"]) for r in jsteps]
    assert port["result"]["comm_totals"] == jx["result"]["comm_totals"]


# ---- in this process: the naive oracle, delegation, disabled tracing ----

@pytest.fixture
def tracing():
    obs.reset_all()
    obs.enable()
    yield obs.get_tracer()
    obs.disable()
    obs.reset_all()


@pytest.mark.parametrize("op", ["allreduce", "bcast", "gather", "allgather",
                                "alltoall", "scatter", "send", "recv",
                                "broadcast_data", "multi_node_mean_grad"])
def test_naive_communicator_books_as_jax(op):
    xs = np.stack([W.block((3,), "float32", r).numpy() for r in range(4)])
    args = {"alltoall": (np.stack([xs] * 4, 1),),
            "send": (xs, 3, 0), "recv": (xs, 0, 3),
            "broadcast_data": ({"w": xs[0], "b": xs[1, :2]},),
            "multi_node_mean_grad": ([xs, xs[:, :2]],)}.get(op, (xs,))
    got = {}
    for rec, make in ((obs, NaiveCommunicator), (jobs, JaxNaive)):
        rec.reset_all()
        rec.enable()
        getattr(make(size=4), op)(*args)
        got[rec] = W.rows(rec.comm_report())
        rec.disable()
    assert got[obs] == got[jobs] and got[obs]


def test_delegating_subclass_books_once(tracing):
    class Delegating(NaiveCommunicator):
        def allreduce(self, x, op="sum"):
            return super().allreduce(x, op=op)

    comm = Delegating(size=4)
    comm.allreduce(np.stack([np.full((2,), r, np.float32)
                             for r in range(4)]))
    row = obs.comm_report()["per_op"]["allreduce@world"]
    assert (row["calls"], row["bytes"]) == (1, 4 * 2 * 4)
    spans = [e for e in tracing.events()
             if e["ph"] == "X" and e["name"] == "comm/allreduce"]
    assert len(spans) == 1


def test_hierarchical_pmean_books_as_jax(comm1, tracing):
    """The two-tier mean is one call on both axes, its bytes at the DCN
    leg's dtype when one is given (world 1: both axes of size 1)."""
    from chainermn_tpu_torch.topology import make_multislice_mesh

    x = W.block((8,), "float32", 0)
    with make_multislice_mesh(num_slices=1):
        col.hierarchical_pmean(x)
        col.hierarchical_pmean(x, dcn_dtype="bfloat16")
    got = W.rows(obs.comm_report())
    mesh = mn.make_multislice_mesh(jax.devices()[:1], num_slices=1)
    _jfresh()
    fn = jax.jit(shard_map(
        lambda v: (jcol.hierarchical_pmean(v),
                   jcol.hierarchical_pmean(v, dcn_dtype="bfloat16")),
        mesh=mesh, in_specs=P(("slice", "chip")),
        out_specs=P(("slice", "chip")), check_vma=False))
    try:
        fn(x.numpy())
        want = W.rows(jobs.comm_report())
    finally:
        jobs.disable()
        jobs.get_accountant().reset()
    assert got == want == {"hierarchical_pmean@chip+slice": {
        "calls": 2, "bytes": 32 + 16, "dtypes": ["float32", "bfloat16"]}}


def test_zero_overhead_when_disabled(comm1, monkeypatch):
    """Disabled tracing: the collective runs, nothing is booked, no
    payload is computed, and a step bracket clears an earlier report."""
    obs.reset_all()
    assert not obs.enabled()
    monkeypatch.setattr(tcomm, "payload_info", lambda *_: pytest.fail(
        "payload computed with tracing off"))
    out = col.psum(torch.ones(8), comm1.mesh)
    assert torch.equal(out, torch.ones(8))
    comm1.allreduce(torch.ones(2))
    assert obs.comm_report()["per_op"] == {}
    acct = obs.get_accountant()
    with acct.step("x"):
        pass
    assert acct.last_step_report is None
    monkeypatch.undo()
    obs.enable()
    try:
        with acct.step("x"):
            col.psum(torch.ones(8), comm1.mesh)
        assert acct.last_step_report["calls"] == 1
    finally:
        obs.disable()
    with acct.step("x"):           # disabled: the stale report goes
        col.psum(torch.ones(8), comm1.mesh)
    assert acct.last_step_report is None
    obs.reset_all()


def test_ledger_fills_the_health_snapshot(comm1, tracing):
    with obs.get_accountant().step("s"):
        col.psum(torch.ones(4), comm1.mesh)
    snap = obs.health_snapshot()
    assert snap["comm"]["per_op"][f"psum@{AX}"]["bytes"] == 16
    assert snap["last_step_comm"]["calls"] == 1


@pytest.mark.parametrize("name", jobs.__all__)
def test_every_jax_observability_name_resolves(name):
    """JAX's ``observability.__all__`` resolves from the port's, and the
    port's ``__all__`` lists it, and ``comm`` leaves none of JAX's names
    out (its calibration half is ported)."""
    assert hasattr(obs, name) and name in obs.__all__
    assert tcomm.NOT_PORTED == {}
