"""The port's communicator and in-step collectives vs the JAX package's.

* World 1, in this process: the sixteen cases of JAX's
  ``tests/test_communicator.py``, each run on the port's
  ``NaiveCommunicator`` (8 logical ranks, JAX's rank-major face) and on
  ``TorchDistCommunicator`` over a one-rank gloo group (the per-rank face:
  rank 0 passes slab 0 and gets slab 0 of the result, ``gather`` the whole
  stack), against JAX's ``NaiveCommunicator`` on the same numpy inputs.
* World 2: two gloo processes (``tests/_torch_comm_worker.py``, one spawn
  for the module, rendezvous through a ``FileStore``) call every method
  of ``TorchDistCommunicator`` (``gather`` / ``scatter`` / ``alltoall``,
  ``send`` / ``recv`` for every (source, dest), the object collectives,
  ``split`` with colors ``[0, 1]``, ``[0, 0]`` and MPI's scalar face) and
  every collective of ``chainermn_tpu_torch.ops.collective``.  Each rank's
  result must equal slab ``r`` of JAX's answer: its naive communicator's
  rank-major result, or JAX's ``ops.collective`` under ``shard_map`` over
  two virtual CPU devices.
* ``collective_wire_cost`` against JAX's over primitives x sizes 1-8.

Tolerances: data movement and integer reductions exact; fp32 sums and
means rtol 1e-6 (float16 sums rtol 2e-3, as JAX's test).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import chainermn_tpu as mn
from chainermn_tpu.ops import collective as jcol
from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                               create_communicator)
from chainermn_tpu_torch.ops import collective as col

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_comm_worker import PERMS, SPLITS, make_inputs  # noqa: E402

DTYPES = [np.float32, np.float16, np.int32]


@pytest.fixture(scope="module")
def comm1():
    """A one-rank gloo group in this process, torn down after the module."""
    comm = create_communicator("xla", device="cpu")
    yield comm
    dist.destroy_process_group()


class _Face:
    """A port communicator seen through JAX's rank-major face: the naive
    one takes stacks; the process-group one (world 1) takes slab 0 and its
    per-rank result comes back as a stack of one."""

    def __init__(self, comm):
        self.comm = comm
        self.naive = isinstance(comm, NaiveCommunicator)
        self.size = comm.size

    def __call__(self, name, x, **kw):
        fn = getattr(self.comm, name)
        if self.naive:
            return np.asarray(fn(x, **kw))
        out = fn(torch.from_numpy(np.ascontiguousarray(x[0])), **kw)
        return out.numpy()[None] if name != "gather" else out.numpy()


@pytest.fixture(params=["naive", "dist"])
def face(request, comm1):
    return _Face(NaiveCommunicator(size=8) if request.param == "naive"
                 else comm1)


def rank_major(size, shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(0, 10, size=(size,) + shape).astype(dtype)
    return rng.randn(size, *shape).astype(dtype)


def _case_allreduce(face, jn):
    for dtype in DTYPES:
        for op in ("sum", "max", "min"):
            x = rank_major(face.size, (3, 5), dtype)
            np.testing.assert_allclose(face("allreduce", x, op=op),
                                       jn.allreduce(x, op=op), rtol=2e-3,
                                       err_msg=f"{dtype} {op}")


def _case_allreduce_mean(face, jn):
    x = rank_major(face.size, (4,), np.float32)
    np.testing.assert_allclose(face("allreduce", x, op="mean"),
                               jn.allreduce(x, op="mean"), rtol=1e-6)


def _case_bcast(face, jn):
    x = rank_major(face.size, (2, 3), np.float32)
    for root in sorted({0, face.size // 2, face.size - 1}):
        np.testing.assert_array_equal(face("bcast", x, root=root),
                                      jn.bcast(x, root=root))


def _case_gather(face, jn):
    x = rank_major(face.size, (5,), np.float32)
    np.testing.assert_array_equal(face("gather", x, root=0),
                                  jn.gather(x, root=0))


def _case_allgather(face, jn):
    x = rank_major(face.size, (3,), np.float32)
    out = face("allgather", x)
    assert out.shape == (face.size, face.size, 3)
    np.testing.assert_array_equal(out, jn.allgather(x))


def _case_alltoall(face, jn):
    x = rank_major(face.size, (face.size, 2), np.float32)
    np.testing.assert_array_equal(face("alltoall", x), jn.alltoall(x))


def _case_scatter(face, jn):
    x = rank_major(face.size, (4,), np.float32)
    got = (face("scatter", x, root=0) if face.naive
           else face.comm.scatter(torch.from_numpy(x), root=0).numpy()[None])
    np.testing.assert_array_equal(got, jn.scatter(x, root=0))


def _case_send_recv(face, jn):
    x = rank_major(face.size, (3,), np.float32)
    s = face.size
    for source, dest in sorted({(0, 5 % s), (3 % s, 1 % s), (s - 1, 0)}):
        for name in ("send", "recv"):
            np.testing.assert_array_equal(
                face(name, x, dest=dest, source=source),
                getattr(jn, name)(x, dest=dest, source=source))


def _case_stack_unstack(face, jn):
    per_rank = [np.full((2,), r, np.float32) for r in range(face.size)]
    stacked = face.comm.stack(per_rank)
    np.testing.assert_array_equal(np.asarray(stacked),
                                  np.asarray(jn.stack(per_rank)))
    for a, b in zip(face.comm.unstack(stacked), per_rank):
        np.testing.assert_array_equal(a, b)


def _case_obj_roundtrip(face, jn):
    obj = {"vocab": ["a", "b"], "n": 3}
    comm = face.comm
    assert comm.bcast_obj(obj) == jn.bcast_obj(obj) == obj
    assert comm.gather_obj(obj) == jn.gather_obj(obj)
    assert comm.allgather_obj(obj) == jn.allgather_obj(obj)
    assert comm.allreduce_obj(1) == jn.allreduce_obj(1) == face.size
    assert comm.allreduce_obj([1], op=lambda a, b: a + b) == \
        jn.allreduce_obj([1], op=lambda a, b: a + b)
    comm.send_obj([1, 2], dest=0)
    assert comm.recv_obj(source=0) == [1, 2]


def _case_topology_properties(face, jn):
    comm = face.comm
    assert comm.size == jn.size and 0 <= comm.rank < comm.size
    assert comm.intra_size * comm.inter_size >= comm.size
    assert comm.inter_size == jn.inter_size == 1


def _case_multi_node_mean_grad(face, jn):
    grads = {"w": rank_major(face.size, (3, 3), np.float32, seed=1),
             "b": rank_major(face.size, (3,), np.float32, seed=2)}
    want = jn.multi_node_mean_grad(grads)
    if face.naive:
        got = face.comm.multi_node_mean_grad(grads)
    else:
        got = dict(zip(grads, [g.numpy()[None] for g in
                               face.comm.multi_node_mean_grad(
                                   [torch.from_numpy(grads[k][0])
                                    for k in grads])]))
    for k in grads:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6)


def _case_matches_naive_oracle(face, jn):
    oracle = NaiveCommunicator(size=face.size)
    x = rank_major(face.size, (face.size, 3), np.float32)
    for name in ("allreduce", "bcast", "allgather", "alltoall"):
        np.testing.assert_allclose(face(name, x), getattr(oracle, name)(x),
                                   rtol=1e-6, err_msg=name)


def _case_split(face, jn):
    colors = [r * 2 // face.size for r in range(face.size)]
    subs, jsubs = face.comm.split(colors), jn.split(colors)
    if face.naive:
        assert set(subs) == set(jsubs)
        for c in subs:
            assert subs[c].size == jsubs[c].size
        x = np.arange(jsubs[1].size, dtype=np.float32).reshape(-1, 1)
        np.testing.assert_allclose(subs[1].allreduce(x),
                                   jsubs[1].allreduce(x))
    else:
        (c, sub), = subs.items()
        assert c == colors[0] and sub.size == jsubs[c].size
        np.testing.assert_allclose(
            sub.allreduce(torch.ones(1, 3)).numpy()[None],
            jsubs[c].allreduce(np.ones((1, 1, 3), np.float32)))
    whole = face.comm.split(0)
    assert whole.size == jn.split(0).size


def _case_broadcast_data(face, jn):
    params = {"w": np.ones((4, 4), np.float32)}
    if face.naive:
        rep = face.comm.broadcast_data(params)
        np.testing.assert_array_equal(rep["w"], np.asarray(
            jn.broadcast_data(params)["w"]))
    else:
        module = torch.nn.Linear(4, 4)
        before = module.weight.detach().clone()
        face.comm.broadcast_data(module)
        torch.testing.assert_close(module.weight.detach(), before,
                                   rtol=0, atol=0)


def _case_create_communicator_unknown(face, jn):
    with pytest.raises(ValueError):
        create_communicator("definitely_not_a_backend", device="cpu")
    with pytest.raises(ValueError):
        mn.create_communicator("definitely_not_a_backend")


CASES = {name[len("_case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_world_1_matches_jax_naive(face, case):
    CASES[case](face, mn.create_communicator("naive", size=face.size))


def test_sixteen_cases_of_the_jax_matrix():
    assert len(CASES) == 16


# ---- world 2 over two gloo processes ----

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm2")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_comm_worker.py"),
         str(r), "2", str(tmp / "store"), str(tmp / f"out{r}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    outs = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def _close(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _expected_comm(key, r, inputs, jn):
    """Slab ``r`` of the JAX naive communicator's answer for ``key``."""
    parts = key.split("/")
    name, dt = parts[0], parts[-1]
    x = inputs.get(dt)
    if name == "allreduce":
        return jn.allreduce(x, op=parts[1])[r]
    if name == "bcast":
        return jn.bcast(x, root=int(parts[1]))[r]
    if name == "gather":
        return jn.gather(x, root=int(parts[1])) if r == int(parts[1]) \
            else None
    if name == "scatter":
        return jn.scatter(x, root=int(parts[1]))[r]
    if name in ("send", "recv"):
        return getattr(jn, name)(x, dest=int(parts[2]),
                                 source=int(parts[1]))[r]
    if name == "allgather":
        return jn.allgather(x)[r]
    if name == "alltoall":
        return jn.alltoall(inputs["a2a"])[r]
    raise KeyError(key)


ARRAY_KEYS = sorted(
    [f"allreduce/{op}/{dt}" for op in ("sum", "max", "min")
     for dt in ("f", "i")] + ["allreduce/mean/f", "alltoall"]
    + [f"{n}/{root}/{dt}" for n in ("bcast", "gather", "scatter")
       for root in (0, 1) for dt in ("f", "i")]
    + [f"{n}/{s}/{d}/{dt}" for n in ("send", "recv") for s in (0, 1)
       for d in (0, 1) for dt in ("f", "i")]
    + [f"allgather/{dt}" for dt in ("f", "i")])


@pytest.mark.parametrize("key", ARRAY_KEYS)
def test_world_2_array_collectives_match_jax(world2, key):
    inputs, jn = make_inputs(2), mn.create_communicator("naive", size=2)
    for r, out in enumerate(world2):
        want = _expected_comm(key, r, inputs, jn)
        got = out["comm"][key]
        if want is None:
            assert got is None, key
            continue
        exact = key.endswith("/i") or not key.startswith("allreduce/") \
            or key.split("/")[1] in ("max", "min")
        _close(got, np.asarray(want), exact)


def test_world_2_grad_mean_stack_and_topology(world2):
    inputs, jn = make_inputs(2), mn.create_communicator("naive", size=2)
    want = jn.multi_node_mean_grad({"f": inputs["f"], "a": inputs["a2a"]})
    for r, out in enumerate(world2):
        c = out["comm"]
        _close(c["mean_grad"][0], np.asarray(want["f"])[r], False)
        _close(c["mean_grad"][1], np.asarray(want["a"])[r], False)
        np.testing.assert_array_equal(c["stack"], inputs["f"])
        for a, b in zip(c["unstack"], jn.unstack(inputs["f"])):
            np.testing.assert_array_equal(a, b)
        assert c["topology"] == (r, 2, r, 2, 0, 1)
        assert c["device_of"] == ["cpu", "cpu"]


def test_world_2_object_collectives(world2):
    objs = [{"rank": r, "vals": [r, r * 2]} for r in range(2)]
    for r, out in enumerate(world2):
        c = out["comm"]
        assert c["bcast_obj"] == objs
        assert c["gather_obj"] == [objs if r == root else None
                                   for root in range(2)]
        assert c["allgather_obj"] == objs
        assert c["allreduce_obj"] == 1 + 2
        assert c["allreduce_obj_op"] == [0, 1]     # folded in rank order
        assert c[f"recv_obj/{r}"] == [{"from": 1 - r, "to": r}]
        assert c["recv_obj/self"] == "loop"


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_world_2_split_matches_jax(world2, name):
    colors = SPLITS[name]
    inputs, jn = make_inputs(2), mn.create_communicator("naive", size=2)
    jsubs = jn.split(colors)
    for r, out in enumerate(world2):
        got = out["comm"][f"split/{name}"]
        color = colors[r]
        members = [q for q in range(2) if colors[q] == color]
        jsub = jsubs[color]
        assert got["color"] == color and got["size"] == jsub.size
        assert got["rank"] == members.index(r)
        assert got["intra"] == (members.index(r), len(members))
        assert got["inter"] == (0, 1)
        stack = inputs["f"][members]
        want = jsub.allreduce(stack)[members.index(r)]
        _close(got["allreduce"], want, len(members) == 1)
        _close(got["psum"], want, len(members) == 1)
        assert got["bcast_obj"] == ("root of", color, members[0])
        if got["rank"] == 0:
            np.testing.assert_array_equal(got["gather"], jsub.gather(stack))
        else:
            assert got["gather"] is None
    for r, out in enumerate(world2):     # MPI's face: colors r % 2
        size, rank, total = out["comm"]["split/scalar"]
        assert (size, rank) == (1, 0)
        np.testing.assert_array_equal(total, np.full(2, r + 1.0))


# ---- in-step collectives vs JAX's under shard_map on two devices ----

def _jax_per_rank(fn, *stacks):
    """JAX's ``fn`` on each rank's block (slab ``r`` of each stack), over a
    two-device mesh; returns the rank-major stack of the results."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("mn",))

    def body(*blocks):
        out = fn(*[b[0] for b in blocks])
        return jax.tree_util.tree_map(lambda o: o[None], out)

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=tuple(P("mn") for _ in stacks),
                      out_specs=P("mn"), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, f(*stacks))


def _jax_col_cases(inputs):
    f, i, wide, a2a = (inputs[k] for k in ("f", "i", "wide", "a2a"))
    cases = {}
    for name in ("psum", "pmean", "pmax", "pmin"):
        fn = getattr(jcol, name)
        cases[name] = (lambda b, fn=fn: fn(b), f)
        if name != "pmean":
            cases[f"{name}/int"] = (lambda b, fn=fn: fn(b), i)
    cases["pmean_if_bound"] = (jcol.pmean_if_bound, f)
    cases["pmean_if_bound/none"] = (lambda b: b, f)
    for axis in (0, 1):
        for tiled in (True, False):
            cases[f"all_gather/{axis}/{tiled}"] = (
                lambda b, a=axis, t=tiled: jcol.all_gather(
                    b, axis=a, tiled=t), f)
        cases[f"reduce_scatter/{axis}"] = (
            lambda b, a=axis: jcol.reduce_scatter(b, scatter_axis=a), wide)
    for split, concat in ((0, 0), (0, 1), (1, 0), (1, 1)):
        cases[f"all_to_all/{split}/{concat}"] = (
            lambda b, s=split, c=concat: jcol.all_to_all(
                b, split_axis=s, concat_axis=c, tiled=True), wide)
    cases["all_to_all/untiled"] = (
        lambda b: jcol.all_to_all(b, split_axis=0, concat_axis=1,
                                  tiled=False), a2a)
    for name, perm in PERMS.items():
        cases[f"ppermute/{name}"] = (
            lambda b, p=perm: jcol.ppermute(b, p), f)
        cases[f"ppermute/{name}/int"] = (
            lambda b, p=perm: jcol.ppermute(b, p), i)
    for offset in (1, -1):
        cases[f"shift/{offset}"] = (
            lambda b, o=offset: jcol.shift(b, o, size=2), f)
    for root in (0, 1):
        cases[f"bcast/{root}"] = (lambda b, rt=root: jcol.bcast(b, rt), f)
    cases["psum/tree"] = (lambda b: jcol.psum({"a": b, "b": [b * 2, b[0]]}),
                          f)
    return cases


COL_KEYS = sorted(_jax_col_cases(make_inputs(2)))


@pytest.mark.parametrize("key", COL_KEYS)
def test_world_2_in_step_collectives_match_jax(world2, key):
    fn, stack = _jax_col_cases(make_inputs(2))[key]
    want = _jax_per_rank(fn, stack)
    exact = not key.startswith(("psum", "pmean", "reduce_scatter")) \
        or key.endswith("/int")
    for r, out in enumerate(world2):
        got = out["col"][key]
        if key == "psum/tree":
            _close(got["a"], want["a"][r], False)
            for g, w in zip(got["b"], want["b"]):
                _close(g, w[r], False)
            continue
        _close(got, want[r], exact)


def test_world_2_axis_index_and_size(world2):
    for r, out in enumerate(world2):
        assert out["col"]["axis"] == (r, 2, r, 2)


def test_world_1_in_step_collectives_are_identities(comm1):
    x = torch.arange(12.0).reshape(4, 3)
    for fn in (col.psum, col.pmean, col.pmax, col.pmin, col.pmean_if_bound,
               col.bcast, lambda v: col.shift(v, 1),
               lambda v: col.ppermute(v, [(0, 0)]),
               lambda v: col.reduce_scatter(v), col.all_gather,
               col.all_to_all):
        torch.testing.assert_close(fn(x), x, rtol=0, atol=0)
    torch.testing.assert_close(col.all_gather(x, tiled=False), x[None],
                               rtol=0, atol=0)
    torch.testing.assert_close(col.ppermute(x, []), torch.zeros_like(x),
                               rtol=0, atol=0)
    assert (col.axis_index(), col.axis_size()) == (0, 1)
    with pytest.raises(ValueError, match="equal chunks"):
        col.all_to_all(x, split_axis=0, tiled=False)


PRIMITIVES = ["psum", "pmax", "pmin", "psum_scatter", "reduce_scatter",
              "all_gather", "all_to_all", "ppermute", "pshuffle", "other"]


@pytest.mark.parametrize("primitive", PRIMITIVES)
def test_collective_wire_cost_matches_jax(primitive):
    for size in range(1, 9):
        for payload in (0, 1, 4, 1000, 4096, 12345):
            assert col.collective_wire_cost(primitive, payload, size) == \
                jcol.collective_wire_cost(primitive, payload, size)
