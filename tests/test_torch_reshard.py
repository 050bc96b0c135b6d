"""``parallel/reshard.py`` of the port against the JAX package's (CPU).

* ``reshard_host`` over seeded shard lists: replicated, ``per_rank``, axis
  0 / 1, and 1 → 2, 2 → 1, 2 → 4, 4 → 2 processes, with numpy leaves
  (bit-equal to JAX's) and torch leaves (bf16 included: equal to JAX's on
  the same values); the error cases raise on the same inputs;
* ``reshard_cost`` / ``reshard_tree_cost`` equal JAX's over a grid of
  shapes, dtypes, spec pairs and axis sizes;
* ``reshard`` at world 2 over gloo (``tests/_torch_robustness_worker.py
  gloo``) against JAX's ``make_reshard`` on two virtual CPU devices, for
  every (src, dst) pair of the docstring's table;
* ``validate_spec`` / ``partition_spec_of``, and ``lower_schedule`` /
  ``schedule=`` against JAX's.
"""

import importlib
import itertools
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

# the packages' ``parallel`` re-export the function ``reshard``: take the
# modules themselves
jr = importlib.import_module("chainermn_tpu.parallel.reshard")
tr = importlib.import_module("chainermn_tpu_torch.parallel.reshard")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_robustness_worker as worker  # noqa: E402


def _shards(src_n, spec, seed):
    """``src_n`` shards of a state: ``a`` (6 x 8 x 4 logical, sharded per
    ``spec``), ``r`` replicated, ``p`` per rank."""
    rng = np.random.RandomState(seed)
    full = rng.randn(8, 8, 4).astype(np.float32)
    out = []
    for p in range(src_n):
        a = full if spec is None else np.split(full, src_n, axis=spec)[p]
        out.append({"a": a.copy(), "r": np.full(3, 1.5 + seed),
                    "p": np.int64(p * 10 + seed)})
    return out


def _layout(spec):
    return {"a": spec, "p": "per_rank", "r": None}


CASES = [(src_n, dst_n, src, dst)
         for src_n, dst_n in ((1, 2), (2, 1), (2, 4), (4, 2), (2, 2))
         for src, dst in itertools.product((None, 0, 1), repeat=2)]


@pytest.mark.parametrize("src_n,dst_n,src,dst", CASES)
def test_reshard_host_equals_jax(src_n, dst_n, src, dst):
    shards = _shards(src_n, src, seed=src_n * 7 + dst_n)
    want = jr.reshard_host(shards, _layout(src), _layout(dst), dst_n)
    got = tr.reshard_host(shards, _layout(src), _layout(dst), dst_n)
    assert len(got) == len(want) == dst_n
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the exactness contract
    if src is not None and dst is not None:
        joined = np.concatenate([g["a"] for g in got], axis=dst)
        np.testing.assert_array_equal(
            joined, np.concatenate([s["a"] for s in shards], axis=src))
    for r, g in enumerate(got):
        assert g["p"] == shards[r % src_n]["p"]
        np.testing.assert_array_equal(g["r"], shards[0]["r"])


@pytest.mark.parametrize("src_n,dst_n,src,dst",
                         [(2, 1, 0, None), (1, 2, None, 1), (2, 4, 1, 0),
                          (4, 2, 0, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reshard_host_torch_leaves(src_n, dst_n, src, dst, dtype):
    """Torch CPU leaves are joined and sliced with torch, keep their dtype
    and equal JAX's result on the same values bit for bit."""
    shards = _shards(src_n, src, seed=3)
    tshards = [{**s, "a": torch.from_numpy(s["a"]).to(dtype)}
               for s in shards]
    want = jr.reshard_host(
        [{**s, "a": t["a"].float().numpy()} for s, t in zip(shards,
                                                            tshards)],
        _layout(src), _layout(dst), dst_n)
    got = tr.reshard_host(tshards, _layout(src), _layout(dst), dst_n)
    for g, w in zip(got, want):
        assert isinstance(g["a"], torch.Tensor) and g["a"].dtype == dtype
        np.testing.assert_array_equal(g["a"].float().numpy(), w["a"])


@pytest.mark.parametrize("args,err", [
    (("per_rank", 0, 2), ValueError),            # per_rank <-> partition
    ((0, 0, 3), ValueError),                     # 8 does not split in 3
    ((5, None, 1), ValueError),                  # axis out of range
    (("x", None, 1), TypeError),                 # not a spec
    ((None, None, 0), ValueError),               # dst_count < 1
])
def test_reshard_host_errors_match_jax(args, err):
    src, dst, n = args
    shards = _shards(2, 0, seed=1)
    for mod in (jr, tr):
        with pytest.raises(err):
            mod.reshard_host(shards, {"a": src, "p": "per_rank", "r": None},
                             {"a": dst, "p": "per_rank", "r": None}, n)
    for mod in (jr, tr):
        with pytest.raises(ValueError, match="empty"):
            mod.reshard_host([], None, None, 1)
        with pytest.raises(ValueError, match="leaves"):
            mod.reshard_host(shards, [None], [None], 1)


SHAPES = [(), (8,), (4, 6), (8, 2, 3)]
DTYPES = ["float32", "bfloat16", "int8", "float16"]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reshard_cost_equals_jax(shape):
    specs = [None] + list(range(len(shape)))
    for dtype, p, src, dst in itertools.product(DTYPES, (1, 2, 4, 8), specs,
                                                specs):
        jdt = jax.numpy.dtype(dtype)
        tdt = getattr(torch, dtype)
        want = jr.reshard_cost(shape, jdt, src, dst, p)
        assert tr.reshard_cost(shape, tdt, src, dst, p) == want
        if dtype != "bfloat16":
            assert tr.reshard_cost(shape, np.dtype(dtype), src, dst,
                                   p) == want


def test_reshard_tree_cost_equals_jax():
    tree = {"w": np.zeros((8, 4), np.float32), "b": np.zeros(8, np.float16),
            "s": [np.zeros((2, 8), np.float32)]}
    ttree = {k: (torch.from_numpy(v) if not isinstance(v, list)
                 else [torch.from_numpy(v[0])]) for k, v in tree.items()}
    for src, dst in [(None, 0), (0, None),
                     ({"w": 0, "b": 0, "s": [0]}, {"w": 1, "b": None,
                                                    "s": [1]}),
                     ({"w": 0, "b": None, "s": [1]}, None)]:
        for p in (2, 4):
            want = jr.reshard_tree_cost(tree, src, dst, p)
            assert tr.reshard_tree_cost(ttree, src, dst, p) == want
            assert tr.reshard_tree_cost(tree, src, dst, p) == want


def test_validate_and_partition_spec():
    for spec, ndim in [(None, 2), (0, 2), (-1, 3), (1, 2)]:
        assert tr.validate_spec(spec, ndim) == jr.validate_spec(spec, ndim)
        assert tr.partition_spec_of(spec, ndim, "mn") == tuple(
            jr.partition_spec_of(spec, ndim, "mn"))
    for bad, err in [(2, ValueError), (True, TypeError), ("0", TypeError)]:
        for mod in (jr, tr):
            with pytest.raises(err):
                mod.validate_spec(bad, 2)


def test_schedules_name_their_queue_item():
    """The schedule names are ported (nothing is left in ``NOT_PORTED``):
    ``lower_schedule`` gives JAX's schedule and ``schedule=`` JAX's
    result (``tests/test_torch_schedule.py`` holds them in full)."""
    assert tr.NOT_PORTED == {}
    s = tr.lower_schedule((4, 6), "float32", 0, None, 2, 1)
    assert s.fingerprint() == jr.lower_schedule(
        (4, 6), "float32", 0, None, 2, 1).fingerprint()
    got = tr.reshard_host(_shards(2, 0, 0), _layout(0), _layout(None), 1,
                          schedule="auto")
    want = jr.reshard_host(_shards(2, 0, 0), _layout(0), _layout(None), 1,
                           schedule="auto")
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("reshard2")
    rcs, logs, _ = worker.launch("gloo", out)
    assert rcs == [0, 0], "\n".join(logs)[-4000:]
    return [pickle.loads((out / f"gloo{r}.pkl").read_bytes())
            for r in range(2)]


@pytest.mark.parametrize("src,dst", worker.RESHARD_PAIRS, ids=str)
def test_reshard_world_2_gloo_equals_jax(gloo_results, src, dst):
    """Each rank's block after the port's ``reshard`` over gloo equals that
    rank's block of JAX's ``reshard`` on two virtual devices.  JAX's own
    ``make_reshard`` refuses the sharded → replicated pairs on this jax
    (``shard_map`` cannot infer the replication of its output), so JAX's
    in-SPMD ``reshard`` runs inside ``shard_map`` with that check off, the
    body ``make_reshard`` jits."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from chainermn_tpu._compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:2]), ("mn",))
    full = worker.logical()
    in_spec = P(*jr.partition_spec_of(src, 2, "mn"))
    # every rank's output block, stacked on a new leading axis
    fn = shard_map(lambda t: jr.reshard(t, src, dst, "mn")[None],
                   mesh=mesh, in_specs=(in_spec,), out_specs=P("mn"),
                   check_vma=False)
    out = np.asarray(jax.jit(fn)(jax.device_put(
        full, NamedSharding(mesh, in_spec))))
    for r in range(2):
        got = gloo_results[r]["reshard"][(src, dst)]
        np.testing.assert_array_equal(got, out[r])
        np.testing.assert_array_equal(got, worker.block_of(full, dst, r, 2))
