"""The port's checkpointer against the JAX package's (CPU, no card).

* JAX's non-slow cases of ``TestCheckpointer``, ``TestAsyncCheckpointWrites``,
  ``TestReshardCheckpoint``, ``TestMultiNodeSnapshot``, ``TestManifestV2``
  and ``TestElasticResume`` (``tests/test_extensions.py``) on the port, over
  the one-process naive communicator of 8 ranks (JAX's one controller over
  8 virtual devices);
* for a numpy-only state, the port's manifest equals JAX's field for
  field (schema, world, layout, paths, logical shapes, dtypes, CRCs), and a
  generation written by either package loads through the other's
  ``maybe_load``;
* the host snapshot shares no memory with the live state (save, mutate in
  place, flush, load), bf16 leaves round-trip bit for bit, a Trainer's
  state (module, optimizer, iterator, double-buffered ``stale_grads``)
  comes back through ``load_checkpoint_state``;
* a world-2 generation written over gloo (``tests/_torch_robustness_worker.py
  gloo``) resumes elastically at world 1.
"""

import json
import os
import pickle
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chainermn_tpu as jmn
from chainermn_tpu.extensions import \
    create_multi_node_checkpointer as jax_create
from chainermn_tpu_torch.communicators import NaiveCommunicator
from chainermn_tpu_torch.extensions import (MANIFEST_SCHEMA,
                                            create_multi_node_checkpointer,
                                            multi_node_snapshot,
                                            reshard_checkpoint)
from chainermn_tpu_torch.extensions.checkpoint import _leaf_paths_and_shapes
from chainermn_tpu_torch.iterators import SerialIterator

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_robustness_worker as worker  # noqa: E402


@pytest.fixture(scope="module")
def comm():
    """One process, 8 logical ranks: the JAX tests' single controller."""
    return NaiveCommunicator(size=8)


def _files(path):
    return [f for f in os.listdir(path)
            if not f.startswith(".") and "manifest" not in f]


class TestCheckpointer:
    def _state(self, step):
        return {
            "params": {"w": np.full((3, 3), float(step)), "b": np.arange(3.0)},
            "step": step,
        }

    def test_save_maybe_load_roundtrip(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        assert cp.maybe_load()[1] is None
        cp.save(self._state(7), iteration=7)
        cp.save(self._state(9), iteration=9)
        loaded, it = cp.maybe_load()
        assert it == 9
        np.testing.assert_array_equal(loaded["params"]["w"],
                                      np.full((3, 3), 9.0))
        assert loaded["step"] == 9

    def test_resume_keeps_passed_state_when_empty(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        template = {"x": 1}
        state, it = cp.maybe_load(template)
        assert it is None and state is template

    def test_generation_gc(self, comm, tmp_path):
        cp = create_multi_node_checkpointer(
            "job", comm, gc_interval=3, keep=2, path=str(tmp_path))
        for i in range(1, 8):
            cp.save(self._state(i), iteration=i)
        assert cp.get_generations() == [5, 6, 7]

    def test_world_size_mismatch_fails_loudly(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save(self._state(1), iteration=1)
        cp.flush()
        (old,) = _files(tmp_path)
        os.rename(tmp_path / old, tmp_path / old.replace("of1", "of4"))
        with pytest.raises(RuntimeError, match="world size"):
            cp.maybe_load()

    def test_iterator_state_checkpointable(self, comm, tmp_path):
        ds = [(np.float32(i), i % 2) for i in range(20)]
        it = SerialIterator(ds, 3, shuffle=True, seed=0)
        for _ in range(3):
            it.next()
        cp = create_multi_node_checkpointer("it", comm, path=str(tmp_path))
        cp.save({"iterator": it.state_dict()}, iteration=3)
        expect = [x[0] for x in it.next()]
        loaded, _ = cp.maybe_load()
        it2 = SerialIterator(ds, 3, shuffle=True, seed=99)
        it2.load_state_dict(loaded["iterator"])
        assert [x[0] for x in it2.next()] == expect

    def test_device_arrays_detached(self, comm, tmp_path):
        """JAX: a device array comes back as numpy.  Here a tensor comes
        back as a CPU tensor that shares nothing with the saved one."""
        cp = create_multi_node_checkpointer("dev", comm, path=str(tmp_path))
        t = torch.ones(4)
        cp.save({"p": t}, iteration=1)
        loaded, _ = cp.maybe_load()
        assert isinstance(loaded["p"], torch.Tensor)
        assert loaded["p"].device.type == "cpu"
        assert loaded["p"].data_ptr() != t.data_ptr()

    def test_finalize_cleans_up(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save(self._state(1), iteration=1)
        cp.finalize()
        assert cp.maybe_load()[1] is None


class TestAsyncCheckpointWrites:
    def test_async_is_default_and_joins_on_read(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        assert cp._async
        state = {"w": np.arange(6.0)}
        cp.save(state, iteration=3)
        loaded, it = cp.maybe_load()
        assert it == 3
        np.testing.assert_array_equal(loaded["w"], state["w"])

    def test_unpicklable_state_fails_at_save(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        with pytest.raises(Exception, match="pickle|local object"):
            cp.save({"bad": lambda: None}, iteration=1)
        assert cp.get_generations() == []

    def test_finalize_cleans_up_even_after_writer_error(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save({"x": 1}, iteration=1)
        cp.flush()
        cp._submit(lambda: (_ for _ in ()).throw(OSError("disk gone")))
        with pytest.raises(OSError, match="disk gone"):
            cp.finalize()
        assert cp._local_files(any_world_size=True) == []

    def test_sync_mode_still_available(self, comm, tmp_path):
        cp = create_multi_node_checkpointer(
            "job", comm, path=str(tmp_path), async_write=False)
        cp.save({"x": 1}, iteration=2)
        assert cp.maybe_load()[1] == 2

    def test_save_does_not_block_on_disk_io(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        big = {"w": np.zeros((256, 256), np.float32)}
        for i in range(5):
            cp.save(big, iteration=i)
        assert cp.maybe_load()[1] == 4
        assert [r["iteration"] for r in cp.timings] == list(range(5))
        assert all(r["bytes"] > 256 * 256 * 4 and r["write_ms"] >= 0
                   for r in cp.timings)


def _write_shard(tmp_path, name, it, proc, nproc, state):
    fn = tmp_path / f"{name}.iter{it:012d}.proc{proc}of{nproc}"
    fn.write_bytes(pickle.dumps(state))


class TestReshardCheckpoint:
    def test_reshard_then_maybe_load(self, comm, tmp_path):
        for it in (5, 9):
            for p in range(2):
                _write_shard(tmp_path, "job", it, p, 2,
                             {"w": [1.0, 2.0], "iteration": it})
        assert reshard_checkpoint(str(tmp_path), "job", new_nproc=1) == 9
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        loaded, resumed = cp.maybe_load({"w": None, "iteration": -1})
        assert resumed == 9
        assert loaded == {"w": [1.0, 2.0], "iteration": 9}
        cp.finalize()

    def test_picks_requested_iteration_and_source(self, tmp_path):
        for p in range(2):
            _write_shard(tmp_path, "job", 5, p, 2, {"proc": p})
        assert reshard_checkpoint(str(tmp_path), "job", new_nproc=3,
                                  iteration=5, source_process=1) == 5
        for p in range(3):
            fn = tmp_path / f"job.iter{5:012d}.proc{p}of3"
            assert pickle.loads(fn.read_bytes()) == {"proc": 1}

    def test_same_iteration_two_world_sizes_raises_without_explicit(
            self, tmp_path):
        _write_shard(tmp_path, "job", 5, 0, 1, {"world": 1})
        for p in range(2):
            _write_shard(tmp_path, "job", 5, p, 2, {"world": 2})
        with pytest.raises(RuntimeError, match="multiple world sizes"):
            reshard_checkpoint(str(tmp_path), "job", new_nproc=1)
        assert reshard_checkpoint(str(tmp_path), "job", new_nproc=1,
                                  iteration=5) == 5

    def test_incomplete_generation_rejected(self, tmp_path):
        _write_shard(tmp_path, "job", 5, 0, 2, {})
        with pytest.raises(RuntimeError, match="no complete generation"):
            reshard_checkpoint(str(tmp_path), "job", new_nproc=1)

    def test_bad_source_process_rejected(self, tmp_path):
        for p in range(2):
            _write_shard(tmp_path, "job", 5, p, 2, {})
        with pytest.raises(ValueError, match="source_process"):
            reshard_checkpoint(str(tmp_path), "job", new_nproc=1,
                               source_process=5)

    def test_validates_new_nproc_and_ignores_stray_shards(self, tmp_path):
        for p in range(2):
            _write_shard(tmp_path, "job", 5, p, 2, {"ok": True})
        _write_shard(tmp_path, "job", 5, 7, 2, {"stray": True})
        with pytest.raises(ValueError, match="new_nproc"):
            reshard_checkpoint(str(tmp_path), "job", new_nproc=0)
        with pytest.raises(ValueError, match="source_process"):
            reshard_checkpoint(str(tmp_path), "job", new_nproc=1,
                               source_process=-1)
        assert reshard_checkpoint(str(tmp_path), "job", new_nproc=1) == 5


class TestMultiNodeSnapshot:
    def _state(self, step):
        return {"w": np.full((2, 2), float(step)), "step": step}

    def test_roundtrip_writes_one_shard_per_group(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        half = comm.size // 2
        snap = multi_node_snapshot(
            comm, cp, [list(range(half)), list(range(half, comm.size))])
        assert snap.maybe_load()[1] is None
        snap.save(self._state(3), iteration=3)
        snap.save(self._state(8), iteration=8)
        snap.flush()
        files = _files(tmp_path)
        assert len(files) == 4, files
        assert all(".set" in f and "of2" in f for f in files)
        loaded, it = snap.maybe_load()
        assert it == 8
        np.testing.assert_array_equal(loaded["w"], np.full((2, 2), 8.0))

    def test_unlisted_ranks_become_singletons(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        snap = multi_node_snapshot(comm, cp, [[0, 1]])
        assert len(snap.sets) == comm.size - 1
        snap.save(self._state(1), iteration=1)
        snap.flush()
        assert len(_files(tmp_path)) == comm.size - 1

    def test_overlapping_sets_rejected(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        with pytest.raises(ValueError):
            multi_node_snapshot(comm, cp, [[0, 1], [1, 2]])

    def test_gc_keeps_newest_generations(self, comm, tmp_path):
        cp = create_multi_node_checkpointer(
            "job", comm, gc_interval=3, keep=2, path=str(tmp_path),
            async_write=False)
        snap = multi_node_snapshot(comm, cp, [list(range(comm.size))])
        for it in range(1, 7):
            snap.save(self._state(it), iteration=it)
        gens = sorted({int(f.split(".iter")[1][:12])
                       for f in os.listdir(tmp_path)
                       if not f.startswith(".")})
        assert len(gens) <= 3 and gens[-1] == 6, gens

    def test_layout_change_fails_loudly(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path),
                                            async_write=False)
        old = multi_node_snapshot(comm, cp, [list(range(comm.size))])
        old.save(self._state(5), iteration=5)
        new = multi_node_snapshot(comm, cp, [[r] for r in range(comm.size)])
        with pytest.raises(RuntimeError, match="stale"):
            new.maybe_load()

    def test_async_save_rides_checkpointer_writer(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path),
                                            async_write=True)
        snap = multi_node_snapshot(comm, cp, [list(range(comm.size))])
        snap.save(self._state(2), iteration=2)
        snap.flush()
        loaded, it = snap.maybe_load()
        assert it == 2 and loaded["step"] == 2


class TestManifestV2:
    def _state(self, step):
        return {"w": np.full((2, 2), float(step)), "step": step}

    def test_manifest_written_and_checksums_match(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save(self._state(4), iteration=4)
        cp.flush()
        with open(cp._manifest_path(4)) as f:
            man = json.load(f)
        assert man["schema"] == MANIFEST_SCHEMA
        assert man["world_size"] == 1
        shard = open(cp._filename(4), "rb").read()
        assert man["checksums"]["0"] == zlib.crc32(shard) & 0xFFFFFFFF
        shapes = sorted(tuple(leaf["shape"]) for leaf in man["leaves"])
        assert shapes == [(), (2, 2)]

    def test_torn_shard_falls_back_to_previous_generation(self, comm,
                                                          tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save(self._state(1), iteration=1)
        cp.save(self._state(2), iteration=2)
        cp.flush()
        shard2 = cp._filename(2)
        data = open(shard2, "rb").read()
        with open(shard2, "wb") as f:
            f.write(data[: len(data) // 2])
        loaded, it = cp.maybe_load()
        assert it == 1
        np.testing.assert_array_equal(loaded["w"], np.full((2, 2), 1.0))

    def test_torn_only_generation_raises_loudly(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save(self._state(1), iteration=1)
        cp.flush()
        with open(cp._filename(1), "ab") as f:
            f.write(b"garbage appended after the atomic rename")
        with pytest.raises(RuntimeError, match="torn|restorable"):
            cp.maybe_load()

    def test_manifest_false_keeps_v1_behavior(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path),
                                            manifest=False)
        cp.save(self._state(3), iteration=3)
        cp.flush()
        assert not os.path.exists(cp._manifest_path(3))
        assert cp.maybe_load()[1] == 3

    def test_writer_error_reraises_at_next_save(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save(self._state(1), iteration=1)
        cp.flush()
        cp._submit(lambda: (_ for _ in ()).throw(OSError("disk gone")))
        with pytest.raises(OSError, match="disk gone"):
            cp.save(self._state(2), iteration=2)
        cp.save(self._state(3), iteration=3)
        assert cp.maybe_load()[1] == 3


def _old_world(tmp_path, old_n, iteration, name="job", sharded_len=8):
    """A complete old-world generation + v2 manifest, written by hand as
    JAX's test writes it: replicated w, axis-0-sharded m, per_rank tag."""
    full_m = np.arange(sharded_len, dtype=np.float32)
    block = sharded_len // old_n
    checksums, state0 = {}, None
    for p in range(old_n):
        state = {"m": full_m[p * block:(p + 1) * block], "rank_tag": p,
                 "w": np.full((2, 2), 7.0)}
        state0 = state0 or state
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        (tmp_path / f"{name}.iter{iteration:012d}.proc{p}of{old_n}"
         ).write_bytes(payload)
        checksums[str(p)] = zlib.crc32(payload) & 0xFFFFFFFF
    layout = {"['m']": ["sharded", 0], "['rank_tag']": "per_rank"}
    man = {"schema": MANIFEST_SCHEMA, "name": name, "iteration": iteration,
           "world_size": old_n, "kind": "proc", "layout": layout,
           "leaves": _leaf_paths_and_shapes(state0, layout, old_n),
           "checksums": checksums}
    (tmp_path / f"{name}.iter{iteration:012d}.world{old_n}.manifest.json"
     ).write_text(json.dumps(man))
    return full_m


class TestElasticResume:
    def test_resume_from_larger_world(self, comm, tmp_path):
        full_m = _old_world(tmp_path, old_n=2, iteration=6)
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        loaded, it = cp.maybe_load()
        assert it == 6
        np.testing.assert_array_equal(loaded["w"], np.full((2, 2), 7.0))
        np.testing.assert_array_equal(loaded["m"], full_m)
        assert loaded["rank_tag"] == 0

    def test_newer_elastic_generation_beats_same_world(self, comm, tmp_path):
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save({"m": np.zeros(8, np.float32), "rank_tag": 0,
                 "w": np.full((2, 2), 1.0)}, iteration=3)
        cp.flush()
        _old_world(tmp_path, old_n=2, iteration=9)
        loaded, it = cp.maybe_load()
        assert it == 9
        np.testing.assert_array_equal(loaded["w"], np.full((2, 2), 7.0))

    def test_same_world_wins_when_newer(self, comm, tmp_path):
        _old_world(tmp_path, old_n=2, iteration=3)
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        cp.save({"m": np.zeros(8, np.float32), "rank_tag": 0,
                 "w": np.full((2, 2), 1.0)}, iteration=5)
        cp.flush()
        loaded, it = cp.maybe_load()
        assert it == 5
        np.testing.assert_array_equal(loaded["w"], np.full((2, 2), 1.0))

    def test_torn_old_world_shard_disqualifies_generation(self, comm,
                                                          tmp_path):
        _old_world(tmp_path, old_n=2, iteration=6)
        shard = tmp_path / "job.iter000000000006.proc1of2"
        shard.write_bytes(shard.read_bytes()[:10])
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        with pytest.raises(RuntimeError, match="restorable"):
            cp.maybe_load()

    def test_elastic_false_ignores_other_worlds(self, comm, tmp_path):
        _old_world(tmp_path, old_n=2, iteration=6)
        cp = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
        with pytest.raises(RuntimeError, match="world size"):
            cp.maybe_load(elastic=False)

    def test_gc_reaps_old_world_after_elastic_resume(self, comm, tmp_path):
        _old_world(tmp_path, old_n=2, iteration=6)
        cp = create_multi_node_checkpointer(
            "job", comm, gc_interval=1, path=str(tmp_path))
        assert cp.maybe_load()[1] == 6
        cp.save({"m": np.zeros(8, np.float32), "rank_tag": 0,
                 "w": np.full((2, 2), 1.0)}, iteration=7)
        cp.flush()
        left = sorted(os.listdir(tmp_path))
        assert not any("of2" in f or "world2" in f for f in left), left
        assert cp.maybe_load()[1] == 7


# ---- against the JAX package ----

STATES = {
    "nested": lambda it: {"params": {"w": np.full((3, 3), float(it)),
                                     "b": np.arange(3.0)},
                          "opt": [np.arange(4, dtype=np.float32) * it,
                                  (np.int32(it), None)],
                          "step": it, "name": "job"},
    "flat": lambda it: {"z": np.ones((2, 5), np.float16) * it,
                        "a": np.arange(6, dtype=np.int64).reshape(3, 2)},
}
LAYOUTS = {"nested": {"['params']['w']": ["sharded", 0],
                      "['opt'][0]": "per_rank"},
           "flat": {}}


@pytest.fixture(scope="module")
def jax_comm():
    return jmn.create_communicator("xla")


@pytest.mark.parametrize("kind", sorted(STATES))
def test_manifest_equals_jax_field_for_field(comm, jax_comm, tmp_path,
                                             kind):
    """The same numpy-only state through both checkpointers: every field
    of the two manifests is equal, the CRCs included (the shards are the
    same bytes)."""
    mans = {}
    for who, make in (("jax", jax_create), ("port",
                                            create_multi_node_checkpointer)):
        c = jax_comm if who == "jax" else comm
        cp = make("job", c, path=str(tmp_path / who),
                  layout=LAYOUTS[kind])
        cp.save(STATES[kind](4), iteration=4)
        cp.flush()
        mans[who] = json.loads(Path(cp._manifest_path(4)).read_text())
        mans[who + "_shard"] = Path(cp._filename(4)).read_bytes()
    assert set(mans["jax"]) == set(mans["port"])
    for key in mans["jax"]:
        assert mans["port"][key] == mans["jax"][key], key
    assert mans["port_shard"] == mans["jax_shard"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_generations_cross_load(comm, jax_comm, tmp_path, writer):
    """A generation written by one package resumes through the other's
    ``maybe_load`` to equal arrays."""
    make = {"jax": (jax_create, jax_comm),
            "port": (create_multi_node_checkpointer, comm)}
    reader = "port" if writer == "jax" else "jax"
    w_make, w_comm = make[writer]
    cp = w_make("job", w_comm, path=str(tmp_path))
    for it in (2, 5):
        cp.save(STATES["nested"](it), iteration=it)
    cp.flush()
    r_make, r_comm = make[reader]
    loaded, it = r_make("job", r_comm, path=str(tmp_path)).maybe_load()
    assert it == 5
    want = STATES["nested"](5)
    np.testing.assert_array_equal(loaded["params"]["w"], want["params"]["w"])
    np.testing.assert_array_equal(np.asarray(loaded["opt"][0]),
                                  want["opt"][0])
    assert loaded["step"] == 5 and loaded["name"] == "job"
    assert loaded["opt"][1][1] is None


# ---- the torch-specific contract ----

def test_snapshot_does_not_alias_live_state(comm, tmp_path):
    """save, mutate every leaf in place, flush, load: the saved values
    come back (``.cpu()`` of a CPU tensor is the tensor itself, so the
    snapshot must clone)."""
    t = torch.arange(6, dtype=torch.float32)
    a = np.arange(4.0)
    box = {"n": [1]}
    cp = create_multi_node_checkpointer("al", comm, path=str(tmp_path))
    cp.save({"t": t, "a": a, "box": box}, iteration=1)
    t.add_(100)
    a += 100
    box["n"].append(2)
    cp.flush()
    loaded, _ = cp.maybe_load()
    assert torch.equal(loaded["t"], torch.arange(6, dtype=torch.float32))
    np.testing.assert_array_equal(loaded["a"], np.arange(4.0))
    assert loaded["box"] == {"n": [1]}


def test_bf16_leaves_round_trip_bit_for_bit(comm, tmp_path):
    g = torch.Generator().manual_seed(0)
    t = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    cp = create_multi_node_checkpointer("bf", comm, path=str(tmp_path))
    cp.save({"t": t, "f16": t.to(torch.float16)}, iteration=1)
    cp.flush()
    man = json.loads(Path(cp._manifest_path(1)).read_text())
    dtypes = {leaf["path"]: leaf["dtype"] for leaf in man["leaves"]}
    assert dtypes == {"['f16']": "torch.float16", "['t']": "torch.bfloat16"}
    loaded, _ = cp.maybe_load()
    assert loaded["t"].dtype == torch.bfloat16
    assert torch.equal(loaded["t"].view(torch.int16), t.view(torch.int16))


@pytest.mark.parametrize("double_buffering", [False, True])
def test_trainer_state_resumes_the_same_trajectory(tmp_path,
                                                   double_buffering):
    """A Trainer saved at iteration 4 through ``MultiNodeCheckpointer``
    (the module, the optimizer's momentum and, double-buffered, the
    ``stale_grads``) and loaded into a model from another seed continues
    the uninterrupted run's losses bit for bit."""
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import MLP, cross_entropy_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_train_step
    from chainermn_tpu_torch.training import StandardUpdater, Trainer

    comm1 = create_communicator("xla", device="cpu")
    rng = np.random.RandomState(0)
    ds = list(zip(rng.randn(64, 6).astype(np.float32),
                  rng.randint(0, 3, 64).astype(np.int32)))

    def trainer_of(seed, stop):
        torch.manual_seed(seed)
        model = MLP(6, n_units=8, n_out=3)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm1,
            double_buffering=double_buffering)
        step = make_train_step(lambda m, b: cross_entropy_loss(m(b[0]),
                                                               b[1]),
                               opt, mesh=comm1.mesh)
        losses = []

        def step_fn(state, batch):
            loss = step(model, batch)
            losses.append(float(loss))
            return state, {"main/loss": loss}

        up = StandardUpdater(SerialIterator(ds, 8, shuffle=True, seed=1),
                             step_fn, (model, opt), mesh=comm1.mesh,
                             device="cpu")
        return Trainer(up, (stop, "iteration"), out=str(tmp_path)), losses

    try:
        full, want = trainer_of(0, 8)
        full.run()
        first, _ = trainer_of(0, 4)
        cp = create_multi_node_checkpointer("tr", comm1,
                                            path=str(tmp_path / "ck"))
        first.extend(cp, trigger=(4, "iteration"))
        first.run()       # clean completion: finalize deletes the shards,
        cp2 = create_multi_node_checkpointer(   # so save a copy first
            "tr2", comm1, path=str(tmp_path / "ck2"))
        cp2.save(first.checkpoint_state(), first.iteration)
        resumed, got = trainer_of(123, 8)
        state, it = cp2.maybe_load()
        assert it == 4
        resumed.load_checkpoint_state(state)
        model, opt = resumed.updater.state
        ref_model, ref_opt = first.updater.state
        for a, b in zip(model.state_dict().values(),
                        ref_model.state_dict().values()):
            assert torch.equal(a, b)
        if double_buffering:
            for a, b in zip(opt.state.stale_grads,
                            ref_opt.state.stale_grads):
                assert torch.equal(a, b)
        resumed.run()
        assert got == want[4:]
    finally:
        dist.destroy_process_group()


def test_world_2_generation_resumes_at_world_1(comm, tmp_path):
    """A world-2 generation saved over gloo (a bf16 leaf sharded on axis
    0, a numpy leaf sharded on axis 1, a replicated and a per-rank leaf)
    resumes through ``maybe_load`` at world 1: every sharded leaf whole,
    bit for bit."""
    rcs, logs, _ = worker.launch("gloo", tmp_path)
    assert rcs == [0, 0], "\n".join(logs)[-4000:]
    man = json.loads((tmp_path / "ck" / "elastic.iter000000000006.world2"
                      ".manifest.json").read_text())
    assert sorted(man["checksums"]) == ["0", "1"]
    shapes = {leaf["path"]: (leaf["shape"], leaf["dtype"])
              for leaf in man["leaves"]}
    assert shapes["['m']"] == ([8, 3], "torch.bfloat16")
    assert shapes["['v']"] == ([2, 8], "float32")
    cp = create_multi_node_checkpointer("elastic", comm,
                                        path=str(tmp_path / "ck"))
    loaded, it = cp.maybe_load()
    assert it == worker.CKPT_ITERS[-1]
    parts = [worker.ckpt_state(r, 2, it) for r in range(2)]
    assert torch.equal(loaded["m"], torch.cat([p["m"] for p in parts]))
    np.testing.assert_array_equal(
        loaded["v"], np.concatenate([p["v"] for p in parts], axis=1))
    np.testing.assert_array_equal(loaded["w"], parts[0]["w"])
    assert loaded["tag"] == 0
    # the lanes over the gloo group's FileStore, from the same run
    res = [pickle.loads((tmp_path / f"gloo{r}.pkl").read_bytes())
           for r in range(2)]
    assert res[0]["t1"] == res[1]["t1"] == {0: {"r": 0}, 1: {"r": 1}}
    assert res[0]["t2"] == {0: "only0"} and 0.5 <= res[0]["t2_s"] < 2.0
    assert res[0]["t3"] == {0: 0} and res[1]["t3"] == {1: 1}
    assert not res[0]["t1_left"] and not res[1]["t1_left"]
    for r in res:
        assert r["x"] == b"payload" and r["x_after_delete"] is None
        assert r["absent"].startswith("TimeoutError") and \
            "deadline exceeded" in r["absent"]
        assert r["lease_absent"] is None
