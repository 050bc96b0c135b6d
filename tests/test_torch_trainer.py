"""The port's Trainer stack vs the JAX package's, on the CPU.

* JAX's ``tests/test_training.py`` (13) and ``tests/test_iterators.py``
  (12) against the port: triggers, extension priority order,
  ``EvaluatorExtension`` → ``LogReport``, ``StepTimer``, the
  ``TorchProfiler`` window (JAX: ``JaxProfiler``), snapshot and resume
  giving the identical stream, prefetch giving the same batches and epoch
  bookkeeping as no prefetch, an assembly error re-raising in
  ``update()``, and the iterators; ``SerialIterator``'s orders equal JAX's
  for the same seed.
* Trajectories, fp32: ``python -m chainermn_tpu_torch.train``'s
  per-iteration ``main/loss`` / ``main/accuracy`` over 10 iterations and
  its final weights against JAX's ``make_demo_step`` on the JAX CLI's
  recipe, at world 1 (this process) and world 2 (two gloo processes,
  ``tests/_torch_trainer_worker.py``, against JAX on two virtual CPU
  devices); ``train_mnist``'s epoch losses and evaluator metrics against
  the JAX example's recipe at width 32 from the same flax weights, at
  world 1 and at world 2 (each rank on its shard; JAX's global batch joins
  the ranks' rows); ``make_train_step`` with ``grad_accum_steps`` 1, 2 and 4 and
  with ``grad_reduce`` against JAX's.  Losses rtol 1e-4, parameters atol
  1e-4, accuracy within one example.
* The multi-node evaluator at world 2: one call per owned shard per
  process, the combined metric the example-weighted mean over unequal
  shards; the observation aggregator and the multi-node / synchronized
  iterators at world 2.
* The CLIs on the CPU, and every refused flag failing through
  ``parser.error`` with its queue item named (the robustness flags, ported
  since, parse as given).
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import chainermn_tpu as mn
from chainermn_tpu.evaluators import bleu_evaluator as jax_bleu_evaluator
from chainermn_tpu.evaluators import corpus_bleu as jax_corpus_bleu
from chainermn_tpu.extensions.observation_aggregator import \
    aggregate_observations as jax_aggregate
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.models.mlp import accuracy as jax_accuracy
from chainermn_tpu.models.mlp import cross_entropy_loss as jax_ce
from chainermn_tpu.train import make_demo_step as jax_demo_step
from chainermn_tpu_torch import train, train_mnist
from chainermn_tpu_torch.communicators import (NaiveCommunicator,
                                               create_communicator)
from chainermn_tpu_torch.convert import mlp_from_jax, resnet_to_numpy
from chainermn_tpu_torch.evaluators import (accuracy_evaluator,
                                            bleu_evaluator, corpus_bleu,
                                            create_multi_node_evaluator)
from chainermn_tpu_torch.extensions import (ObservationAggregator,
                                            aggregate_observations)
from chainermn_tpu_torch.iterators import (SerialIterator,
                                           create_multi_node_iterator,
                                           create_synchronized_iterator)
from chainermn_tpu_torch.models import MLP, cross_entropy_loss
from chainermn_tpu_torch.ops import collective as col
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.train import make_train_step, shard_batch
from chainermn_tpu_torch.training import (IntervalTrigger, StandardUpdater,
                                          Trainer, extensions, make_extension)
from chainermn_tpu_torch.training.extensions import snapshot
from chainermn_tpu_torch.training.trainer import (PRIORITY_EDITOR,
                                                  PRIORITY_WRITER)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_trainer_worker import (DEMO_ARGS, MNIST_ARGS,  # noqa: E402
                                   N_VAL, val_set)


@pytest.fixture(scope="module")
def comm1():
    """A one-rank gloo group in this process, torn down after the module."""
    comm = create_communicator("xla", device="cpu")
    yield comm
    dist.destroy_process_group()


def make_dataset(n=64, d=4, classes=3, seed=0):
    w = np.random.RandomState(99).randn(d, classes).astype(np.float32)
    xs = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    ys = (xs @ w).argmax(-1).astype(np.int32)
    return list(zip(xs, ys))


def make_state(comm, seed=0):
    """A fresh (model, optimizer): the updater mutates them in place."""
    torch.manual_seed(seed)
    model = MLP(4, n_units=16, n_out=3)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    return model, opt


def make_step_fn(comm):
    def step_fn(state, batch):
        model, opt = state
        step = make_train_step(lambda m, b: cross_entropy_loss(m(b[0]), b[1]),
                               opt, mesh=comm.mesh)
        return state, {"main/loss": step(model, batch)}
    return step_fn


def make_trainer(comm, n_epochs=3, out="result", batch=16, ds=None,
                 state=None):
    it = SerialIterator(ds or make_dataset(), batch, shuffle=True, seed=1)
    updater = StandardUpdater(it, make_step_fn(comm),
                              state or make_state(comm), mesh=comm.mesh,
                              device="cpu")
    return Trainer(updater, (n_epochs, "epoch"), out=out)


# ---- JAX's tests/test_training.py ----

class TestIntervalTrigger:
    def test_iteration_trigger(self):
        class T:
            iteration = 0
        trig = IntervalTrigger(3, "iteration")
        fired = []
        for i in range(1, 10):
            T.iteration = i
            fired.append(trig(T))
        assert fired == [False, False, True] * 3

    def test_epoch_trigger_fractional(self):
        class T:
            epoch_detail = 0.0
        trig = IntervalTrigger(1, "epoch")
        fired = []
        for d in (0.5, 1.0, 1.5, 1.75, 2.25):
            T.epoch_detail = d
            fired.append(trig(T))
        assert fired == [False, True, False, False, True]


class TestTrainerLoop:
    def test_runs_to_stop_trigger_and_learns(self, comm1, tmp_path):
        trainer = make_trainer(comm1, n_epochs=3, out=str(tmp_path))
        log = extensions.LogReport(trigger=(1, "epoch"))
        trainer.extend(log)
        trainer.extend(extensions.PrintReport(
            ["epoch", "main/loss"], log), trigger=(1, "epoch"))
        trainer.run()
        assert trainer.epoch == 3
        assert len(log.log) == 3
        assert log.log[-1]["main/loss"] < log.log[0]["main/loss"]
        written = json.load(open(os.path.join(str(tmp_path), "log")))
        assert written[-1]["epoch"] == 3

    def test_extension_priority_order(self, comm1, tmp_path):
        trainer = make_trainer(comm1, n_epochs=1, out=str(tmp_path))
        calls = []

        @make_extension(trigger=(1, "iteration"), priority=PRIORITY_EDITOR)
        def editor(t):
            calls.append("editor")

        @make_extension(trigger=(1, "iteration"), priority=PRIORITY_WRITER)
        def writer(t):
            calls.append("writer")

        trainer.extend(writer)   # registered out of order on purpose
        trainer.extend(editor)
        trainer.run()
        assert calls[0] == "editor" and calls[1] == "writer"

    def test_evaluator_extension_feeds_log(self, comm1, tmp_path):
        trainer = make_trainer(comm1, n_epochs=2, out=str(tmp_path))
        log = extensions.LogReport(trigger=(1, "epoch"))
        trainer.extend(extensions.EvaluatorExtension(
            lambda _: {"accuracy": 0.5}, None, trigger=(1, "epoch")))
        trainer.extend(log)
        trainer.run()
        assert log.log[-1]["validation/accuracy"] == pytest.approx(0.5)

    def test_observation_aggregator_slots_in(self, comm1, tmp_path):
        trainer = make_trainer(comm1, n_epochs=1, out=str(tmp_path))
        trainer.extend(ObservationAggregator(comm1),
                       trigger=(1, "iteration"), priority=PRIORITY_EDITOR)
        trainer.run()
        assert isinstance(trainer.observation["main/loss"], float)


class TestProfiling:
    def test_step_timer_feeds_log(self, comm1, tmp_path):
        trainer = make_trainer(comm1, n_epochs=2, out=str(tmp_path))
        log = extensions.LogReport(trigger=(1, "epoch"))
        trainer.extend(extensions.StepTimer())
        trainer.extend(log)
        trainer.run()
        assert log.log[-1]["time/step"] > 0

    def test_torch_profiler_writes_trace(self, comm1, tmp_path):
        trainer = make_trainer(comm1, n_epochs=1, out=str(tmp_path))
        logdir = str(tmp_path / "profile")
        prof = extensions.TorchProfiler(logdir=logdir, start=2, stop=4)
        trainer.extend(prof)
        trainer.run()
        traces = [f for _, _, fs in os.walk(logdir) for f in fs]
        assert any("trace" in f for f in traces), traces
        doc = json.load(open(prof.trace_path))
        # the window [2, 4) held iterations 2 and 3: three Linears each
        assert sum(e.get("name") == "aten::linear"
                   for e in doc["traceEvents"]) == 2 * 3

    def test_torch_profiler_rejects_empty_window(self):
        with pytest.raises(ValueError):
            extensions.TorchProfiler(start=3, stop=3)


class _MemoryCheckpointer:
    """A checkpointer for ``snapshot``: keeps the trainer's state."""

    trigger = (1, "epoch")

    def __init__(self):
        self.saved = None

    def __call__(self, trainer):
        self.saved = (trainer.checkpoint_state(), trainer.iteration)


class TestTrainerResume:
    def test_snapshot_and_resume_identical_stream(self, comm1, tmp_path):
        ds = make_dataset(48)
        t_full = make_trainer(comm1, n_epochs=2, out=str(tmp_path / "a"),
                              ds=ds)
        log_full = extensions.LogReport(trigger=(1, "epoch"))
        t_full.extend(log_full)
        t_full.run()

        cp = _MemoryCheckpointer()
        t1 = make_trainer(comm1, n_epochs=1, out=str(tmp_path / "b"), ds=ds)
        t1.extend(extensions.LogReport(trigger=(1, "epoch")))
        t1.extend(snapshot(cp))
        t1.run()

        # a FRESH trainer from other weights and another iterator position
        t2 = make_trainer(comm1, n_epochs=2, out=str(tmp_path / "c"), ds=ds,
                          state=make_state(comm1, seed=5))
        t2.updater.iterator.next()
        log2 = extensions.LogReport(trigger=(1, "epoch"))
        t2.extend(log2)
        state, it = cp.saved
        assert it == t1.iteration
        t2.load_checkpoint_state(state)
        assert t2.iteration == t1.iteration
        t2.run()
        assert log2.log[-1]["main/loss"] == pytest.approx(
            log_full.log[-1]["main/loss"], rel=1e-6)
        for a, b in zip(t_full.updater.state[0].parameters(),
                        t2.updater.state[0].parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


class TestPrefetchUpdater:
    def _updater(self, prefetch, seen):
        def step_fn(state, batch):
            x, y = batch
            seen.append(float(np.asarray(x).sum()))
            return state + 1, {"n": state}

        return StandardUpdater(SerialIterator(make_dataset(48), 8, seed=3),
                               step_fn, 0, shard=False, prefetch=prefetch,
                               device="cpu")

    def test_same_batch_stream_and_epoch_bookkeeping(self):
        seen_sync, seen_pre = [], []
        upd_s = self._updater(False, seen_sync)
        upd_p = self._updater(True, seen_pre)
        marks_s, marks_p = [], []
        for _ in range(13):  # 6 steps/epoch: crosses two epoch turns
            upd_s.update()
            upd_p.update()
            marks_s.append((upd_s.epoch, upd_s.is_new_epoch,
                            upd_s.epoch_detail))
            marks_p.append((upd_p.epoch, upd_p.is_new_epoch,
                            upd_p.epoch_detail))
        upd_p.close()
        assert seen_pre == seen_sync
        assert marks_p == marks_s

    def test_state_dict_is_consumed_batch_snapshot(self):
        upd_s = self._updater(False, [])
        upd_p = self._updater(True, [])
        for _ in range(4):
            upd_s.update()
            upd_p.update()
        sd_s, sd_p = upd_s.state_dict(), upd_p.state_dict()
        upd_p.close()
        ds = make_dataset(48)
        it_s = SerialIterator(ds, 8, seed=3)
        it_p = SerialIterator(ds, 8, seed=3)
        it_s.load_state_dict(sd_s["iterator"])
        it_p.load_state_dict(sd_p["iterator"])
        for _ in range(3):
            bs, bp = it_s.next(), it_p.next()
            np.testing.assert_array_equal(
                np.stack([x for x, _ in bs]), np.stack([x for x, _ in bp]))

    def test_assembly_error_reraises_in_update(self):
        class Boom:
            def __init__(self):
                self.n = 0

            def next(self):
                self.n += 1
                if self.n > 2:
                    raise RuntimeError("converter exploded")
                return [(np.zeros(3, np.float32), np.int32(0))]

        upd = StandardUpdater(Boom(), lambda s, b: (s, {}), 0, shard=False,
                              prefetch=True, device="cpu")
        upd.update()
        upd.update()
        with pytest.raises(RuntimeError, match="converter exploded"):
            upd.update()
        with pytest.raises(RuntimeError, match="converter exploded"):
            upd.update()   # latched, not a hang
        upd.close()

    def test_shard_gives_this_ranks_rows_on_the_device(self, comm1):
        got = []
        upd = StandardUpdater(SerialIterator(make_dataset(16), 8, seed=0),
                              lambda s, b: (got.append(b) or s, {}), None,
                              mesh=comm1.mesh, prefetch=True, device="cpu")
        upd.update()
        upd.close()
        want = shard_batch(tuple(np.stack(c) for c in zip(
            *SerialIterator(make_dataset(16), 8, seed=0).next())), "cpu",
            comm1.mesh)
        for a, b in zip(got[0], want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert upd.last_batch_size == 8


# ---- JAX's tests/test_iterators.py ----

def make_items(n=23):
    return [(np.float32(i), np.int32(i % 3)) for i in range(n)]


class TestSerialIterator:
    def test_covers_epoch_without_shuffle(self):
        it = SerialIterator(make_items(10), 5, shuffle=False)
        b1, b2 = it.next(), it.next()
        assert [x[0] for x in b1] == [0, 1, 2, 3, 4]
        assert [x[0] for x in b2] == [5, 6, 7, 8, 9]
        assert it.epoch == 1 and it.is_new_epoch

    def test_shuffle_covers_all(self):
        it = SerialIterator(make_items(12), 4, shuffle=True, seed=0)
        seen = [x[0] for _ in range(3) for x in it.next()]
        assert sorted(seen) == list(range(12))

    def test_ragged_tail_padded_from_next_epoch(self):
        it = SerialIterator(make_items(10), 4, shuffle=False)
        it.next()
        it.next()
        assert len(it.next()) == 4
        assert it.epoch == 1 and it.current_position == 2

    def test_no_repeat_stops(self):
        it = SerialIterator(make_items(6), 4, repeat=False, shuffle=False)
        assert len(it.next()) == 4
        assert len(it.next()) == 2
        with pytest.raises(StopIteration):
            it.next()

    def test_epoch_detail(self):
        it = SerialIterator(make_items(10), 5, shuffle=False)
        assert it.epoch_detail == 0.0
        it.next()
        assert it.epoch_detail == 0.5

    def test_state_roundtrip_resumes_same_stream(self):
        ds = make_items(20)
        it = SerialIterator(ds, 3, shuffle=True, seed=7)
        for _ in range(4):
            it.next()
        state = it.state_dict()
        expect = [it.next() for _ in range(5)]
        it2 = SerialIterator(ds, 3, shuffle=True, seed=123)
        it2.load_state_dict(state)
        for a, b in zip(expect, [it2.next() for _ in range(5)]):
            assert [x[0] for x in a] == [x[0] for x in b]

    def test_reset(self):
        it = SerialIterator(make_items(8), 4, shuffle=True, seed=3)
        first = [x[0] for x in it.next()]
        it.next()
        it.reset()
        assert it.epoch == 0 and it.current_position == 0
        assert [x[0] for x in it.next()] == first

    @pytest.mark.parametrize("n,batch,repeat,shuffle", [
        (23, 5, True, True), (10, 4, True, False), (4, 10, True, True),
        (6, 4, False, True)])
    def test_orders_equal_jax_for_the_same_seed(self, n, batch, repeat,
                                                shuffle):
        ours = SerialIterator(make_items(n), batch, repeat, shuffle, seed=4)
        ref = JaxSerialIterator(make_items(n), batch, repeat, shuffle, seed=4)
        for _ in range(12):
            try:
                want = [x[0] for x in ref.next()]
            except StopIteration:
                with pytest.raises(StopIteration):
                    ours.next()
                break
            assert [x[0] for x in ours.next()] == want
            assert (ours.epoch, ours.is_new_epoch, ours.epoch_detail) == \
                (ref.epoch, ref.is_new_epoch, ref.epoch_detail)


class TestMultiNodeIterator:
    def test_replicates_master_stream(self, comm1):
        ds = make_items(12)
        base = SerialIterator(ds, 4, shuffle=True, seed=1)
        oracle = SerialIterator(ds, 4, shuffle=True, seed=1)
        it = create_multi_node_iterator(base, comm1, rank_master=0)
        for _ in range(6):
            assert [x[0] for x in it.next()] == [x[0] for x in oracle.next()]
        assert it.epoch == base.epoch

    def test_stop_iteration_propagates(self, comm1):
        it = create_multi_node_iterator(
            SerialIterator(make_items(4), 4, repeat=False, shuffle=False),
            comm1)
        it.next()
        with pytest.raises(StopIteration):
            it.next()


class _FakeTwoProcessComm:
    """The first caller plays root; its payload goes to every caller."""

    def __init__(self):
        self._root_payload = None

    def bcast_obj(self, obj, root=0):
        if self._root_payload is None:
            self._root_payload = obj
        return pickle.loads(pickle.dumps(self._root_payload))


class TestSynchronizedIterator:
    def test_same_order_after_sync_across_processes(self):
        fake = _FakeTwoProcessComm()
        its = [create_synchronized_iterator(
            SerialIterator(make_items(16), 4, shuffle=True, seed=seed), fake)
            for seed in (11, 22)]
        for _ in range(8):
            batches = [[x[0] for x in it.next()] for it in its]
            assert batches[0] == batches[1]

    def test_single_process_passthrough(self, comm1):
        it = create_synchronized_iterator(
            SerialIterator(make_items(16), 4, shuffle=True, seed=5), comm1)
        oracle = SerialIterator(make_items(16), 4, shuffle=True, seed=5)
        assert [x[0] for x in it.next()] == [x[0] for x in oracle.next()]


class TestSerialIteratorSmallDataset:
    def test_batch_larger_than_dataset_keeps_shape(self):
        it = SerialIterator(make_items(4), 10, shuffle=False)
        for _ in range(5):
            assert len(it.next()) == 10
        assert 0 <= it.current_position < 4
        assert it.epoch >= 5


# ---- trajectories against JAX ----

def _jax_demo_run(world, steps=10, batchsize=64, hidden=64, lr=1e-2,
                  n_train=512):
    """JAX's demo recipe (``chainermn_tpu/train.py :: main``) through its
    ``make_demo_step`` over ``world`` virtual devices: per-iteration
    (loss, accuracy) and the final params."""
    in_dim, n_classes = 32, 10
    w_true = np.random.RandomState(42).randn(in_dim, n_classes)
    xs = np.random.RandomState(0).randn(n_train, in_dim).astype(np.float32)
    ys = (xs @ w_true).argmax(-1).astype(np.int32)
    rng = np.random.RandomState(1)
    params = {
        "w1": (rng.randn(in_dim, hidden) / np.sqrt(in_dim)).astype(np.float32),
        "b1": np.zeros((hidden,), np.float32),
        "w2": (rng.randn(hidden, n_classes) / np.sqrt(hidden)
               ).astype(np.float32),
        "b2": np.zeros((n_classes,), np.float32),
    }
    mesh = Mesh(np.array(jax.devices()[:world]), ("mn",))
    optimizer = optax.sgd(lr, momentum=0.9)
    step = jax_demo_step(optimizer, mesh=mesh)
    state = mn.replicate((params, optimizer.init(params)), mesh)
    it = JaxSerialIterator(list(zip(xs, ys)), batchsize, seed=0)
    losses, accs = [], []
    for _ in range(steps):
        batch = it.next()
        placed = mn.shard_batch((np.stack([x for x, _ in batch]),
                                 np.stack([y for _, y in batch])), mesh)
        state, obs = step(state, placed)
        losses.append(float(obs["main/loss"]))
        accs.append(float(obs["main/accuracy"]))
    return losses, accs, jax.tree_util.tree_map(np.asarray, state[0])


@pytest.fixture(scope="module")
def jax_demo():
    return {world: _jax_demo_run(world) for world in (1, 2)}


def _assert_demo(losses, accs, params, want):
    w_losses, w_accs, w_params = want
    np.testing.assert_allclose(losses, w_losses, rtol=1e-4)
    np.testing.assert_allclose(accs, w_accs, atol=1.5 / 64)
    for k, v in w_params.items():
        np.testing.assert_allclose(params[k], v, atol=1e-4, err_msg=k)


def test_demo_cli_world_1_matches_jax(comm1, jax_demo, tmp_path):
    result, trainer = train.run(DEMO_ARGS + ["--out", str(tmp_path)])
    log = trainer.get_extension("LogReport").log
    params = {k: v.detach().numpy() for k, v in
              trainer.updater.state[0].items()}
    _assert_demo([e["main/loss"] for e in log],
                 [e["main/accuracy"] for e in log], params, jax_demo[1])
    assert result["steps"] == 10 and result["world"] == 1
    assert result["final_loss"] == log[-1]["main/loss"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_mnist):
    tmp = tmp_path_factory.mktemp("trainer2")
    init = jax_mnist[2][2]["params"]
    np.savez(tmp / "mlp.npz", **{f"{k}/{leaf}": v[leaf] for k, v in
                                 init.items() for leaf in ("kernel", "bias")})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_trainer_worker.py"),
         str(r), "2", str(tmp / "store"), str(tmp)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    outs = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def test_demo_cli_world_2_gloo_matches_jax(world2, jax_demo):
    for out in world2:
        demo = out["demo"]
        _assert_demo(demo["loss"], demo["accuracy"], demo["params"],
                     jax_demo[2])
        assert demo["result"]["world"] == 2
    for k in world2[0]["demo"]["params"]:    # the replicas stayed equal
        np.testing.assert_array_equal(world2[0]["demo"]["params"][k],
                                      world2[1]["demo"]["params"][k])


def test_world_2_evaluator_evaluates_each_shard_once(world2):
    xs = np.asarray([x for x, _ in val_set()])
    calls = [c for out in world2 for c in out["evaluator"]["calls"]]
    assert [len(out["evaluator"]["calls"]) for out in world2] == [1, 1]
    assert sorted(x for c in calls for x in c) == sorted(xs.tolist())
    assert sorted(len(c) for c in calls) == [3, 4]     # unequal shards
    for out in world2:   # the example-weighted mean of the two shards
        m = out["evaluator"]["metrics"]
        assert m["mean_x"] == pytest.approx(xs.mean(), rel=1e-12)
        assert m["n"] == pytest.approx((4 * 4 + 3 * 3) / N_VAL)


def test_world_2_aggregator_and_iterators(world2):
    class _Two:
        """What the two ranks report, as JAX's aggregator gathers it."""

        def allgather_obj(self, obj):
            return [{"loss": 1.0, "vec": np.array([0, 2.0]),
                     "status": "rank 0"},
                    {"loss": 2.0, "vec": np.array([1, 2.0]),
                     "status": "rank 1"}]

    expected = jax_aggregate({}, _Two())
    ds = make_items(12)
    master = SerialIterator(ds, 4, shuffle=True, seed=1)
    stream = [[float(x) for x, _ in master.next()] for _ in range(5)]
    for out in world2:
        agg = out["aggregate"]
        assert agg["loss"] == expected["loss"] == 1.5
        np.testing.assert_array_equal(agg["vec"], expected["vec"])
        assert agg["status"] == expected["status"] == "rank 0"
        assert out["multi_node"] == stream
        assert out["synchronized"] == world2[0]["synchronized"]
    assert world2[0]["multi_node_epoch"] == world2[1]["multi_node_epoch"]


MNIST = MNIST_ARGS


def _synthetic(n, seed):
    """``examples/mnist/train_mnist.py :: make_synthetic_mnist``."""
    w_true = np.random.RandomState(42).randn(784, 10).astype(np.float32)
    xs = np.random.RandomState(seed).randn(n, 784).astype(np.float32)
    return list(zip(xs, (xs @ w_true).argmax(-1).astype(np.int32)))


def _jax_mnist_recipe(world):
    """The JAX example's loop at ``world`` ranks (virtual devices): per-step
    loss / accuracy, the evaluator's metrics, and the initial flax params.
    Each step's global batch joins every rank's rows, as the example's."""
    comm = mn.create_communicator("xla", size=world)
    train_set = _synthetic(MNIST["n_train"], 0)
    val = _synthetic(MNIST["n_val"], 1)
    scattered = mn.scatter_dataset(train_set, comm, shuffle=True, seed=0)
    model = JaxMLP(n_units=MNIST["unit"])
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)))
    init = jax.tree_util.tree_map(np.asarray, params)
    optimizer = mn.create_multi_node_optimizer(optax.adam(MNIST["lr"]), comm)

    def loss_fn(p, batch):
        logits = model.apply(p, batch[0])
        return jax_ce(logits, batch[1]), jax_accuracy(logits, batch[1])

    step = mn.make_train_step(loss_fn, optimizer, mesh=comm.mesh,
                              has_aux=True, donate=False)
    opt_state = optimizer.init(params)
    b = MNIST["batchsize"]
    per_epoch = []
    for _ in range(MNIST["epoch"]):
        losses, accs = [], []
        for it in range(len(scattered.shard(0)) // b):
            items = [scattered.shard(r)[(it * b + j) % len(scattered.shard(r))]
                     for r in range(world) for j in range(b)]
            batch = mn.shard_batch((np.stack([x for x, _ in items]),
                                    np.asarray([y for _, y in items])),
                                   comm.mesh)
            params, opt_state, loss, acc = step(params, opt_state, batch)
            losses.append(float(loss))
            accs.append(float(acc))
        per_epoch.append((losses, accs))
    evaluator = mn.create_multi_node_evaluator(mn.accuracy_evaluator(
        lambda xs: model.apply(params, jnp.asarray(xs))), comm)
    metrics = evaluator(mn.scatter_dataset(val, comm,
                                           force_equal_length=False))
    return per_epoch, metrics, init


@pytest.fixture(scope="module")
def jax_mnist():
    return {world: _jax_mnist_recipe(world) for world in (1, 2)}


def _assert_mnist(result, want, world):
    per_epoch, metrics, _ = want
    assert result["iterations"] == MNIST["epoch"] * MNIST["n_train"] \
        // (MNIST["batchsize"] * world)
    assert result["world"] == world
    np.testing.assert_allclose(result["epoch_losses"],
                               [np.mean(ls) for ls, _ in per_epoch],
                               rtol=1e-4)
    np.testing.assert_allclose(result["epoch_accuracies"],
                               [np.mean(a) for _, a in per_epoch],
                               atol=1.5 / MNIST["n_train"])
    assert abs(result["validation/accuracy"]
               - metrics["validation/accuracy"]) <= 1 / MNIST["n_val"]
    np.testing.assert_allclose(result["validation/loss"],
                               metrics["validation/loss"], rtol=1e-4)
    assert result["epoch_losses"][-1] < result["epoch_losses"][0]


def test_train_mnist_world_2_gloo_matches_the_jax_example(world2, jax_mnist):
    for out in world2:
        _assert_mnist(out["mnist"], jax_mnist[2], 2)


def test_train_mnist_world_1_matches_the_jax_example(comm1, tmp_path,
                                                      jax_mnist):
    init = jax_mnist[1][2]
    argv = ["--device", "cpu", "--out", str(tmp_path)] + [
        f"--{k.replace('_', '-')}={v}" for k, v in MNIST.items()]
    result, _ = train_mnist.run(argv, params=init["params"])
    _assert_mnist(result, jax_mnist[1], 1)


def _accum_setup():
    rng = np.random.RandomState(3)
    x = rng.randn(8, 3, 4).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.int32)
    jm = JaxMLP(n_units=16, n_out=5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 4)))["params"])
    return x, y, jm, params


def _jax_accum_run(grad_accum_steps, grad_reduce=None, steps=3):
    x, y, jm, params = _accum_setup()
    comm = mn.create_communicator("xla", size=1)
    opt = mn.create_multi_node_optimizer(optax.sgd(0.1, momentum=0.9), comm)

    def loss_fn(p, b):
        logits = jm.apply({"params": p}, b[0])
        return jax_ce(logits, b[1]), {"acc": jax_accuracy(logits, b[1])}

    step = mn.make_train_step(loss_fn, opt, mesh=comm.mesh, has_aux=True,
                              donate=False, grad_accum_steps=grad_accum_steps,
                              grad_reduce=grad_reduce)
    state, out = opt.init(params), []
    batch = mn.shard_batch((x, y), comm.mesh)
    for _ in range(steps):
        params, state, loss, aux = step(params, state, batch)
        out.append((float(loss), float(aux["acc"])))
    return out, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_grad_accum_steps_match_jax(comm1, accum):
    want, want_params = _jax_accum_run(accum)
    x, y, _, params = _accum_setup()
    model = mlp_from_jax(params, MLP(12, n_units=16, n_out=5))
    step = make_train_step(
        lambda m, b: (cross_entropy_loss(m(b[0]), b[1]),
                      {"acc": (m(b[0]).argmax(-1) == b[1].long())
                       .float().mean()}),
        create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            comm1), mesh=comm1.mesh, has_aux=True, grad_accum_steps=accum)
    batch = shard_batch((x, y), "cpu", comm1.mesh)
    got = []
    for _ in range(3):
        loss, aux = step(model, batch)
        got.append((float(loss), float(aux["acc"])))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for k, v in resnet_to_numpy(model)["params"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(v[leaf], want_params[k][leaf],
                                       atol=1e-4, err_msg=f"{k}/{leaf}")


def test_grad_reduce_matches_jax(comm1):
    from chainermn_tpu.ops import collective as jcol

    want, want_params = _jax_accum_run(1, grad_reduce=lambda g: jcol.pmean(g))
    x, y, _, params = _accum_setup()
    model = mlp_from_jax(params, MLP(12, n_units=16, n_out=5))
    seen = []

    def reduce(grads):
        seen.append(len(grads))
        return [col.pmean(g, comm1.mesh) for g in grads]

    step = make_train_step(
        lambda m, b: (cross_entropy_loss(m(b[0]), b[1]), {}),
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        mesh=comm1.mesh, has_aux=True, grad_reduce=reduce)
    batch = shard_batch((x, y), "cpu", comm1.mesh)
    got = [float(step(model, batch)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, [w[0] for w in want], rtol=1e-4)
    assert seen == [6, 6, 6]
    for k, v in resnet_to_numpy(model)["params"].items():
        np.testing.assert_allclose(v["kernel"], want_params[k]["kernel"],
                                   atol=1e-4)


def test_grad_accum_refuses_what_jax_refuses(comm1):
    model = MLP(4, n_units=8, n_out=3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = lambda m, b: cross_entropy_loss(m(b[0]), b[1])  # noqa: E731
    step = make_train_step(loss, opt, mesh=comm1.mesh, grad_accum_steps=3)
    batch = (torch.zeros(8, 4), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps"):
        step(model, batch)
    with pytest.raises(ValueError, match=">= 1"):
        make_train_step(loss, opt, grad_accum_steps=0)
    with pytest.raises(ValueError, match="exclusive"):
        make_train_step(loss, opt, error_feedback=True,
                        grad_reduce=lambda g: g)


# ---- evaluators at world 1 ----

def test_evaluators_match_jax_with_naive():
    data = _synthetic(50, 2)
    w = np.random.RandomState(3).randn(784, 10).astype(np.float32)
    predict = lambda xs: xs @ w  # noqa: E731
    for size in (1, 3):
        ours = create_multi_node_evaluator(
            accuracy_evaluator(lambda xs: torch.from_numpy(predict(xs)),
                               batch_size=16), NaiveCommunicator(size=size))
        ref = mn.create_multi_node_evaluator(
            mn.accuracy_evaluator(predict, batch_size=16),
            mn.create_communicator("naive", size=size))
        from chainermn_tpu_torch.datasets import scatter_dataset
        got = ours(scatter_dataset(data, NaiveCommunicator(size=size),
                                   force_equal_length=False))
        want = ref(mn.scatter_dataset(
            data, mn.create_communicator("naive", size=size),
            force_equal_length=False))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6)


def test_bleu_matches_jax():
    rng = np.random.RandomState(0)
    refs = [list(rng.randint(0, 6, rng.randint(3, 9))) for _ in range(12)]
    hyps = [list(np.where(rng.rand(len(r)) < 0.7, r, 0)) for r in refs]
    for smooth in (True, False):
        assert corpus_bleu(refs, hyps, smooth=smooth) == \
            jax_corpus_bleu(refs, hyps, smooth=smooth)
    pairs = list(zip(refs, refs))
    translate = lambda srcs: [h for h in hyps[:len(srcs)]]  # noqa: E731
    got = bleu_evaluator(translate, NaiveCommunicator(size=1))([pairs])
    want = jax_bleu_evaluator(translate, mn.create_communicator(
        "naive", size=1))([pairs])
    assert got == want
    with pytest.raises(ValueError):
        corpus_bleu(refs, hyps[:-1])


def test_aggregate_observations_world_1_matches_jax(comm1):
    obs = {"loss": torch.tensor(2.5), "vec": np.array([1.0, 3.0]),
           "note": "hello"}
    got = aggregate_observations(obs, comm1)
    want = jax_aggregate({"loss": 2.5, "vec": np.array([1.0, 3.0]),
                          "note": "hello"},
                         mn.create_communicator("naive", size=1))
    assert got["loss"] == want["loss"] and got["note"] == want["note"]
    np.testing.assert_array_equal(got["vec"], want["vec"])


# ---- the CLIs ----

def test_demo_cli_main_prints_the_jax_keys(comm1, tmp_path, capsys):
    trace = tmp_path / "trace.json"
    assert train.main(["--device", "cpu", "--steps", "4", "--log-every",
                       "2", "--out", str(tmp_path), "--trace-out",
                       str(trace)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"steps", "world", "final_loss", "final_accuracy",
                           "trace_out", "trace_events"}
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert {"step", "step/data", "step/compute", "step/extensions"} <= names


def test_train_mnist_main_runs(comm1, tmp_path, capsys):
    assert train_mnist.main(["--device", "cpu", "--unit", "16", "--n-train",
                             "256", "--n-val", "64", "--epoch", "1",
                             "--double-buffering", "--prefetch", "--out",
                             str(tmp_path)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["iterations"] == 2 and result["epochs"] == 1
    assert 0 <= result["validation/accuracy"] <= 1


# (flag, value, the queue item that still refuses it: None once ported)
REFUSED = [("--metrics-out", "m.jsonl", "A12"), ("--statusz-port", "0", "A12"),
           ("--flight-dump-dir", "d", None), ("--checkpoint-dir", "c", None),
           ("--checkpoint-every", "3", None),
           ("--preemption-grace-s", "5", None), ("--self-heal", None, None),
           ("--self-heal-min-world", "2", None),
           ("--self-heal-beat-s", "0.1", None),
           ("--watchdog-timeout", "60", None)]


@pytest.mark.parametrize("flag,value,item", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_demo_cli_refuses_unported_flags(flag, value, item, capsys):
    """A flag whose machinery is not ported exits 2 naming its queue
    item; a ported one (the robustness flags) is parsed as given."""
    argv = ["--device", "cpu", flag] + ([value] if value else [])
    if item is None:
        args = train._parse(argv)
        got = getattr(args, flag[2:].replace("-", "_"))
        if value is None:
            assert got is True
        else:
            assert str(got) == value or float(got) == float(value)
        return
    with pytest.raises(SystemExit) as exc:
        train.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and f"queue A, {item}" in err


def test_train_mnist_refuses_the_naive_communicator(capsys):
    with pytest.raises(SystemExit):
        train_mnist.main(["--device", "cpu", "--communicator", "naive"])
    assert "numpy oracle" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cli_entry_points_raise_without_a_card():
    for main in (train.main, train_mnist.main):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main([])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        StandardUpdater(SerialIterator(make_items(4), 2), None, None,
                        shard=False)


@pytest.mark.parametrize("double_buffering", [False, True])
def test_multi_node_optimizer_state_dict_resumes_the_trajectory(
        comm1, double_buffering):
    """Two steps, a snapshot, two more; a fresh optimizer loaded from the
    snapshot repeats the last two exactly (Adam moments and, double
    buffered, the stale mean gradients)."""
    rng = np.random.RandomState(0)
    grads = [torch.from_numpy(rng.randn(3, 2).astype(np.float32))
             for _ in range(4)]

    def make(p):
        return create_multi_node_optimizer(torch.optim.Adam([p], lr=0.1),
                                           comm1, double_buffering)

    p = torch.zeros(3, 2, requires_grad=True)
    opt = make(p)
    for g in grads[:2]:
        p.grad = g.clone()
        opt.step()
    snap = StandardUpdater(None, None, (p, opt), shard=False,
                           device="cpu").state_dict()["state"]
    for g in grads[2:]:
        p.grad = g.clone()
        opt.step()
    q = torch.full((3, 2), 7.0, requires_grad=True)
    other = make(q)
    upd = StandardUpdater(None, None, (q, other), shard=False, device="cpu")
    upd.load_state_dict({"iteration": 2, "state": snap})
    assert upd.state[0] is q and upd.state[1] is other
    for g in grads[2:]:
        q.grad = g.clone()
        other.step()
    torch.testing.assert_close(q, p, rtol=0, atol=0)
