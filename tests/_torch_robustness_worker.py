"""One rank of the port's robustness tests at world 2 over gloo.

Run as ``python tests/_torch_robustness_worker.py MODE RANK WORLD
STORE_FILE OUT_DIR [ARGS...]``.  Joins a gloo group through a
``FileStore`` (no port) and runs ``MODE``:

* ``gloo`` — the object lanes over the group's store
  (``allgather_obj_eventual`` with a peer that skips a tag,
  ``kv_lane_transport``, ``gang_lease_store`` absence), a world-2
  checkpoint (a sharded bf16 leaf, a sharded fp32 numpy leaf, a
  replicated leaf and a ``per_rank`` one) and ``reshard`` for every
  (src, dst) pair of the docstring's table; pickles its results to
  ``OUT_DIR/gloo<rank>.pkl``;
* ``guard`` — a ``SelfHealingGang`` over ``comm.gang_lease_store()``;
  rank 1 stops publishing, rank 0 sees it stale, installs the collective
  guard (1 s) and enters an all-reduce rank 1 never joins: the guard must
  name rank 1 and exit 44;
* ``except`` — both ranks install the global except hook; rank 1 raises:
  it must exit 1, loudly, within the hook's bounds;
* ``mnist`` — ``train_mnist_checkpoint.run(ARGS)`` from the flax weights
  in ``OUT_DIR/mlp.npz``, the result written to
  ``OUT_DIR/mnist<rank>.json`` (``--kill-at-epoch`` exits 99 first).

Imports no JAX.
"""

import json
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.topology import init_distributed

# the reshard cases: (src, dst) over a (4, 6) fp32 logical array
RESHARD_PAIRS = [(None, None), (None, 0), (None, 1), (0, None), (1, None),
                 (0, 0), (0, 1), (1, 0)]
RESHARD_SHAPE = (4, 6)
CKPT_ITERS = (3, 6)


def logical(shape=RESHARD_SHAPE):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape) * 0.5


def block_of(full, spec, rank, world):
    if spec is None:
        return full
    n = full.shape[spec] // world
    idx = [slice(None)] * full.ndim
    idx[spec] = slice(rank * n, (rank + 1) * n)
    return full[tuple(idx)]


def ckpt_state(rank, world, it):
    """A world-``world`` shard: ``m`` (bf16, sharded on axis 0), ``v``
    (numpy fp32, sharded on axis 1), ``w`` replicated, ``tag`` per rank."""
    m = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) / 7 + it
    v = np.arange(2 * 8, dtype=np.float32).reshape(2, 8) - it
    n_m, n_v = 8 // world, 8 // world
    return {"m": m[rank * n_m:(rank + 1) * n_m].to(torch.bfloat16),
            "v": v[:, rank * n_v:(rank + 1) * n_v].copy(),
            "w": np.full((2, 2), float(it)), "tag": rank}


CKPT_LAYOUT = {"['m']": ["sharded", 0], "['v']": ["sharded", 1],
               "['tag']": "per_rank"}


def mode_gloo(comm, rank, world, out):
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.parallel.reshard import reshard
    from chainermn_tpu_torch.serving.lanes import lane_try_get

    res = {}
    # the bounded best-effort gather: both publish t1; only rank 0 t2
    res["t1"] = comm.allgather_obj_eventual("t1", {"r": rank}, timeout_s=10)
    if rank == 0:
        t0 = time.monotonic()
        res["t2"] = comm.allgather_obj_eventual("t2", "only0", timeout_s=0.5)
        res["t2_s"] = time.monotonic() - t0
    comm.allreduce(torch.ones(1))           # barrier: t1 read by both
    res["t3"] = comm.allgather_obj_eventual("t3", rank, timeout_s=0,
                                            discard_tag="t1")
    res["t1_left"] = comm._store().check([f"chainermn_tpu_evt/w/t1/{rank}"])
    comm.allreduce(torch.ones(1))
    # the tag-addressed lane
    lane = comm.kv_lane_transport()
    if rank == 0:
        lane.put("x", b"payload")
    comm.allreduce(torch.ones(1))
    res["x"] = lane.get("x", timeout_s=5)
    try:
        lane.get("absent", timeout_s=0.05)
        res["absent"] = "no error"
    except TimeoutError as e:
        res["absent"] = f"TimeoutError: {e}"
    comm.allreduce(torch.ones(1))
    if rank == 1:
        lane.delete("x")
    comm.allreduce(torch.ones(1))
    res["x_after_delete"] = lane_try_get(lane, "test/x", "x")
    store = comm.gang_lease_store()
    res["lease_absent"] = lane_try_get(store, "health/t/read", "lease/t")

    # a world-2 checkpoint with every kind of leaf
    ck = create_multi_node_checkpointer("elastic", comm, path=str(out / "ck"),
                                        layout=CKPT_LAYOUT)
    for it in CKPT_ITERS:
        ck.save(ckpt_state(rank, world, it), iteration=it)
    ck.flush()
    comm.allreduce(torch.ones(1))

    # reshard: this rank's block of the logical array, per (src, dst)
    full = logical()
    res["reshard"] = {}
    for src, dst in RESHARD_PAIRS:
        x = torch.from_numpy(block_of(full, src, rank, world).copy())
        got = reshard({"a": x}, {"a": src}, {"a": dst}, "mn")["a"]
        res["reshard"][(src, dst)] = got.numpy()
    with open(out / f"gloo{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def mode_guard(comm, rank, world, out):
    from chainermn_tpu_torch.extensions import SelfHealingGang

    gang = SelfHealingGang(comm.gang_lease_store(), rank=rank, world=world,
                           name="g", beat_interval_s=0.05, dump_dir=str(out))
    gang.start()
    gang.wait_for_members(timeout_s=30)
    comm.allreduce(torch.ones(1))           # both are in
    if rank == 1:
        gang.stop(release=False)            # stops publishing: "dead"
        time.sleep(6)                       # alive, out of the collective
        return
    deadline = time.monotonic() + 15
    while gang.stale_members() != [1]:
        assert time.monotonic() < deadline, "rank 1 never read as stale"
        time.sleep(0.05)
    gang.install_collective_guard(timeout_s=1.0)
    print("guard armed", flush=True)
    comm.allreduce(torch.ones(1))           # rank 1 never joins
    print("all-reduce returned: the guard did not fire", flush=True)


def mode_except(comm, rank, world, out):
    from chainermn_tpu_torch import global_except_hook
    from chainermn_tpu_torch.observability import flight

    flight.set_crash_dump_dir(str(out))
    global_except_hook.add_hook()
    comm.allreduce(torch.ones(1))
    if rank == 1:
        raise RuntimeError("boom on rank 1")
    time.sleep(3)


def mode_mnist(comm, rank, world, out, argv):
    from chainermn_tpu_torch import train_mnist_checkpoint

    with np.load(out / "mlp.npz") as z:
        params = {f"Dense_{i}": {"kernel": z[f"Dense_{i}/kernel"],
                                 "bias": z[f"Dense_{i}/bias"]}
                  for i in range(3)}
    result, _ = train_mnist_checkpoint.run(argv, params=params)
    (out / f"mnist{rank}.json").write_text(json.dumps(result))


def launch(mode, out_dir, *argv, world=2, timeout=120):
    """Run ``world`` ranks of ``mode`` in subprocesses (from the tests):
    ``(return codes, combined logs, seconds)``."""
    import os
    import subprocess

    root = Path(__file__).resolve().parents[1]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / f"store-{mode}-{time.monotonic_ns()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(root)
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "_torch_robustness_worker.py"),
         mode, str(r), str(world), str(store), str(out_dir), *argv],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    return ([p.returncode for p in procs], logs, time.monotonic() - t0)


def main(mode, rank, world, store_file, out, *argv):
    rank, world, out = int(rank), int(world), Path(out)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    comm = create_communicator("xla", device="cpu")
    if mode == "gloo":
        mode_gloo(comm, rank, world, out)
    elif mode == "guard":
        mode_guard(comm, rank, world, out)
    elif mode == "except":
        mode_except(comm, rank, world, out)
    elif mode == "mnist":
        mode_mnist(comm, rank, world, out, list(argv))
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
