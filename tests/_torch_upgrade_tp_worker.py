"""One rank of an in-process engine worker at TP = 2, for
tests/test_torch_rolling_upgrade_tp.py.

Run as ``python tests/_torch_upgrade_tp_worker.py RANK WORLD STORE_FILE
OUT_DIR``.  Joins a gloo group through a ``FileStore`` and reads
``OUT_DIR/inputs.pkl`` (JAX's global params and a prompt).  On a
``('model',)`` mesh of the world, model rank 0 builds the in-process fleet
(``build_local_fleet``, one engine worker leading the group), serves the
prompt and calls ``rolling_upgrade`` over its runtimes; the other ranks
follow the worker's plan (``follow_worker``).  Pickles what this rank got
to ``OUT_DIR/rank<r>.pkl``.  Imports no JAX.
"""

import pickle
import sys
import threading
from pathlib import Path

import torch
import torch.distributed as dist

from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

AX = "model"


def main(rank, world, store_file, out_dir):
    from chainermn_tpu_torch.convert import shard_from_jax, tree_map
    from chainermn_tpu_torch.parallel import transformer_lm_specs
    from chainermn_tpu_torch.serving import build_local_fleet, rolling_upgrade
    from chainermn_tpu_torch.serving.worker import follow_worker

    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=120, store=store, rank=rank,
                     world_size=world)
    with open(Path(out_dir) / "inputs.pkl", "rb") as fh:
        inputs = pickle.load(fh)
    mesh = make_nd_mesh((AX,), (world,))
    host = inputs["params"]
    local = shard_from_jax(host, transformer_lm_specs(host, AX), mesh,
                           device="cpu")
    sizes = dict(device="cpu", n_slots=2, max_total=32)
    kw = dict(sizes, mesh=mesh)
    if rank != 0:
        out = {"followed": follow_worker("engine", local, mesh,
                                         head_dim=inputs["head_dim"],
                                         **sizes)}
    else:
        router, runtimes = build_local_fleet(
            local, {"engine": 1}, head_dim=inputs["head_dim"],
            beat_interval_s=0.02, miss_beats=16, worker_kwargs=kw)
        rt = runtimes[0]
        t = threading.Thread(target=rt.run, daemon=True)
        t.start()
        router.start()
        try:
            h = router.submit(inputs["prompt"], inputs["max_new"])
            h.wait(120)
            out = {"tokens": h.tokens, "tp": rt.tp}
            try:
                rolling_upgrade(router, runtimes, [local],
                                tree_map(local, lambda t: None),
                                generation=2, head_dim=inputs["head_dim"],
                                worker_kwargs=kw)
                out["upgrade"] = "returned"
            except NotImplementedError as e:
                out["upgrade"] = ("refused", str(e))
            out["workers"] = sorted(router.workers)
        finally:
            router.stop()
            rt.finished = True
            t.join(30)
            rt.plan.stop()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5])
