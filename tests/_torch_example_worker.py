"""One rank of the port's seq2seq or model-parallel example at world > 1,
for tests/test_torch_seq2seq.py and tests/test_torch_model_parallel.py.

Run as ``python tests/_torch_example_worker.py SUITE RANK WORLD STORE_FILE
OUT_DIR ARG...``.  Joins a gloo group through a ``FileStore`` (no port),
runs ``train_seq2seq.run`` (SUITE ``seq2seq``) or
``train_model_parallel.run`` (SUITE ``model_parallel``) with ``ARG...``
and the initial weights pickled in ``OUT_DIR/params.pkl``, and pickles
the result to ``OUT_DIR/rank<r>.pkl``.  Imports no JAX.
"""

import pickle
import sys
from pathlib import Path

import torch.distributed as dist

from chainermn_tpu_torch import train_model_parallel, train_seq2seq
from chainermn_tpu_torch.topology import init_distributed


def main(suite, rank, world, store_file, out_dir, argv):
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=60, store=store, rank=rank,
                     world_size=world)
    with open(Path(out_dir) / "params.pkl", "rb") as fh:
        params = pickle.load(fh)
    if suite == "seq2seq":
        out = train_seq2seq.run(
            argv + ["--out", str(Path(out_dir) / f"s2s{rank}")],
            params=params)[0]
    else:
        out = train_model_parallel.run(argv, params=params)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], sys.argv[6:])
