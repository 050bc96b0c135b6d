"""The port's lock-order recorder over a CPU serving run, in a process of
its own, for tests/test_torch_analysis_concurrency.py.

Run as ``python tests/_torch_lock_worker.py OUT_JSON``.  Sets
``CHAINERMN_TPU_TORCH_LOCK_ASSERT=1`` and installs the recorder BEFORE the
port's modules are imported, so every lock the package creates (module
and instance locks) is tracked; then serves 8 requests through a
``ServingEngine``'s driver thread and 8 through a two-replica router, all
greedy at a tiny LM on the CPU, uninstalls the recorder and runs
``assert_consistent`` (the union of the static lock graph and the
observed acquisition orders must be acyclic).  Writes the tracked-lock
count, the named dynamic edges and each request's status and tokens to
``OUT_JSON``; exits 1 on a cycle.  Imports no JAX.
"""

import json
import os
import sys
from pathlib import Path

os.environ["CHAINERMN_TPU_TORCH_LOCK_ASSERT"] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chainermn_tpu_torch.analysis import lockassert  # noqa: E402

REC = lockassert.install_from_env()

import numpy as np  # noqa: E402
import torch  # noqa: E402

VOCAB, D, HEADS, LAYERS = 64, 32, 4, 2


def main(out_path):
    from chainermn_tpu_torch.parallel.transformer import \
        init_tp_transformer_lm
    from chainermn_tpu_torch.serving import ServingEngine, build_fleet

    torch.set_num_threads(1)
    params = init_tp_transformer_lm(torch.Generator().manual_seed(0), VOCAB,
                                    D, HEADS, LAYERS, max_len=64,
                                    device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, 5 + i % 3).tolist() for i in range(16)]
    head_dim = D // HEADS

    eng = ServingEngine(params, head_dim=head_dim, n_slots=4, max_total=32,
                        device="cpu")
    eng.start()
    try:
        handles = [eng.submit(p, 4) for p in prompts[:8]]
        assert all(h.wait(timeout=60) for h in handles)
    finally:
        eng.close()
    router = build_fleet(params, 2, head_dim=head_dim, n_slots=2,
                         max_total=32, queue_capacity=8, device="cpu")
    router.start()
    try:
        routed = [router.submit(p, 4) for p in prompts[8:]]
        assert all(h.wait(timeout=60) for h in routed)
    finally:
        router.stop()
    REC.uninstall()
    result = {"n_tracked": REC.n_tracked,
              "status": [h.status for h in handles + routed],
              "tokens": [list(map(int, h.tokens)) for h in handles + routed],
              "prompts": prompts}
    try:
        dynamic = lockassert.assert_consistent(REC)
    except AssertionError as e:
        result["cycle"] = str(e)
        Path(out_path).write_text(json.dumps(result))
        return 1
    result["dynamic"] = sorted(list(e) for e in dynamic)
    Path(out_path).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
