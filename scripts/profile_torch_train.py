#!/usr/bin/env python3
"""Where the time of a chainermn_tpu_torch training step goes, on one card.

Builds the full-width LM of ``bench.py``'s ``bench_transformer_lm`` (d 1024,
8 layers, 8 heads of 128, vocab 32768, learned positions, bf16) from a
seed and profiles ``--steps`` SGD steps at batch 8 x 1024 tokens with
flash attention and the fused cross-entropy (``--ce-impl``), after two
warm-up steps, under ``torch.profiler``.  Prints one JSON line: the host
wall per step, the device busy time (union of kernel, memcpy and memset
intervals), the device idle share, the kernel count per step, the device
time by kernel name (top entries) and of each fused cross-entropy and
flash-attention kernel, and the peak device memory of the profiled steps;
then the card's name and power limit.  The Chrome
trace goes to ``--out-dir`` (default ``profile/``).  Needs a card.

    python3 scripts/profile_torch_train.py --steps 2
"""

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_serving import _summarise  # noqa: E402

# the bf16 CE GEMM (ce_stats and the gradients), by its epilogue template
# argument
_CE_GEMM = {"0": "ce_gemm ds pass", "1": "ce_gemm dh product",
            "2": "ce_gemm dtable product", "3": "ce_stats"}


def _kernel_ms(trace_path, steps):
    """Device ms per step of each hand-written kernel, which the top-12
    list can miss: ``ce_stats`` (bf16: the ``ce_gemm_kernel`` with the
    statistics epilogue; fp32: ``ce_stats_kernel``) and its merge, the
    ``ce_gemm_kernel`` by epilogue (the ds pass, the dh and dtable
    products), the flash forward and the flash backward's three kernels
    (the delta pass, dk/dv, dq)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        if "ce_gemm_kernel<" in name:
            epi = name.split("ce_gemm_kernel<")[1].split(",")[1].strip()
            key = _CE_GEMM.get(epi, f"ce_gemm {epi}")
        elif "ce_stats_merge_kernel" in name:
            key = "ce_stats merge"
        elif "ce_stats_kernel" in name:
            key = "ce_stats"
        elif "flash_fwd" in name:
            key = "flash forward"
        elif "flash_bwd_delta" in name:
            key = "flash backward delta"
        elif "flash_bwd_dkdv" in name:
            key = "flash backward dk, dv"
        elif "flash_bwd_dq" in name:
            key = "flash backward dq"
        else:
            continue
        out[key] = out.get(key, 0.0) + e["dur"] / 1e3 / steps
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--ce-impl", default="fused",
                        choices=["auto", "xla", "fused"])
    parser.add_argument("--out-dir", default="profile")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_hybrid_shard_map_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    seq, batch, vocab, d_model, n_heads = 1024, 8, 32768, 1024, 8
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(0), vocab, d_model, n_heads, 8,
        max_len=seq, dtype=torch.bfloat16, device="cuda")
    step = make_hybrid_shard_map_step(
        partial(tp_transformer_lm_loss, head_dim=d_model // n_heads,
                attn_impl="flash", ce_impl=args.ce_impl),
        torch.optim.SGD(param_leaves(params), lr=1e-2), params)
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, vocab, (batch, seq + 1)), device="cuda")
    for _ in range(2):                                   # warm-up
        step(params, (tokens,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step(params, (tokens,))
        float(loss)                                      # waits for the card
        wall = time.perf_counter() - t0
    trace = os.path.join(args.out_dir, f"profile_train_{args.ce_impl}.json")
    prof.export_chrome_trace(trace)
    row = _summarise(trace, wall, args.steps, f"train_step_{args.ce_impl}")
    row["kernel_ms_per_call"] = _kernel_ms(trace, args.steps)
    row["loss"] = float(loss)
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps(row), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
