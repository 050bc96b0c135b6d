#!/usr/bin/env python3
"""Where the time of a chainermn_tpu_torch serving tick and prefill goes, on one card.

Builds the full-width decode-bench LM (d 1024, 8 layers, 16 heads, vocab
32768, bf16, learned positions) from a seed, prefills 8 slots of a
1024-position pool with 512-token prompts, and profiles ``--ticks`` decode
ticks and one prefill with ``torch.profiler``.  Prints JSON lines: per
phase the host wall per call, the device busy time (union of kernel,
memcpy and memset intervals), the device idle share, the kernel count per
call, and the device time by kernel name (top entries); then the card's
name and power limit.  The beam kernel's two launches (the S splits and
their merge) are also summed under ``beam_kernel_ms_per_call``, and the
decode-attention and append kernels (device ms and launches) under
``attend_append_per_call``.  The Chrome
traces go to ``--out-dir``.
``--kv-heads 4`` profiles the GQA model (the tick runs the beam kernel),
``--temperature T`` samples every slot at ``T``, and ``--beam-new N``
adds a whole beam-4 generation (B 8, prompt 512, ``N`` new tokens, lazy
reorder; its per-call figures are per generated step, the prefill
included).

    python3 scripts/profile_torch_serving.py --ticks 20
    python3 scripts/profile_torch_serving.py --kv-heads 4 --temperature 0.7 \
        --beam-new 64
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_union(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _summarise(trace_path, wall_s, calls, name):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us = _busy_union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = defaultdict(float)
    beam = defaultdict(float)    # the beam kernel: its split and merge launches
    # the tick's attention and append kernels: decode_split_kernel (bf16,
    # the append folded in) or decode_attend_kernel, and cache_append_kernel
    attn = {part: [0.0, 0] for part in ("decode_split", "decode_attend_kernel",
                                        "cache_append_kernel")}
    for e in dev:
        by_name[e["name"][:80]] += e["dur"]
        for part in ("beam_split", "beam_merge"):
            if part in e["name"]:
                beam[part] += e["dur"]
        for part, acc in attn.items():
            if part in e["name"]:
                acc[0] += e["dur"]
                acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "phase": name, "calls": calls,
        "host_wall_ms_per_call": wall_s * 1e3 / calls,
        "device_busy_ms_per_call": busy_us / 1e3 / calls,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "device_ops_per_call": len(dev) / calls,
        "top_device_ms_per_call": {k: v / 1e3 / calls for k, v in top},
        "beam_kernel_ms_per_call": {
            **{k: v / 1e3 / calls for k, v in beam.items()},
            "total": sum(beam.values()) / 1e3 / calls},
        "attend_append_per_call": {
            k: {"ms": us / 1e3 / calls, "launches": n / calls}
            for k, (us, n) in attn.items() if n},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ticks", type=int, default=20)
    parser.add_argument("--out-dir", default="chiprun_out")
    parser.add_argument("--kv-heads", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--beam-new", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0,
                        help="weights and prompts; slot i samples with "
                             "fold_in(PRNGKey(seed + 1), i)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              make_lm_beam_generator)
    from chainermn_tpu_torch.serving import ServingEngine

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(args.seed), 32768, 1024, 16, 8, max_len=1024,
        dtype=torch.bfloat16, n_kv_heads=args.kv_heads, device="cuda")
    eng = ServingEngine(params, head_dim=64, n_slots=8, max_total=1024,
                        device="cuda")
    prompts = np.random.RandomState(args.seed).randint(0, 32768, (9, 512))
    de = eng.engine
    base_key = prng.PRNGKey(args.seed + 1)
    keys = np.stack([prng.fold_in(base_key, i) for i in range(8)])
    temps = np.full(8, args.temperature, np.float32)
    last = np.zeros(8, np.int32)
    for slot in range(8):
        eng.pool.acquire()
        last[slot] = de.prefill_into_slot(prompts[slot], slot, keys[slot],
                                          args.temperature)
    for _ in range(5):                                   # warm-up
        last = de.tick(last, keys, temps)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            last = de.tick(last, keys, temps)            # ends in a D2H read
        wall = time.perf_counter() - t0
    tick_trace = os.path.join(args.out_dir, "profile_tick.json")
    prof.export_chrome_trace(tick_trace)
    print(json.dumps(_summarise(tick_trace, wall, args.ticks, "tick")),
          flush=True)

    eng.pool.release(0)
    eng.pool.acquire()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        de.prefill_into_slot(prompts[8], 0)              # ends in a D2H read
        wall = time.perf_counter() - t0
    pf_trace = os.path.join(args.out_dir, "profile_prefill.json")
    prof.export_chrome_trace(pf_trace)
    print(json.dumps(_summarise(pf_trace, wall, 1, "prefill")), flush=True)

    if args.beam_new > 0:
        eng.close()
        beam = make_lm_beam_generator(head_dim=64, max_new_tokens=args.beam_new,
                                      beam_size=4)
        beam(params, prompts[:8, :16])                   # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            beam(params, prompts[:8]).cpu()
            wall = time.perf_counter() - t0
        bm_trace = os.path.join(args.out_dir, "profile_beam.json")
        prof.export_chrome_trace(bm_trace)
        print(json.dumps(_summarise(bm_trace, wall, args.beam_new, "beam4")),
              flush=True)

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
