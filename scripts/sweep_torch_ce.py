#!/usr/bin/env python3
"""Time the bf16 CE gradients on one card for several V-chunk widths.

``ce_grads`` makes ``ds`` one V chunk at a time (``ops.fused_ce._grad_plan``:
by default the widest chunk whose ``ds`` fits 32 MiB, 2048 columns at T
8192).  This script times, at the training shape (T 8192, V 32768, D 1024,
bf16, weights and targets from ``--seed``), the ``ce_grads`` entry point of
``csrc/fused_ce.cu`` with both outputs, with dh alone and with dtable alone,
for each width in ``--chunks`` (CUDA events, median of ``--iters`` launches,
the L2 flushed before each), and checks each result against the plain
version once.  Prints one JSON line per width, then the card's name and
power limit.  Needs a card.

    python3 scripts/sweep_torch_ce.py --chunks 2048 4096 8192 32768
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunks", type=int, nargs="+",
                        default=[2048, 4096, 8192, 32768])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    from chainermn_tpu_torch.ops import _build
    from chainermn_tpu_torch.ops import fused_ce as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t, v, d = 8192, 32768, 1024
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    h = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    tab = (torch.randn(v, d, generator=g, device="cuda")
           * (2.0 / d) ** 0.5 * 4).bfloat16()
    tgt = torch.randint(0, v, (t,), generator=g, device="cuda",
                        dtype=torch.int32)
    dnll = torch.rand(t, generator=g, device="cuda")
    m, l, _ = F.ce_stats_plain(h, tab, tgt)
    lse = (m + torch.log(l)).contiguous()
    ref = F.ce_grads_plain(h, tab, tgt, lse, dnll)
    lib = _build.library("fused_ce")
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(args.iters):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    for chunk in args.chunks:
        plan = F._grad_plan(t, v, d, torch.bfloat16, chunk)
        rows, ld = plan["ds_shape"]
        work = torch.empty(F._round_up(2 * rows * ld, 256) + 4 * t * d,
                           dtype=torch.uint8, device="cuda")
        dh, dtable = torch.empty_like(h), torch.empty_like(tab)

        def run(want_dh, want_dtable):
            err = lib.ce_grads(
                h.data_ptr(), tab.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
                dnll.data_ptr(), dh.data_ptr() if want_dh else None,
                dtable.data_ptr() if want_dtable else None, work.data_ptr(),
                t, v, d, plan["chunk"], 1, stream)
            _build.check(err, "ce_grads")

        run(True, True)
        torch.cuda.synchronize()
        errs = [float((x.float() - r.float()).abs().max())
                for x, r in zip((dh, dtable), ref)]
        print(json.dumps({
            "chunk": plan["chunk"], "n_chunks": len(plan["bounds"]),
            "ds_mib": 2 * rows * ld / 2 ** 20,
            "ce_grads_ms": timed(lambda: run(True, True)),
            "dh_alone_ms": timed(lambda: run(True, False)),
            "dtable_alone_ms": timed(lambda: run(False, True)),
            "max_abs_err_dh": errs[0], "max_abs_err_dtable": errs[1],
            "T": t, "V": v, "D": d}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
