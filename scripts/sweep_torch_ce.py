#!/usr/bin/env python3
"""Time the bf16 fused CE kernels on one card: ce_stats, and the gradients for several V-chunk widths.

At the training shape (T 8192, V 32768, D 1024, bf16, weights and
targets from ``--seed``; CUDA events, median of ``--iters`` launches,
the L2 flushed before each) this script first times ``ops.ce_stats`` as
the forward calls it, ``--repeats`` medians in a row, beside one library
call of the same function (a matmul and a logsumexp), and checks it
against the plain version once.  Then, for each width in ``--chunks``
(none: the sweep is skipped), the ``ce_grads`` entry point of
``csrc/fused_ce.cu``, which makes ``ds`` one V chunk at a time
(``ops.fused_ce._grad_plan``: by default the widest chunk whose ``ds``
fits 32 MiB, 2048 columns at T 8192), with both outputs, with dh alone
and with dtable alone, each checked against the plain version once.
Prints one JSON line for ``ce_stats`` and one per width, then the card's
name and power limit.  Run it from two checkouts one after the other on
one card to compare two versions of the kernels. Needs a card.

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
    parser.add_argument("--chunks", type=int, nargs="*",
                        default=[2048, 4096, 8192, 32768])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--repeats", type=int, default=3)
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
    stats = F.ce_stats_plain(h, tab, tgt)
    m, l, _ = stats
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

    got = F.ce_stats(h, tab, tgt)
    torch.cuda.synchronize()
    errs = [float((x - r).abs().max()) for x, r in zip(got, stats)]
    print(json.dumps({
        "kernel": "ce_stats",
        "ms": [timed(lambda: F.ce_stats(h, tab, tgt))
               for _ in range(args.repeats)],
        "library_ms": [timed(lambda: torch.logsumexp(
            torch.matmul(h, tab.t()).float(), -1))
            for _ in range(args.repeats)],
        "library": "matmul + logsumexp",
        "max_abs_err_m_l_picked": errs, "T": t, "V": v, "D": d}),
        flush=True)
    if max(errs[0], errs[2]) > 2e-2 or errs[1] > 2e-2 * float(
            stats[1].abs().max()):
        return 1

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
