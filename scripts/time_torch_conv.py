#!/usr/bin/env python3
"""Time the port's bf16 conv input gradient on one card at ResNet-50's shapes.

For each ``--shape N,H,W,Ci,Co,k`` (default: ResNet-50's three eligible
3x3 shapes at batch 128; bf16, inputs from ``--seed``) this script times
``chainermn_tpu_torch.ops.conv3x3_dgrad`` as the backward calls it (CUDA
events, median of ``--iters`` calls, the L2 flushed before each,
``--repeats`` medians in a row) beside cuDNN's ``convolution_backward``
asked for dX alone, checks the result once against the plain version
(atol = rtol = 2e-2, and the largest error within 2e-2 x the largest
entry), and prints one JSON line per shape, then the card's name and
power limit.  Run it from two checkouts one after the other on one card
to compare two versions of the kernel.  Needs a card.

    python3 scripts/time_torch_conv.py --shape 128,56,56,64,64,3
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESNET50 = ["128,56,56,64,64,3", "128,28,28,128,128,3", "128,14,14,256,256,3"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", action="append",
                        help="N,H,W,Ci,Co,k (repeatable; default: "
                        "ResNet-50's)")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)

    import torch

    from chainermn_tpu_torch.ops import conv_backward as C

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(args.seed)
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

    def repeated(fn):
        return [timed(fn) for _ in range(args.repeats)]

    for spec in args.shape or RESNET50:
        n, h, w, ci, co, k = (int(x) for x in spec.split(","))
        xshape = (n, h, w, ci)
        dy = torch.randn(n, h, w, co, generator=g, device="cuda").bfloat16()
        wt = (torch.randn(k, k, ci, co, generator=g, device="cuda")
              / (k * k * co) ** 0.5).bfloat16()
        got = C.conv3x3_dgrad(dy, wt, xshape)
        ref = C.conv3x3_dgrad_plain(dy, wt, xshape)
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(got.float(), ref.float(), atol=2e-2,
                                 rtol=2e-2)) \
            and err <= 2e-2 * float(ref.float().abs().max())
        pad = (k - 1) // 2
        dyn = dy.permute(0, 3, 1, 2)
        xn = torch.empty(xshape, dtype=dy.dtype,
                         device="cuda").permute(0, 3, 1, 2)
        wn = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row = {"N": n, "H": h, "W": w, "Ci": ci, "Co": co, "k": k,
               "dtype": "bfloat16",
               "ms": repeated(lambda: C.conv3x3_dgrad(dy, wt, xshape)),
               "cudnn_dx_ms": repeated(
                   lambda: torch.ops.aten.convolution_backward(
                       dyn, xn, wn, None, [1, 1], [pad, pad], [1, 1], False,
                       [0, 0], 1, [True, False, False])),
               "max_abs_err": err, "ok": ok}
        print(json.dumps(row), flush=True)
        if not ok:
            return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
