#!/usr/bin/env python3
"""Time the port's flash-attention forward or backward on one card at given shapes.

For each ``--shape B,S,H,H_KV,D`` (causal, bf16, inputs from ``--seed``)
this script times ``chainermn_tpu_torch.ops.flash_attention`` as a user
calls it (CUDA events, median of ``--iters`` calls, the L2 flushed before
each, ``--repeats`` medians in a row), checks the output once against the
plain version (atol = rtol = 2e-2), and prints one JSON line per shape,
then the card's name and power limit.  With ``--backward`` it times
``flash_attention_bwd`` (the wrapper, its ``delta`` pass included) beside
the backward of ``scaled_dot_product_attention`` (``library_ms``: one
autograd call on the same q, k, v and dO, causal) and checks dq, dk, dv.
Run it from two checkouts back to back to compare two versions of the
kernel on one card.  Needs a card.

    python3 scripts/time_torch_flash.py --shape 1,512,16,16,64
    python3 scripts/time_torch_flash.py --backward --shape 8,1024,8,8,128
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", action="append", required=True,
                        help="B,S,H,H_KV,D (repeatable)")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--backward", action="store_true",
                        help="time the backward beside SDPA's backward")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from chainermn_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain)

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

    for spec in args.shape:
        b, s, h, hkv, d = (int(x) for x in spec.split(","))
        q = torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        if args.backward:
            do = torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16()
            out, lse = flash_attention_plain(q, k, v, causal=True)
            got = flash_attention_bwd(q, k, v, out, lse, do, True)
            ref = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
            err = max(float((x.float() - r.float()).abs().max())
                      for x, r in zip(got, ref))
            ok = all(torch.allclose(x.float(), r.float(), atol=2e-2,
                                    rtol=2e-2) for x, r in zip(got, ref))
            del got, ref
            ms = [timed(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                    True))
                  for _ in range(args.repeats)]
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=hkv != h)
            dot = do.transpose(1, 2).contiguous()
            lib = [timed(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True))
                for _ in range(args.repeats)]
            print(json.dumps({"B": b, "S": s, "H": h, "H_kv": hkv, "D": d,
                              "causal": True, "dtype": "bfloat16",
                              "pass": "backward", "ms": ms,
                              "library_ms": lib,
                              "library": "SDPA backward",
                              "max_abs_err": err, "ok": ok}), flush=True)
            if not ok:
                return 1
            continue
        out = flash_attention(q, k, v, causal=True)
        ref, _ = flash_attention_plain(q, k, v, causal=True)
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(out.float(), ref.float(), atol=2e-2,
                                 rtol=2e-2))
        ms = [timed(lambda: flash_attention(q, k, v, causal=True))
              for _ in range(args.repeats)]
        print(json.dumps({"B": b, "S": s, "H": h, "H_kv": hkv, "D": d,
                          "causal": True, "dtype": "bfloat16", "ms": ms,
                          "max_abs_err": err, "ok": ok}), flush=True)
        if not ok:
            return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
