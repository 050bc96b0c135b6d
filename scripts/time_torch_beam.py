#!/usr/bin/env python3
"""Time the port's beam kernel on one card at the beam-4 and GQA serving shapes.

Times ``chainermn_tpu_torch.ops.beam_attend_parts`` as a caller runs it
(CUDA events, median of ``--iters`` calls, the L2 flushed before each,
``--repeats`` medians in a row) at three bf16 shapes, inputs from
``--seed``:

* ``window``: a beam-4 step's generated window, B 8, 2048 rows of 16 heads
  of 64 (D 1024), read as a strided view of a longer cache, 4 rows per
  cache row, an ancestry mask with one valid slot per (b, beam, t);
* ``prompt``: the same step's shared prompt, B 8, S 512, mode none;
* ``gqa``: the GQA serving tick, B 8, S 1024, 4 KV heads of 64, g 4, a
  per-row pos in [512, 576).

Beside each, ``scaled_dot_product_attention`` on the same inputs
(``library_ms``: the rows as the query length with a boolean mask, or the
q heads grouped onto the KV heads).  Each output is checked once against
``beam_attend_parts_plain`` (atol = rtol = 2e-2).  Prints one JSON line
per shape, then the card's name and power limit.  Run it from two
checkouts back to back to compare two versions of the kernel on one
card.  ``--profile`` adds each launch's device time by kernel name
(``torch.profiler``, 20 calls: the S splits and their merge), and
``--blocks-per-sm N`` sets the split plan's target (the wrapper's
``BEAM_BLOCKS_PER_SM``) to time another plan.  ``host_us`` is the wall
time per call of ``--iters`` calls back to back, with no flush and no
synchronisation inside: the host's cost a call wherever it exceeds the
device's.  Needs a card.

    python3 scripts/time_torch_beam.py --repeats 5
    python3 scripts/time_torch_beam.py --profile --blocks-per-sm 4
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {  # B, S, H, hd, R, mode
    "window": (8, 2048, 16, 64, 4, "amask"),
    "prompt": (8, 512, 16, 64, 4, "none"),
    "gqa": (8, 1024, 4, 64, 4, "pos"),
}


def _profile(torch, flush, fn, calls=20):
    """Device ms per call of each kernel ``fn`` launches (L2 flushed
    before each call; the flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        if us and "beam_" in e.key:
            # "void (anonymous namespace)::beam_split_mma_kernel<64, 4>(..."
            out[e.key.split("::", 1)[-1].split("(")[0]] = us / 1e3 / calls
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", action="append", choices=sorted(SHAPES),
                        help="default: all three")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=9)
    parser.add_argument("--profile", action="store_true",
                        help="device ms of each launch, by kernel name")
    parser.add_argument("--blocks-per-sm", type=int, default=None,
                        help="the split plan's target (default: the "
                             "wrapper's)")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from chainermn_tpu_torch.ops import beam_attend_parts, beam_attend_parts_plain
    from chainermn_tpu_torch.ops import decode_attention

    if args.blocks_per_sm is not None:
        decode_attention.BEAM_BLOCKS_PER_SM = args.blocks_per_sm

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

    for name in args.shape or list(SHAPES):
        b, s, h, hd, r, mode = SHAPES[name]
        d = h * hd
        q = torch.randn(b * r, d, generator=g, device="cuda").bfloat16()
        rows = s + 64 if mode == "amask" else s        # the window: a view
        kc, vc = (torch.randn(b, rows, d, generator=g, device="cuda")
                  .bfloat16()[:, :s] for _ in range(2))
        amask = pos = None
        if mode == "amask":          # one valid slot per (b, beam, t)
            slot = torch.randint(0, r, (b, r, s // r), generator=g,
                                 device="cuda")
            amask = torch.zeros(b, r, s // r, r, dtype=torch.int8,
                                device="cuda")
            amask.scatter_(3, slot[..., None], 1)
            amask = amask.reshape(b, r, s)
        elif mode == "pos":
            pos = torch.randint(512, 576, (b,), generator=g, device="cuda",
                                dtype=torch.int32)
        kw = dict(beams=r, n_heads=h, head_dim=hd)
        got = beam_attend_parts(q, kc, vc, amask, pos, **kw)
        ref = beam_attend_parts_plain(q, kc, vc, amask, pos, **kw)
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        ok = all(torch.allclose(x, y, atol=2e-2, rtol=2e-2)
                 for x, y in zip(got, ref))
        ms = [timed(lambda: beam_attend_parts(q, kc, vc, amask, pos, **kw))
              for _ in range(args.repeats)]
        host_us = []             # back to back, no flush: the host's cost
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                beam_attend_parts(q, kc, vc, amask, pos, **kw)
            host_us.append((time.perf_counter() - t0) * 1e6 / args.iters)
            torch.cuda.synchronize()
        if mode == "pos":            # GQA: q heads grouped onto KV heads
            qt = q.view(b, r, h, hd).transpose(1, 2).reshape(b, h * r, 1, hd)
            mask = (torch.arange(s, device="cuda")[None, :]
                    <= pos.long()[:, None])[:, None, None, :]
            lib_kw = dict(attn_mask=mask, enable_gqa=True)
        else:                        # the beam rows as the query length
            qt = q.view(b, r, h, hd).transpose(1, 2)
            lib_kw = dict(attn_mask=None if amask is None
                          else (amask > 0)[:, None])
        kt = kc.view(b, s, h, hd).transpose(1, 2)
        vt = vc.view(b, s, h, hd).transpose(1, 2)
        lib = [timed(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                            **lib_kw))
               for _ in range(args.repeats)]
        plan = getattr(decode_attention, "beam_split_plan", None)  # older trees: none
        row = {"shape": name, "B": b, "S": s, "H": h, "hd": hd, "R": r,
               "mode": mode, "dtype": "bfloat16",
               "strided": not kc.is_contiguous(),
               "plan": plan and plan(s, b * h, torch.cuda.get_device_properties(
                   0).multi_processor_count),
               "ms": ms, "host_us": host_us, "library_ms": lib,
               "library": "SDPA",
               "max_abs_err": err, "ok": ok}
        if args.profile:
            row["device_ms"] = _profile(
                torch, flush,
                lambda: beam_attend_parts(q, kc, vc, amask, pos, **kw))
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
