#!/usr/bin/env python3
"""Time the port's decode tick attention on one card at the serving and full-cache shapes.

Times, in bf16 with inputs from ``--seed``, at two shapes of the serving
tick (B 8, S 1024, 16 heads of 64, D 1024):

* ``serve``: per-row pos in [512, 576), the serving run's lengths;
* ``full``: a scalar pos of 1023, every cache row read.

Per shape: ``tick`` is the tick's append and attention as the tree runs
them (``decode_append_attend`` where the tree has it, else ``cache_append``
then ``decode_attend``), ``attend`` is ``decode_attend`` alone, and
``library`` is ``scaled_dot_product_attention`` with a boolean mask (plus
two ``index_put_`` of the new rows for ``library_tick``).  Each time is the
median of ``--iters`` calls timed with CUDA events, the L2 flushed before
each by a 256 MB write, ``--repeats`` medians in a row;
``attend_clean_ms`` is ``attend`` with the L2 flushed by a 256 MB read
instead (a read-bound kernel that evicts dirty lines also pays their
write-back); ``host_us`` is the wall time per call of ``--iters`` ticks
back to back with no flush and no synchronisation inside (the host's cost
a call where it exceeds the device's).  ``--profile`` adds the device ms
per call of each kernel the tick launches, by name (``torch.profiler``,
20 calls, L2 flushed; the bf16 split kernel merges its splits in the same
launch).
Outputs are checked once against the plain versions (atol = rtol = 2e-2;
the caches exactly).  Prints one JSON line per shape, then the card's name
and power limit.  Run it from two checkouts back to back to compare two
versions of the kernel on one card (an older tree runs its own wrappers).
Needs a card.

    python3 scripts/time_torch_decode.py --repeats 5 --profile
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, S, H, HD = 8, 1024, 16, 64


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
        if us and ("decode_" in e.key or "cache_append" in e.key):
            # "void (anonymous namespace)::decode_split_kernel<64>(..."
            out[e.key.split("::", 1)[-1].split("(")[0]] = us / 1e3 / calls
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", action="append", choices=("serve", "full"),
                        help="default: both")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=9)
    parser.add_argument("--profile", action="store_true",
                        help="device ms of each launch, by kernel name")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.ops import decode_attention

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    fused = getattr(ops, "decode_append_attend", None)   # older trees: none
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kw = dict(n_heads=H, head_dim=HD)

    def timed(fn, clean=False):
        for _ in range(3):
            fn()
        times = []
        for _ in range(args.iters):
            if clean:
                flush.max()
            else:
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

    for name in args.shape or ["serve", "full"]:
        d = H * HD
        q, kn, vn = (torch.randn(B, d, generator=g, device="cuda").bfloat16()
                     for _ in range(3))
        kc, vc = (torch.randn(B, S, d, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        if name == "serve":
            pos = torch.randint(512, 576, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
            p_vec = pos.long()
        else:
            pos = S - 1
            p_vec = torch.full((B,), pos, device="cuda")

        def tick():
            if fused is not None:
                return fused(q, kn, vn, kc, vc, pos, **kw)
            ops.cache_append(kc, vc, kn[:, None], vn[:, None], pos)
            return ops.decode_attend(q, kc, vc, pos, **kw)

        def attend():
            return ops.decode_attend(q, kc, vc, pos, **kw)

        # the check: the tick on copies against the plain pair
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        if fused is not None:
            got = fused(q, kn, vn, k1, v1, pos, **kw)
        else:
            ops.cache_append(k1, v1, kn[:, None], vn[:, None], pos)
            got = ops.decode_attend(q, k1, v1, pos, **kw)
        ops.cache_append_plain(k2, v2, kn[:, None], vn[:, None], pos)
        ref = ops.decode_attend_plain(q, k2, v2, pos, **kw)
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(got.float(), ref.float(), atol=2e-2,
                                 rtol=2e-2)) and torch.equal(k1, k2) \
            and torch.equal(v1, v2)
        del k1, v1, k2, v2

        qt = q.view(B, H, 1, HD)
        kt = kc.view(B, S, H, HD).transpose(1, 2)
        vt = vc.view(B, S, H, HD).transpose(1, 2)
        mask = (torch.arange(S, device="cuda")[None, :]
                <= p_vec[:, None])[:, None, None, :]
        bi, row = torch.arange(B, device="cuda"), p_vec.clamp(0, S - 1)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def sdpa_tick():
            kc.index_put_((bi, row), kn)
            vc.index_put_((bi, row), vn)
            return sdpa()

        rep = range(args.repeats)
        ms = [timed(tick) for _ in rep]
        attend_ms = [timed(attend) for _ in rep]
        attend_clean_ms = [timed(attend, clean=True) for _ in rep]
        lib = [timed(sdpa) for _ in rep]
        lib_tick = [timed(sdpa_tick) for _ in rep]
        host_us = []
        for _ in rep:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                tick()
            host_us.append((time.perf_counter() - t0) * 1e6 / args.iters)
            torch.cuda.synchronize()
        plan = getattr(decode_attention, "decode_split_plan", None)
        row_out = {
            "shape": name, "B": B, "S": S, "H": H, "hd": HD,
            "dtype": "bfloat16", "fused": fused is not None,
            "plan": plan and plan(B, S, H, HD, torch.cuda.get_device_properties(
                0).multi_processor_count),
            "tick_ms": ms, "attend_ms": attend_ms,
            "attend_clean_ms": attend_clean_ms, "host_us": host_us,
            "library_ms": lib, "library_tick_ms": lib_tick,
            "library": "SDPA (+ index_put_ k, v)", "max_abs_err": err,
            "ok": ok}
        if args.profile:
            row_out["device_ms"] = _profile(torch, flush, tick)
            row_out["attend_device_ms"] = _profile(torch, flush, attend)
        print(json.dumps(row_out), flush=True)
        if not ok:
            return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
