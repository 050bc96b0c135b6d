#!/usr/bin/env python3
"""GPU smoke of chainermn_tpu_torch: build, kernel checks, serving, beam search, LM and ResNet training on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each named on its own output line; any failure exits non-zero
and prints no result line:

1. ``device``  — the card (nvidia-smi name and power limit), torch and
   CUDA versions; ``build`` — every kernel compiled from ``csrc/`` in
   parallel (one nvcc per source), with each kernel's ptxas report.
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card, at the main paths' shapes and edge shapes, in bf16 (atol = rtol =
   2e-2: bf16 keeps 8 mantissa bits) and fp32 (atol = rtol = 1e-4: the
   kernel sums in another order); the bf16 main-path shapes are also
   timed (CUDA events, L2 flushed before each launch) beside the plain
   version, one PyTorch library call, and the bound (bytes / 3.35 TB/s or
   FLOPs / peak, whichever is larger).  The training kernels: the flash
   backward (B 8, S 1024, H 8, hd 128, causal; hd 64, group 2, a ragged S
   of 77, the LSE cotangent) and the three fused cross-entropy kernels (T
   8192, V 32768, D 1024; ragged T and V, targets out of range).  The CE
   gradients are small numbers, so their largest error must also stay
   within the tolerance times their largest entry.  The beam kernel
   (``beam_attend_parts``: acc, m and l): beam 4's two segments at full
   width (the (8, 512, 1024) prompt, mode none; the (8, 2048, 1024)
   generated window as a strided view, mode amask, one valid slot per
   (b, beam, t)), the GQA tick (B 8, 4 KV heads of 64, g 4, S 1024, pos
   scalar, per-row and at the edges), hd 128, S 1, a ragged S of 77 and
   8 or 16 rows per cache row; the three timed shapes beside
   ``scaled_dot_product_attention`` (the rows as the query length, a
   boolean mask; ``enable_gqa`` for GQA).  The conv backward kernels
   (``conv3x3_wgrad``, ``conv3x3_dgrad``): ResNet-50's three eligible 3x3
   shapes at batch 128 (56² x 64, 28² x 128, 14² x 256), the 1x1 at 56² x
   64 → 256, a ragged 7 x 5 plane, a 196-row plane, n = 1 and channel
   counts that are not multiples of 8, the bf16 error also within tol x
   max |ref|; the three 3x3 shapes timed beside cuDNN's
   ``convolution_backward`` asked for dW alone or dX alone.
3. ``parity``  — fp32, full width (d 1024, 8 layers, 16 heads, vocab
   32768), and a small RoPE model (d 256, 4 heads, 2 layers): 4 staggered
   requests through the port's ServingEngine on the card and on the CPU
   with the same weights; tokens must be equal, or
   differ only where the CPU's logits of the two tokens are within 1e-3
   (a near-tie, after which that request's comparison stops).  The same
   for the full-width GQA model (4 KV heads) with requests 1 and 3
   sampled at temperature 0.7 (for a sampled row the near-tie is in the
   CPU's ``logits / T + gumbel``), and beam 4, lazy and physical, at
   prompt 128 and 16 new tokens (the best beams equal, or their CPU
   log-probabilities within 1e-3).  TF32 is off for the whole run
   (matmul and cuDNN).
4. ``serving`` — bf16, full width: 16 staggered requests (prompt 512, 64
   new tokens) through an 8-slot, max_total 1024 ServingEngine; every
   request must finish ``done`` and every serving kernel (flash forward,
   decode attention, append) must have launched.  The
   launch counts are zeroed just before this run and read just after.
   Then ``lm_generate`` at B 8, prompt 512, 64 new tokens.
5. ``beam`` — bf16, ``bench.py :: bench_decode``'s full width: beam 4,
   lazy reorder, B 8, prompt 512, 512 new tokens (tokens/s, ms per token,
   peak memory), beside the prefill alone and the greedy ``lm_generate``
   of the same size.  Launch counts zeroed just before the beam run and
   read just after must be 2 x 8 x 511 beam-kernel launches, 8 x 511 + 8
   appends and 8 flash forwards.
6. ``serving-gqa`` — bf16, the GQA model (4 KV heads): the serving run
   of phase 4 with the odd half of the requests sampled at temperature
   0.7; every request ``done``, the beam kernel launched 8 times on every
   tick and the decode kernel never.
7. ``train-parity`` — fp32, d 1024, 2 layers, 8 heads, vocab 32768, S 256,
   B 2, flash attention and the fused CE, TF32 off: the gradient of every
   parameter at the initial weights, card against CPU, to a relative norm
   of 1e-4 (an SGD step of 1e-2 moves the tied embedding by less than
   the parameter tolerance, so the gradients are held directly); then
   two SGD steps on the card and on the CPU from the same weights, losses
   to rtol 1e-4 and parameters to atol 1e-4.
8. ``train`` — bf16, the full width of ``bench.py``'s
   ``bench_transformer_lm`` (d 1024, 8 layers, 8 heads of 128, vocab
   32768, S 1024, B 8, learned positions, SGD 1e-2, flash attention) with
   ``ce_impl="fused"``: 2 warm-up steps, then 10 timed steps, each
   synchronised (step ms p50/p99, tokens/s, analytic MFU against 989
   TFLOP/s, peak memory, every loss).  Losses must be finite and fall, and
   the launch counts, zeroed just before the timed steps and read just
   after, must show 8 flash forward and 8 flash backward launches and one
   of each CE kernel per step.  Then 3 steps with ``ce_impl="auto"`` from
   the same initial weights: the first loss within 2e-2 of the fused one.
9. ``resnet-parity`` — fp32, TF32 off: ResNet-50 at image 112 (stages 1-2
   eligible for the conv kernels at 28² and 14²; the stride-2 and 7 x 7
   convs take cuDNN's backward), batch 4, ``conv_impl="pallas"``, card
   against CPU from the same random weights: the loss to rtol 1e-4, every
   gradient to a relative norm of 1e-4 (6 launches of each conv kernel
   per backward on the card), then two ``make_flax_train_step`` steps
   (SGD 0.1, momentum 0.9, wd 1e-4, world 1; NCCL on the card, gloo on
   the CPU): losses rtol 1e-4, parameters and running statistics atol
   1e-4.
10. ``resnet-train`` — bf16, ``bench.py``'s headline (ResNet-50, image
   224, batch 128, 1,000 classes, SGD 0.1 / momentum 0.9 / wd 1e-4
   through the multi-node optimizer) via ``train_imagenet.build_step`` at
   world 1 over a one-rank NCCL group, ``conv_impl="pallas"``: 2 warm-up
   and 10 timed steps, each synchronised (step ms p50/p99, images/s,
   analytic MFU by ``bench.py:3106``'s 3 x 4.1e9 FLOP per image over 989
   TFLOP/s, peak memory, every loss).  Losses must be finite and the
   launch counts, zeroed just before the timed steps and read just after,
   exactly 11 ``conv_wgrad`` and 11 ``conv_dgrad`` per step.  Then the
   same with ``conv_impl="xla"`` (cuDNN's backward) from the same
   weights: no conv-kernel launch, the first loss within 2e-2 of the
   pallas run's, the step times side by side.
11. One ``{"kernels": [...]}`` line (launches summed over the main paths'
   runs: the two serving runs, the beam run, the timed LM training steps
   and the timed pallas ResNet steps), the card line, then the result
   line ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
FULL = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8)
HEAD_DIM = FULL["d_model"] // FULL["n_heads"]
GQA_KV_HEADS = 4            # the GQA configuration: g = 4 query heads per KV head
BEAM = dict(batch=8, prompt=512, new=512, beam_size=4)   # bench.py bench_decode
# bench.py :: bench_transformer_lm's defaults
TRAIN = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8)
TRAIN_SEQ, TRAIN_BATCH = 1024, 8
# bench.py's headline: ResNet-50, image 224, batch 128 per card, 1,000 classes
RESNET = dict(arch="resnet50", image=224, batch=128, classes=1000)
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9          # bench.py:3106, training ~3x fwd
RESNET_CONV_LAUNCHES = 11   # eligible 3x3 convs per step at 224 (3 + 3 + 5)
KERNEL_INFO = {
    "flash_fwd": ("chainermn_tpu_torch/csrc/flash_fwd.cu",
                  "chainermn_tpu/ops/flash_attention.py:226"),
    "flash_bwd": ("chainermn_tpu_torch/csrc/flash_bwd.cu",
                  "chainermn_tpu/ops/flash_attention.py:426"),
    "decode_attend": ("chainermn_tpu_torch/csrc/decode_attention.cu",
                      "chainermn_tpu/ops/decode_attention.py:181"),
    "cache_append": ("chainermn_tpu_torch/csrc/kv_cache.cu",
                     "chainermn_tpu/ops/kv_cache.py:198"),
    "ce_stats": ("chainermn_tpu_torch/csrc/fused_ce.cu",
                 "chainermn_tpu/ops/fused_ce.py:210"),
    "ce_dh": ("chainermn_tpu_torch/csrc/fused_ce.cu",
              "chainermn_tpu/ops/fused_ce.py:254"),
    "ce_dtable": ("chainermn_tpu_torch/csrc/fused_ce.cu",
                  "chainermn_tpu/ops/fused_ce.py:273"),
    "beam_attend": ("chainermn_tpu_torch/csrc/beam_attention.cu",
                    "chainermn_tpu/ops/decode_attention.py:324"),
    "conv_wgrad": ("chainermn_tpu_torch/csrc/conv_backward.cu",
                   "chainermn_tpu/ops/conv_backward.py:243"),
    "conv_dgrad": ("chainermn_tpu_torch/csrc/conv_backward.cu",
                   "chainermn_tpu/ops/conv_backward.py:320"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failed = []
        self.kernel_rows = {}      # name -> timing/err row of the main shape
        self.launches = {}         # name -> launches summed over main paths

    def add_launches(self, counts):
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n

    def phase(self, name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — report every phase
            self.failed.append(name)
            print(f"FAIL phase {name}: {e!r}", flush=True)
            traceback.print_exc()
            return
        print(f"PASS phase {name} ({time.monotonic() - t0:.1f} s)", flush=True)

    # ---- timing ----
    def time_ms(self, fn, iters=20):
        """Median device time of ``fn`` with L2 flushed before each launch.
        The flush writes 256 MB (~80 us of device time), long enough for
        the host to enqueue the start event and ``fn``'s launches behind
        it, so the measured window holds device work, not host enqueue."""
        torch = self.torch
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
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

    def compare(self, name, got, want, dtype_name, scaled=False, **info):
        """Elementwise ``|got - want| <= tol + tol·|want|``.  With
        ``scaled``, also ``max |got - want| <= tol · max |want|``: for
        outputs whose entries sit far below ``tol``, where the elementwise
        test alone would pass zeros."""
        tol = TOL[dtype_name]
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = int((err > tol + tol * want.abs()).sum())
        finite = bool(self.torch.isfinite(got).all().item())
        max_err, max_ref = float(err.max()), float(want.abs().max())
        row = dict(check=name, dtype=dtype_name, max_abs_err=max_err,
                   atol=tol, rtol=tol, bad=bad, finite=finite, **info)
        if scaled:
            row.update(max_abs_ref=max_ref, err_over_max_ref=max_err / max_ref)
            bad += int(max_err > tol * max_ref)
        emit(row)
        if bad or not finite:
            raise AssertionError(f"{name} [{dtype_name}] out of tolerance: "
                                 f"{bad} failures, max err {max_err}, "
                                 f"max |ref| {max_ref}")
        return max_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(smoke):
    torch = smoke.torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smoke.card = out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    print(smoke.card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}",
          flush=True)


def phase_build(smoke):
    from chainermn_tpu_torch.ops import _build

    t0 = time.monotonic()
    report = _build.build()
    emit({"check": "build", "seconds": round(time.monotonic() - t0, 2),
          "per_source_s": {k: round(v["seconds"], 2) for k, v in report.items()}})
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        _build.library(name)


def _flash_bound(b, s, h, d, causal, elem, dtype_name):
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * d * pairs
    nbytes = 4.0 * b * s * h * d * elem + 4.0 * b * h * s
    return _bound(nbytes, flops, dtype_name)


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_flash(smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import flash_attention, flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, S, H, H_kv, D, causal, timed)
        (8, 512, 16, 16, 64, True, True),     # lm_generate prefill
        (1, 512, 16, 16, 64, True, False),    # serving prefill
        (2, 77, 16, 16, 64, True, False),     # ragged tail
        (2, 77, 16, 16, 64, False, False),    # non-causal
        (2, 512, 16, 8, 64, True, False),     # group 2
        (2, 200, 4, 4, 128, True, False),     # head_dim 128
        (1, 1, 4, 4, 64, True, False),        # one token
        (3, 33, 6, 2, 128, False, False),     # tail inside a tile, group 3
        (1, 1000, 2, 2, 64, False, False),    # long, non-causal
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for b, s, h, hkv, d, causal, timed in cases:
            q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
            k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
            v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, H=h, H_kv=hkv, D=d, causal=causal)
            err = smoke.compare("flash_fwd.out", out, ref, dn, **shape)
            smoke.compare("flash_fwd.lse", lse, ref_lse, dn, **shape)
            if not (timed and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: flash_attention(q, k, v, causal=True))
            plain = smoke.time_ms(
                lambda: flash_attention_plain(q, k, v, causal=True), iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = smoke.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            bound, by = _flash_bound(b, s, h, d, True, q.element_size(), dn)
            smoke.kernel_rows["flash_fwd"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            emit(dict(check="flash_fwd.time", max_abs_err=err, atol=TOL[dn],
                      kernel_ms=ms, plain_ms=plain, library_ms=lib,
                      bound_ms=bound, bound_by=by, **shape))


def check_decode(smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import decode_attend, decode_attend_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    b, s = 8, 1024
    edge_pos = torch.tensor([0, 1, 100, 511, 777, 1022, 1023, 5000],
                            dtype=torch.int32, device="cuda")
    # the serving run's positions: prompts of 512 plus up to 64 new tokens
    serve_pos = torch.randint(512, 576, (b,), generator=g, device="cuda",
                              dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for bs, ss, h, hd, pos in ((3, 7, 2, 128, [0, 3, 100]),
                                   (1, 1, 4, 64, [0])):   # tiny caches
            q = torch.randn(bs, h * hd, generator=g, device="cuda").to(dtype)
            kc, vc = (torch.randn(bs, ss, h * hd, generator=g,
                                  device="cuda").to(dtype) for _ in range(2))
            pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
            smoke.compare(
                "decode_attend",
                decode_attend(q, kc, vc, pos, n_heads=h, head_dim=hd),
                decode_attend_plain(q, kc, vc, pos, n_heads=h, head_dim=hd),
                dn, B=bs, S=ss, H=h, hd=hd, pos="small")
        for h, hd in ((16, 64), (8, 128)):
            d = h * hd
            q = torch.randn(b, d, generator=g, device="cuda").to(dtype)
            kc = torch.randn(b, s, d, generator=g, device="cuda").to(dtype)
            vc = torch.randn(b, s, d, generator=g, device="cuda").to(dtype)
            for label, pos in (("edge", edge_pos), ("scalar", 300),
                               ("serve", serve_pos)):
                out = decode_attend(q, kc, vc, pos, n_heads=h, head_dim=hd)
                ref = decode_attend_plain(q, kc, vc, pos, n_heads=h,
                                          head_dim=hd)
                torch.cuda.synchronize()
                shape = dict(B=b, S=s, H=h, hd=hd, pos=label)
                err = smoke.compare("decode_attend", out, ref, dn, **shape)
                if not (label == "serve" and hd == 64
                        and dtype == torch.bfloat16):
                    continue
                ms = smoke.time_ms(lambda: decode_attend(
                    q, kc, vc, pos, n_heads=h, head_dim=hd))
                plain = smoke.time_ms(lambda: decode_attend_plain(
                    q, kc, vc, pos, n_heads=h, head_dim=hd), iters=5)
                qt = q.view(b, h, 1, hd)
                kt = kc.view(b, s, h, hd).transpose(1, 2)
                vt = vc.view(b, s, h, hd).transpose(1, 2)
                mask = (torch.arange(s, device="cuda")[None, :]
                        <= pos.long()[:, None])[:, None, None, :]
                lib = smoke.time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask))
                n_read = float((pos.long().clamp(max=s - 1) + 1).sum())
                elem = q.element_size()
                nbytes = 2 * b * d * elem + 2 * n_read * d * elem + 4 * b
                bound, by = _bound(nbytes, 4.0 * n_read * d, dn)
                smoke.kernel_rows["decode_attend"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by, library_ms=lib, shape=shape, dtype=dn)
                emit(dict(check="decode_attend.time", max_abs_err=err,
                          atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bound, bound_by=by,
                          **shape))


def check_append(smoke):
    torch = smoke.torch
    from chainermn_tpu_torch.ops import cache_append, cache_append_plain

    g = torch.Generator(device="cuda").manual_seed(3)
    tick_pos = torch.tensor([0, 5, 511, 1023, 1024, 2000, 700, 64],
                            dtype=torch.int32, device="cuda")
    cases = [  # (label, B, S, W, rows, pos)
        ("tick", 8, 1024, 1024, 1, tick_pos),
        ("tick_scalar", 8, 1024, 1024, 1, 1500),
        ("prefill_slab", 1, 512, 1024, 512, 0),
        ("rows4_clamped", 8, 64, 1024, 4, torch.tensor(
            [0, 3, 60, 61, 62, 100, 7, 59], dtype=torch.int32,
            device="cuda")),
        ("odd_width", 3, 10, 1001, 3, torch.tensor(
            [0, 8, 50], dtype=torch.int32, device="cuda")),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for label, b, s, w, rows, pos in cases:
            kc = torch.randn(b, s, w, generator=g, device="cuda").to(dtype)
            vc = torch.randn(b, s, w, generator=g, device="cuda").to(dtype)
            kn = torch.randn(b, rows, w, generator=g, device="cuda").to(dtype)
            vn = torch.randn(b, rows, w, generator=g, device="cuda").to(dtype)
            k1, v1 = kc.clone(), vc.clone()
            k2, v2 = kc.clone(), vc.clone()
            cache_append(k1, v1, kn, vn, pos)
            cache_append_plain(k2, v2, kn, vn, pos)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, W=w, rows=rows, pos=label)
            err = max(smoke.compare("cache_append.k", k1, k2, dn, **shape),
                      smoke.compare("cache_append.v", v1, v2, dn, **shape))
            if err != 0.0:
                raise AssertionError(f"cache_append is a copy, err {err}")
            if not (label == "tick" and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: cache_append(k1, v1, kn, vn, pos))
            plain = smoke.time_ms(
                lambda: cache_append_plain(k2, v2, kn, vn, pos), iters=5)
            bi = torch.arange(b, device="cuda")
            pl = pos.long().clamp(0, s - rows)

            def library():
                k2.index_put_((bi, pl), kn[:, 0])
                v2.index_put_((bi, pl), vn[:, 0])

            lib = smoke.time_ms(library)
            nbytes = 2 * 2 * b * rows * w * kc.element_size() + 4 * b
            bound, by = _bound(nbytes, 0.0, dn)
            smoke.kernel_rows["cache_append"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            emit(dict(check="cache_append.time", max_abs_err=err,
                      atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                      library_ms=lib, bound_ms=bound, bound_by=by, **shape))


def _flash_bwd_bound(b, s, h, h_kv, d, causal, elem, dtype_name):
    """Five (S x S x d) products over the causal half; q, o, do, dq at H
    heads and k, v, dk, dv at H_kv moved once, plus lse and delta."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 5 * 2.0 * b * h * d * pairs
    nbytes = (4 * b * s * h * d + 4 * b * s * h_kv * d) * elem + 8.0 * b * h * s
    return _bound(nbytes, flops, dtype_name)


def check_flash_bwd(smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         flash_attention_bwd_plain,
                                         flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(4)
    # through autograd: the output carries a grad_fn and its backward is
    # the kernel
    qkv = [torch.randn(2, 64, 4, 128, generator=g, device="cuda")
           for _ in range(3)]
    leaves = [x.clone().requires_grad_() for x in qkv]
    out = flash_attention(*leaves, causal=True)
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(out, leaves, torch.ones_like(out))
    if out.grad_fn is None or flash_attention_bwd.launches != before + 1:
        raise AssertionError("flash_attention on CUDA is not differentiated "
                             "by the backward kernel")
    o_ref, lse_ref = flash_attention_plain(*qkv, causal=True)
    ref = flash_attention_bwd_plain(*qkv, o_ref, lse_ref,
                                    torch.ones_like(o_ref), True)
    for n, x, r in zip("qkv", got, ref):
        smoke.compare(f"flash_attention.grad.d{n}", x, r, "float32",
                      B=2, S=64, H=4, D=128, causal=True)
    cases = [  # (B, S, H, H_kv, D, causal, dlse, timed)
        (8, 1024, 8, 8, 128, True, False, True),   # the training step
        (2, 256, 8, 8, 64, True, False, False),    # head_dim 64
        (2, 256, 8, 4, 128, True, False, False),   # group 2
        (2, 77, 4, 4, 128, True, False, False),    # ragged tail
        (3, 77, 6, 2, 64, False, False, False),    # ragged, group 3
        (2, 128, 4, 4, 128, False, True, False),   # LSE cotangent
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for b, s, h, hkv, d, causal, with_dlse, timed in cases:
            q, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            dlse = (torch.randn(b, h, s, generator=g, device="cuda")
                    if with_dlse else None)
            out, lse = flash_attention_plain(q, k, v, causal)
            got = flash_attention_bwd(q, k, v, out, lse, do, causal, dlse)
            ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                            dlse)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, H=h, H_kv=hkv, D=d, causal=causal,
                         dlse=with_dlse)
            err = max(smoke.compare(f"flash_bwd.d{n}", x, r, dn, **shape)
                      for n, x, r in zip("qkv", got, ref))
            del ref
            if not (timed and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: flash_attention_bwd(
                q, k, v, out, lse, do, causal))
            plain = smoke.time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            dot = do.transpose(1, 2).contiguous()
            lib = smoke.time_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True))
            bound, by = _flash_bwd_bound(b, s, h, hkv, d, causal,
                                         q.element_size(), dn)
            smoke.kernel_rows["flash_bwd"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            emit(dict(check="flash_bwd.time", max_abs_err=err, atol=TOL[dn],
                      kernel_ms=ms, plain_ms=plain,
                      library_ms=lib, library="SDPA backward",
                      bound_ms=bound, bound_by=by, **shape))


def _ce_bounds(t, v, d, elem, dtype_name):
    """(bound_ms, bound_by) per CE kernel: h and the table read once, the
    (T,) rows in, the outputs out; 2·T·V·D FLOP for the logits and as many
    again for each gradient product."""
    ins = (t * d + v * d) * elem + 4.0 * t
    return {
        "ce_stats": _bound(ins + 12.0 * t, 2.0 * t * v * d, dtype_name),
        "ce_dh": _bound(ins + 8.0 * t + t * d * elem, 4.0 * t * v * d,
                        dtype_name),
        "ce_dtable": _bound(ins + 8.0 * t + v * d * elem, 4.0 * t * v * d,
                            dtype_name),
    }


def check_ce(smoke):
    torch = smoke.torch
    from chainermn_tpu_torch.ops import (ce_dh, ce_dh_plain, ce_dtable,
                                         ce_dtable_plain, ce_grads_plain,
                                         ce_stats, ce_stats_plain)

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = [  # (T, V, D, timed)
        (TRAIN_BATCH * TRAIN_SEQ, TRAIN["vocab"], TRAIN["d_model"], True),
        (77, 301, 96, False),          # ragged T, V and D tiles
        (512, 32768, 1024, False),     # the train-parity shape
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for t, v, d, timed in cases:
            h = torch.randn(t, d, generator=g, device="cuda").to(dtype)
            tab = (torch.randn(v, d, generator=g, device="cuda")
                   * (2.0 / d) ** 0.5 * 4).to(dtype)
            tgt = torch.randint(0, v, (t,), generator=g, device="cuda")
            tgt[:3] = torch.tensor([-1, v, v + 100])     # pick nothing
            dnll = torch.rand(t, generator=g, device="cuda")
            shape = dict(T=t, V=v, D=d)
            got = ce_stats(h, tab, tgt)
            ref = ce_stats_plain(h, tab, tgt)
            torch.cuda.synchronize()
            errs = {"ce_stats": max(
                smoke.compare(f"ce_stats.{n}", x, r, dn, **shape)
                for n, x, r in zip(("m", "l", "picked"), got, ref))}
            lse = ref[0] + torch.log(ref[1])
            dh_ref, dt_ref = ce_grads_plain(h, tab, tgt, lse, dnll)
            errs["ce_dh"] = smoke.compare(
                "ce_dh", ce_dh(h, tab, tgt, lse, dnll), dh_ref, dn,
                scaled=True, **shape)
            errs["ce_dtable"] = smoke.compare(
                "ce_dtable", ce_dtable(h, tab, tgt, lse, dnll), dt_ref, dn,
                scaled=True, **shape)
            del dh_ref, dt_ref
            if not (timed and dtype == torch.bfloat16):
                continue
            kernels = {
                "ce_stats": (lambda: ce_stats(h, tab, tgt),
                             lambda: ce_stats_plain(h, tab, tgt),
                             lambda: torch.logsumexp(
                                 torch.matmul(h, tab.t()).float(), -1)),
                "ce_dh": (lambda: ce_dh(h, tab, tgt, lse, dnll),
                          lambda: ce_dh_plain(h, tab, tgt, lse, dnll),
                          lambda: torch.matmul(torch.softmax(
                              torch.matmul(h, tab.t()), -1), tab)),
                "ce_dtable": (lambda: ce_dtable(h, tab, tgt, lse, dnll),
                              lambda: ce_dtable_plain(h, tab, tgt, lse,
                                                      dnll),
                              lambda: torch.matmul(torch.softmax(
                                  torch.matmul(h, tab.t()), -1).t(), h)),
            }
            bounds = _ce_bounds(t, v, d, h.element_size(), dn)
            for name, (kern, plain_fn, lib_fn) in kernels.items():
                ms = smoke.time_ms(kern, iters=10)
                plain = smoke.time_ms(plain_fn, iters=3)
                lib = smoke.time_ms(lib_fn, iters=10)
                bound, by = bounds[name]
                smoke.kernel_rows[name] = dict(
                    max_abs_err=errs[name], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib, shape=shape,
                    dtype=dn)
                emit(dict(check=f"{name}.time", max_abs_err=errs[name],
                          atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bound, bound_by=by,
                          **shape))


def _beam_bound(b, r, d, n_read, mode, elem, dtype_name, h):
    """q read once, K and V of every position read once, the mask bytes,
    fp32 (acc, m, l) written; 2·R·D FLOP per position for the scores and
    as many for the values."""
    nbytes = (b * r * d * elem + 2.0 * n_read * d * elem
              + (r * n_read if mode == "amask" else 0.0)
              + 4.0 * b * r * (d + 2 * h))
    return _bound(nbytes, 4.0 * r * n_read * d, dtype_name)


def check_beam(smoke):
    """``beam_attend_parts`` against its plain version: the beam-4 tick's
    two segments at full width (the shared prompt, mode none; the
    generated window, a strided view of the slot caches, mode amask with
    one valid slot per (b, beam, t)), the GQA tick (B 8, 4 KV heads of
    64, g 4, S 1024, pos scalar / per-row / edge), hd 128, S 1, a ragged
    S and 8 or 16 rows per cache row."""
    torch = smoke.torch
    import torch.nn.functional as F
    from chainermn_tpu_torch.ops import beam_attend_parts, beam_attend_parts_plain

    g = torch.Generator(device="cuda").manual_seed(9)

    def one_slot_mask(b, k, t_len):
        """Exactly one valid slot per (b, beam, t), rows t·k + slot."""
        slot = torch.randint(0, k, (b, k, t_len), generator=g, device="cuda")
        m = torch.zeros(b, k, t_len, k, dtype=torch.int8, device="cuda")
        m.scatter_(3, slot[..., None], 1)
        return m.reshape(b, k, t_len * k)

    edge = torch.tensor([0, 1, 100, 511, 777, 1022, 1023, 5000],
                        dtype=torch.int32, device="cuda")
    serve = torch.randint(512, 576, (8,), generator=g, device="cuda",
                          dtype=torch.int32)
    cases = [  # (label, B, S, H, hd, R, mode, pos, window, timed)
        ("beam_prompt", 8, 512, 16, 64, 4, "none", None, False, True),
        ("beam_window", 8, 2048, 16, 64, 4, "amask", None, True, True),
        ("gqa_scalar", 8, 1024, 4, 64, 4, "pos", 700, False, False),
        ("gqa_serve", 8, 1024, 4, 64, 4, "pos", serve, False, True),
        ("gqa_edge", 8, 1024, 4, 64, 4, "pos", edge, False, False),
        ("hd128", 2, 300, 8, 128, 4, "amask", None, True, False),
        ("s1", 3, 1, 4, 64, 2, "none", None, False, False),
        ("ragged", 2, 77, 4, 64, 3, "pos", torch.tensor(
            [10, 76], dtype=torch.int32, device="cuda"), False, False),
        ("rows8", 2, 96, 2, 128, 8, "amask", None, False, False),
        ("rows16", 2, 100, 2, 64, 16, "amask", None, True, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for label, b, s, h, hd, r, mode, pos, window, timed in cases:
            d = h * hd
            q = torch.randn(b * r, d, generator=g, device="cuda").to(dtype)
            rows = s + 64 if window else s
            kfull, vfull = (torch.randn(b, rows, d, generator=g,
                                        device="cuda").to(dtype)
                            for _ in range(2))
            kc, vc = kfull[:, :s], vfull[:, :s]    # strided when window
            amask = None
            if mode == "amask":
                if r == 4 and s % 4 == 0:
                    amask = one_slot_mask(b, 4, s // 4)
                else:
                    amask = (torch.rand(b, r, s, generator=g, device="cuda")
                             > 0.5).to(torch.int8)
                    amask[:, :, 0] = 1
            kw = dict(beams=r, n_heads=h, head_dim=hd)
            args = (q, kc, vc, amask, pos if mode == "pos" else None)
            got = beam_attend_parts(*args, **kw)
            ref = beam_attend_parts_plain(*args, **kw)
            torch.cuda.synchronize()
            shape = dict(B=b, S=s, H=h, hd=hd, R=r, mode=mode, case=label,
                         strided=not kc.is_contiguous())
            err = max(smoke.compare(f"beam_attend.{n}", x, y, dn, **shape)
                      for n, x, y in zip(("acc", "m", "l"), got, ref))
            if not (timed and dtype == torch.bfloat16):
                continue
            ms = smoke.time_ms(lambda: beam_attend_parts(*args, **kw))
            plain = smoke.time_ms(lambda: beam_attend_parts_plain(*args, **kw),
                                  iters=5)
            if mode == "pos":      # GQA: q heads grouped onto KV heads
                qt = q.view(b, r, h, hd).transpose(1, 2).reshape(
                    b, h * r, 1, hd)
                mask = (torch.arange(s, device="cuda")[None, :]
                        <= pos.long()[:, None])[:, None, None, :]
                n_read = float((pos.long().clamp(max=s - 1) + 1).sum())
                lib_kw = dict(attn_mask=mask, enable_gqa=True)
            else:                  # the beam rows as the query length
                qt = q.view(b, r, h, hd).transpose(1, 2)
                mask = None if amask is None else (amask > 0)[:, None]
                n_read = float(b * s)
                lib_kw = dict(attn_mask=mask)
            kt = kc.view(b, s, h, hd).transpose(1, 2)
            vt = vc.view(b, s, h, hd).transpose(1, 2)
            lib = smoke.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **lib_kw))
            bound, by = _beam_bound(b, r, d, n_read, mode, q.element_size(),
                                    dn, h)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                       bound_by=by, library_ms=lib, shape=shape, dtype=dn)
            if label == "beam_window":
                smoke.kernel_rows["beam_attend"] = row
            emit(dict(check="beam_attend.time", max_abs_err=err,
                      atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                      library_ms=lib, library="SDPA", bound_ms=bound,
                      bound_by=by, **shape))


def _conv_bounds(n, h, w, ci, co, k, elem, dtype_name):
    """(bound_ms, bound_by) of wgrad and dgrad: 2·N·H·W·k²·Ci·Co FLOP each;
    wgrad reads x and dy once and writes dW, dgrad reads dy and W once and
    writes dX."""
    flops = 2.0 * n * h * w * k * k * ci * co
    pix = n * h * w
    return {
        "conv_wgrad": _bound((pix * (ci + co) + k * k * ci * co) * elem,
                             flops, dtype_name),
        "conv_dgrad": _bound((pix * (co + ci) + k * k * ci * co) * elem,
                             flops, dtype_name),
    }


def check_conv(smoke):
    """``conv3x3_wgrad`` / ``conv3x3_dgrad`` against their plain versions:
    ResNet-50's three eligible 3x3 shapes at batch 128, the 1x1 at 56² x
    64 → 256, a ragged 7 x 5 plane, a 196-row plane, n = 1 and channel
    counts that are not multiples of 8.  Inputs are scaled so that the
    outputs are O(1), as a training step's gradients are small.  The
    three 3x3 shapes are timed in bf16 beside the plain version and
    cuDNN's ``convolution_backward`` asked for dW alone or dX alone."""
    torch = smoke.torch
    from chainermn_tpu_torch.ops import (conv3x3_dgrad, conv3x3_dgrad_plain,
                                         conv3x3_wgrad, conv3x3_wgrad_plain)

    g = torch.Generator(device="cuda").manual_seed(10)
    cases = [  # (N, H, W, Ci, Co, k, timed)
        (128, 56, 56, 64, 64, 3, True),
        (128, 28, 28, 128, 128, 3, True),
        (128, 14, 14, 256, 256, 3, True),
        (128, 56, 56, 64, 256, 1, False),
        (2, 7, 5, 8, 8, 3, False),
        (4, 14, 14, 64, 64, 3, False),
        (1, 28, 28, 128, 128, 3, False),
        (3, 9, 11, 12, 20, 3, False),
        (2, 15, 13, 36, 44, 1, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for n, h, w, ci, co, k, timed in cases:
            x = torch.randn(n, h, w, ci, generator=g, device="cuda").to(dtype)
            dy = (torch.randn(n, h, w, co, generator=g, device="cuda")
                  / (n * h * w) ** 0.5).to(dtype)
            wt = (torch.randn(k, k, ci, co, generator=g, device="cuda")
                  / (k * k * co) ** 0.5).to(dtype)
            dys = (dy.float() * (n * h * w) ** 0.5).to(dtype)  # O(1) for dgrad
            shape = dict(N=n, H=h, W=w, Ci=ci, Co=co, k=k)
            errs = {
                "conv_wgrad": smoke.compare(
                    "conv_wgrad", conv3x3_wgrad(x, dy, 1, ksize=k),
                    conv3x3_wgrad_plain(x, dy, 1, k), dn, scaled=True,
                    **shape),
                "conv_dgrad": smoke.compare(
                    "conv_dgrad", conv3x3_dgrad(dys, wt, x.shape),
                    conv3x3_dgrad_plain(dys, wt, x.shape), dn, scaled=True,
                    **shape),
            }
            if not (timed and dtype == torch.bfloat16):
                continue
            pad = (k - 1) // 2
            xn, dyn = x.permute(0, 3, 1, 2), dys.permute(0, 3, 1, 2)
            wn = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def cudnn(mask):
                return lambda: torch.ops.aten.convolution_backward(
                    dyn, xn, wn, None, [1, 1], [pad, pad], [1, 1], False,
                    [0, 0], 1, mask)

            kernels = {
                "conv_wgrad": (lambda: conv3x3_wgrad(x, dys, 1, ksize=k),
                               lambda: conv3x3_wgrad_plain(x, dys, 1, k),
                               cudnn([False, True, False])),
                "conv_dgrad": (lambda: conv3x3_dgrad(dys, wt, x.shape),
                               lambda: conv3x3_dgrad_plain(dys, wt, x.shape),
                               cudnn([True, False, False])),
            }
            bounds = _conv_bounds(n, h, w, ci, co, k, x.element_size(), dn)
            for name, (kern, plain_fn, lib_fn) in kernels.items():
                ms = smoke.time_ms(kern)
                plain = smoke.time_ms(plain_fn, iters=5)
                lib = smoke.time_ms(lib_fn)
                bound, by = bounds[name]
                row = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib,
                           shape=shape, dtype=dn)
                if h == 56:
                    smoke.kernel_rows[name] = row
                emit(dict(check=f"{name}.time", max_abs_err=errs[name],
                          atol=TOL[dn], kernel_ms=ms, plain_ms=plain,
                          library_ms=lib, library="cuDNN convolution_backward",
                          bound_ms=bound, bound_by=by, **shape))


def phase_kernels(smoke):
    check_flash(smoke)
    check_decode(smoke)
    check_append(smoke)
    check_flash_bwd(smoke)
    check_ce(smoke)
    check_beam(smoke)
    check_conv(smoke)


def _init_full(torch, device, dtype, max_len, n_kv_heads=None):
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    return init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                  max_len=max_len, dtype=dtype, device=device,
                                  n_kv_heads=n_kv_heads, **FULL)


def _drive(eng, prompts, max_new, first_wave, stagger_every, sample=None):
    """Submit ``first_wave`` requests, then one more every
    ``stagger_every`` steps, and run until every request is finished.
    ``sample[i]`` holds request ``i``'s ``temperature``/``rng`` keywords."""
    def submit(i):
        return eng.submit(prompts[i], max_new, **(sample or {}).get(i, {}))

    handles = [submit(i) for i in range(first_wave)]
    steps = 0
    while len(handles) < len(prompts) or eng.scheduler.queue_depth \
            or eng.pool.busy_count:
        eng.step()
        steps += 1
        if len(handles) < len(prompts) and steps % stagger_every == 0:
            handles.append(submit(len(handles)))
    return handles, steps


def _half_sampled(n, seed, temperature=0.7):
    """Sampling keywords for the odd requests of ``n``: request ``i`` at
    ``temperature`` with the key ``fold_in(PRNGKey(seed), i)``."""
    from chainermn_tpu_torch import prng

    return {i: {"temperature": temperature,
                "rng": prng.fold_in(prng.PRNGKey(seed), i)}
            for i in range(1, n, 2)}


def phase_parity(smoke):
    """fp32 card-vs-CPU token parity: the full-width learned-position model
    (the slice's model) and a small RoPE model (the per-row rotation)
    through the serving engine; the full-width GQA model (4 KV heads) with
    half its requests sampled; beam-4, lazy and physical, at full width."""
    torch = smoke.torch
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    s_p, max_new = 128, 16
    full = _init_full(torch, "cpu", torch.float32, s_p + max_new)
    _parity_case(smoke, "full_width_learned", full, HEAD_DIM, s_p, max_new)
    rope = init_tp_transformer_lm(torch.Generator().manual_seed(1), 512, 256,
                                  4, 2, pos_impl="rope", device="cpu")
    _parity_case(smoke, "small_rope", rope, 64, s_p, max_new)
    for lazy in (True, False):
        _beam_parity(smoke, full, s_p, max_new, lazy)
    del full
    gqa = _init_full(torch, "cpu", torch.float32, s_p + max_new,
                     n_kv_heads=GQA_KV_HEADS)
    _parity_case(smoke, "full_width_gqa_sampled", gqa, HEAD_DIM, s_p,
                 max_new, sample=_half_sampled(4, 7))


def _cpu_choice_values(params_cpu, head_dim, prompt, tokens, t, kw):
    """The CPU's values behind token ``t`` of a request: its logits, or
    for a sampled request the scored values ``logits / T + gumbel`` with
    the noise of that position."""
    import numpy as np
    import torch

    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch.parallel.decode import lm_prefill

    ctx = np.concatenate([prompt, np.asarray(tokens[:t], np.int32)])
    with torch.inference_mode():
        h, _ = lm_prefill(params_cpu, torch.tensor(ctx[None], dtype=torch.long),
                          len(ctx), head_dim=head_dim)
        logits = h[0, -1].float() @ params_cpu["embed"].float().t()
    if not kw:
        return logits
    key = prng.fold_in(prng.fold_in(kw["rng"], len(ctx)), 0)
    temp = torch.tensor(kw["temperature"], dtype=torch.float32)
    return logits / temp + prng.gumbel(key, (1, logits.shape[0]))[0]


def _parity_case(smoke, label, params_cpu, head_dim, s_p, max_new,
                 sample=None):
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.serving import ServingEngine

    n_req = 4
    vocab = params_cpu["embed"].shape[0]
    prompts = np.random.RandomState(5).randint(
        0, vocab, (n_req, s_p)).astype(np.int32)
    results = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(params_cpu, head_dim=head_dim, n_slots=4,
                            max_total=s_p + max_new, queue_capacity=8,
                            device=dev)
        handles, _ = _drive(eng, list(prompts), max_new, 2, 2, sample)
        results[dev] = [h.tokens for h in handles]
        if not all(h.status == "done" for h in handles):
            raise AssertionError(f"{label} {dev}: not every request done")
        eng.close()
    near_ties, equal = 0, 0
    for i, (a, c) in enumerate(zip(results["cuda"], results["cpu"])):
        if a == c:
            equal += 1
            continue
        t = next(j for j in range(max_new) if a[j] != c[j])
        kw = (sample or {}).get(i)
        vals = _cpu_choice_values(params_cpu, head_dim, prompts[i], c, t, kw)
        gap = abs(float(vals[a[t]]) - float(vals[c[t]]))
        emit({"check": "parity.mismatch", "model": label, "request": i,
              "sampled": kw is not None, "step": t, "card_token": a[t],
              "cpu_token": c[t], "cpu_value_gap": gap})
        if gap >= 1e-3:
            raise AssertionError(f"{label} request {i} step {t}: tokens "
                                 f"{a[t]} vs {c[t]} with CPU gap {gap} "
                                 f">= 1e-3")
        near_ties += 1
    emit({"check": "parity", "model": label, "requests": n_req,
          "sampled": sorted(sample or {}), "equal": equal,
          "near_ties": near_ties, "dtype": "float32"})


def _seq_logprob(torch, params_cpu, head_dim, prompt, toks):
    """The CPU's cumulative log-probability of ``toks`` after ``prompt``."""
    import numpy as np

    from chainermn_tpu_torch.parallel.decode import lm_prefill

    full = np.concatenate([prompt, np.asarray(toks, np.int32)])
    with torch.inference_mode():
        h, _ = lm_prefill(params_cpu, torch.tensor(full[None], dtype=torch.long),
                          len(full), head_dim=head_dim)
        logits = h[0, len(prompt) - 1:-1].float() @ \
            params_cpu["embed"].float().t()
        logp = torch.log_softmax(logits, -1)
    return float(logp.gather(1, torch.tensor(toks, dtype=torch.long)[:, None]
                             ).sum())


def _beam_parity(smoke, params_cpu, s_p, max_new, lazy):
    """Beam-4 at full width, card vs CPU: the best beams equal, or the
    card's scores within 1e-3 of the CPU's best under the CPU's model."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.convert import tree_map
    from chainermn_tpu_torch.parallel import make_lm_beam_generator

    prompts = np.random.RandomState(10).randint(
        0, FULL["vocab"], (2, s_p)).astype(np.int32)
    gen = make_lm_beam_generator(head_dim=HEAD_DIM, max_new_tokens=max_new,
                                 beam_size=4, lazy_reorder=lazy)
    card = gen(tree_map(params_cpu, lambda t: t.to("cuda")), prompts).cpu()
    cpu = gen(params_cpu, prompts)
    label = "beam4_lazy" if lazy else "beam4_physical"
    near_ties = 0
    for i in range(prompts.shape[0]):
        a, c = card[i].tolist(), cpu[i].tolist()
        if a == c:
            continue
        la, lc = (_seq_logprob(torch, params_cpu, HEAD_DIM, prompts[i], x)
                  for x in (a, c))
        emit({"check": "parity.mismatch", "model": label, "row": i,
              "card_logprob": la, "cpu_logprob": lc})
        if abs(la - lc) >= 1e-3:
            raise AssertionError(f"{label} row {i}: card beam log-prob {la} "
                                 f"vs CPU {lc}")
        near_ties += 1
    emit({"check": "parity", "model": label, "rows": prompts.shape[0],
          "equal": prompts.shape[0] - near_ties, "near_ties": near_ties,
          "new_tokens": max_new, "prompt": s_p, "dtype": "float32"})


SERVE = dict(requests=16, prompt=512, new=64, max_total=1024, slots=8)


def _serve_run(smoke, label, params, seed, sample=None):
    """16 staggered requests (prompt 512, 64 new) through an 8-slot
    ServingEngine on the card, launch counts zeroed just before and read
    just after; every request must finish ``done`` with 64 tokens in the
    vocabulary.  Emits the run's line and returns ``(launches, ticks)``."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.serving import ServingEngine

    n_req, s_p, max_new = SERVE["requests"], SERVE["prompt"], SERVE["new"]
    prompts = np.random.RandomState(seed).randint(
        0, FULL["vocab"], (n_req, s_p)).astype(np.int32)
    eng = ServingEngine(params, head_dim=HEAD_DIM, n_slots=SERVE["slots"],
                        max_total=SERVE["max_total"], queue_capacity=n_req,
                        device="cuda")
    prefill_ms, tick_ms = [], []

    def timed(fn, sink):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)          # ends in a device-to-host read
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    eng.engine.prefill_into_slot = timed(eng.engine.prefill_into_slot,
                                         prefill_ms)
    eng.engine.tick = timed(eng.engine.tick, tick_ms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles, steps = _drive(eng, list(prompts), max_new, SERVE["slots"], 2,
                           sample)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    smoke.add_launches(launches)
    done = sum(h.status == "done" for h in handles)
    m = eng.metrics()
    n_tok = sum(len(h.tokens) for h in handles)
    emit({"check": label, "dtype": "bfloat16", "requests": n_req,
          "sampled": sorted(sample or {}), "done": done, "steps": steps,
          "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
          "ms_per_token": wall * 1e3 / n_tok,
          "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
          "prefill_ms_p50": _percentile(prefill_ms, 0.5),
          "tick_ms_p50": _percentile(tick_ms, 0.5),
          "tick_ms_p99": _percentile(tick_ms, 0.99),
          "ticks": len(tick_ms), "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "metrics": m})
    eng.close()
    if done != n_req:
        raise AssertionError(f"{label}: {done}/{n_req} requests finished done")
    for h in handles:
        if len(h.tokens) != max_new or not all(
                0 <= t < FULL["vocab"] for t in h.tokens):
            raise AssertionError(f"{label} request {h.id}: bad tokens "
                                 f"{h.tokens[:8]}")
    return launches, len(tick_ms)


def phase_serving(smoke):
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import make_lm_generator

    s_p, max_new = SERVE["prompt"], SERVE["new"]
    params = _init_full(torch, "cuda", torch.bfloat16, SERVE["max_total"])
    launches, _ = _serve_run(smoke, "serving", params, 6)
    missing = [k for k in ("flash_fwd", "decode_attend", "cache_append")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")

    gen = make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=max_new)
    batch = np.random.RandomState(7).randint(
        0, FULL["vocab"], (8, s_p)).astype(np.int32)
    gen(params, batch[:, :16])  # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = gen(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(toks.shape) != (8, max_new):
        raise AssertionError(f"lm_generate shape {tuple(toks.shape)}")
    emit({"check": "lm_generate", "dtype": "bfloat16", "B": 8, "prompt": s_p,
          "new_tokens": max_new, "wall_s": wall,
          "tokens_per_s": 8 * max_new / wall,
          "ms_per_token_step": wall * 1e3 / max_new,
          "launches": ops.launch_counts()})


def phase_beam(smoke):
    """bf16 at ``bench_decode``'s full width: beam 4 with the lazy reorder
    (B 8, prompt 512, 512 new tokens), and beside it the prefill alone and
    the greedy ``lm_generate`` of the same size, for ``bench_decode``'s
    decode rates (a run's wall less the prefill's, per new token)."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import (make_lm_beam_generator,
                                              make_lm_generator)

    b, s_p, new, k = (BEAM[x] for x in ("batch", "prompt", "new",
                                        "beam_size"))
    n_layers = FULL["n_layers"]
    params = _init_full(torch, "cuda", torch.bfloat16, s_p + new)
    prompt = np.random.RandomState(0).randint(
        0, FULL["vocab"], (b, s_p)).astype(np.int32)
    make_lm_beam_generator(head_dim=HEAD_DIM, max_new_tokens=4, beam_size=k)(
        params, prompt[:, :16])   # warm-up

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(params, prompt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, prefill_s = run(make_lm_generator(head_dim=HEAD_DIM, max_new_tokens=1))
    greedy, greedy_s = run(make_lm_generator(head_dim=HEAD_DIM,
                                             max_new_tokens=new))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, beam_s = run(make_lm_beam_generator(
        head_dim=HEAD_DIM, max_new_tokens=new, beam_size=k,
        lazy_reorder=True))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.add_launches(launches)
    greedy_dec, beam_dec = greedy_s - prefill_s, beam_s - prefill_s
    emit({"check": "beam", "dtype": "bfloat16", **BEAM, **FULL,
          "lazy_reorder": True, "prefill_ms": prefill_s * 1e3,
          "beam_wall_s": beam_s, "greedy_wall_s": greedy_s,
          "beam4_tokens_per_s": b * new / beam_dec,
          "beam4_ms_per_token": beam_dec * 1e3 / new,
          "greedy_tokens_per_s": b * new / greedy_dec,
          "greedy_ms_per_token": greedy_dec * 1e3 / new,
          "beam_over_greedy_tokens_per_s": greedy_dec / beam_dec,
          "peak_mem_gb": peak, "launches": launches,
          "best_beam_equals_greedy_rows": int(
              (toks.cpu() == greedy.cpu()).all(1).sum())})
    if tuple(toks.shape) != (b, new) or not bool(
            ((toks >= 0) & (toks < FULL["vocab"])).all()):
        raise AssertionError(f"beam tokens: shape {tuple(toks.shape)} or "
                             f"out of the vocabulary")
    # per tick: two segments per layer through the beam kernel, one append
    # per layer; the prefill appends once per layer and runs flash forward
    want = {"beam_attend": 2 * n_layers * (new - 1),
            "cache_append": n_layers * (new - 1) + n_layers,
            "flash_fwd": n_layers, "decode_attend": 0}
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if wrong:
        raise AssertionError(f"beam launches (got, want): {wrong}")


def phase_serving_gqa(smoke):
    """bf16, the GQA model (4 KV heads, g 4): 16 requests through the
    ServingEngine, the odd half sampled at temperature 0.7; the beam
    kernel must run every layer of every tick."""
    torch = smoke.torch

    params = _init_full(torch, "cuda", torch.bfloat16, SERVE["max_total"],
                        n_kv_heads=GQA_KV_HEADS)
    launches, ticks = _serve_run(smoke, "serving_gqa", params, 11,
                                 _half_sampled(SERVE["requests"], 12))
    want = {"beam_attend": FULL["n_layers"] * ticks, "decode_attend": 0}
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if wrong or not launches["cache_append"] or not launches["flash_fwd"]:
        raise AssertionError(f"GQA serving launches (got, want): {wrong}; "
                             f"{launches}")


def _tree_to(torch, params, device):
    from chainermn_tpu_torch.convert import tree_map

    return tree_map(params, lambda t: t.detach().to(device).clone())


def _make_step(torch, params, head_dim, ce_impl, lr=1e-2):
    """The training step the smoke drives: SGD through
    ``make_hybrid_shard_map_step`` with flash attention, updating
    ``params`` in place."""
    from functools import partial

    from chainermn_tpu_torch.parallel import (make_hybrid_shard_map_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    return make_hybrid_shard_map_step(
        partial(tp_transformer_lm_loss, head_dim=head_dim, attn_impl="flash",
                ce_impl=ce_impl),
        torch.optim.SGD(param_leaves(params), lr=lr), params)


def _train_run(torch, step, params, steps, tokens):
    """``steps`` calls of ``step``; returns (losses, per-step ms), each
    step ended by the device-to-host read of its loss and a synchronise."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, (tokens,))))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def phase_train_parity(smoke):
    """fp32, card vs CPU: two SGD steps from the same weights."""
    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch.convert import flatten
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              tp_transformer_lm_loss)

    seq, batch = 256, 2
    cfg = dict(TRAIN, n_layers=2)
    head_dim = cfg["d_model"] // cfg["n_heads"]
    cpu = init_tp_transformer_lm(torch.Generator().manual_seed(3),
                                 max_len=seq, device="cpu", **cfg)
    tokens = np.random.RandomState(8).randint(
        0, cfg["vocab"], (batch, seq + 1))
    runs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(torch, cpu, dev)
        batch_t = (torch.as_tensor(tokens, device=dev),)
        flat = flatten(params)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        loss = tp_transformer_lm_loss(params, batch_t, head_dim=head_dim,
                                      attn_impl="flash", ce_impl="fused")
        grads[dev] = {k: g.detach().cpu() for k, g in zip(
            flat, torch.autograd.grad(loss, list(flat.values())))}
        del loss
        step = _make_step(torch, params, head_dim, "fused")
        losses = [float(step(params, batch_t)) for _ in range(2)]
        runs[dev] = (losses, {k: v.detach().float().cpu()
                              for k, v in flat.items()})
    (lc, pc), (lh, ph) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    worst = max(float((pc[k] - ph[k]).abs().max()) for k in ph)
    grad_rel = {k: float((grads["cuda"][k] - g).norm()
                         / g.norm().clamp_min(1e-30))
                for k, g in grads["cpu"].items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    emit({"check": "train_parity", "dtype": "float32", "card_losses": lc,
          "cpu_losses": lh, "loss_max_rel_err": rel,
          "param_max_abs_err": worst, "rtol": 1e-4, "atol": 1e-4,
          "grad_max_rel_norm_err": grad_rel[worst_grad],
          "grad_worst_param": worst_grad,
          "embed_grad_rel_norm_err": grad_rel["embed"], **cfg,
          "S": seq, "B": batch})
    if rel > 1e-4 or worst > 1e-4 or grad_rel[worst_grad] > 1e-4:
        raise AssertionError(f"train parity: loss rel err {rel}, param "
                             f"abs err {worst}, grad rel norm err "
                             f"{grad_rel[worst_grad]} ({worst_grad})")


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_train(smoke):
    """bf16 at full width: the fused-CE path (2 warm-up + 10 timed steps),
    then 3 ``ce_impl="auto"`` steps from the same initial weights."""
    import math

    import numpy as np

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.convert import flatten
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm

    head_dim = TRAIN["d_model"] // TRAIN["n_heads"]
    params = init_tp_transformer_lm(torch.Generator().manual_seed(0),
                                    max_len=TRAIN_SEQ, dtype=torch.bfloat16,
                                    device="cuda", **TRAIN)
    initial = _tree_to(torch, params, "cuda")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN_SEQ + 1)), device="cuda")
    n_params = sum(t.numel() for t in flatten(params).values())
    toks = TRAIN_BATCH * TRAIN_SEQ
    flops = (6.0 * n_params
             + 12.0 * TRAIN["n_layers"] * TRAIN["d_model"] * TRAIN_SEQ) * toks
    step = _make_step(torch, params, head_dim, "fused")
    warm, _ = _train_run(torch, step, params, 2, tokens)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, ms = _train_run(torch, step, params, 10, tokens)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.add_launches(launches)
    p50 = _percentile(ms, 0.5)
    emit({"check": "train", "dtype": "bfloat16", "ce_impl": "fused",
          **TRAIN, "S": TRAIN_SEQ, "B": TRAIN_BATCH, "n_params": n_params,
          "warmup_losses": warm, "losses": losses, "step_ms": ms,
          "step_ms_p50": p50, "step_ms_p99": _percentile(ms, 0.99),
          "tokens_per_s": toks / (p50 / 1e3),
          "mfu_analytic": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
          "peak_mem_gb": peak, "launches": launches})
    every = warm + losses
    if not all(math.isfinite(x) for x in every) or not every[-1] < every[0]:
        raise AssertionError(f"train losses not finite and falling: {every}")
    n_layers, n = TRAIN["n_layers"], len(losses)
    want = {"flash_fwd": n_layers * n, "flash_bwd": n_layers * n,
            "ce_stats": n, "ce_dh": n, "ce_dtable": n}
    wrong = {k: (launches[k], w) for k, w in want.items() if launches[k] != w}
    if wrong:
        raise AssertionError(f"training launches (got, want): {wrong}")
    del step, params

    ops.reset_launch_counts()
    auto, auto_ms = _train_run(torch, _make_step(torch, initial, head_dim,
                                                 "auto"), initial, 3, tokens)
    rel = abs(auto[0] - every[0]) / abs(every[0])
    emit({"check": "train", "dtype": "bfloat16", "ce_impl": "auto",
          "losses": auto, "step_ms": auto_ms,
          "first_loss_rel_err_vs_fused": rel, "rtol": 2e-2,
          "launches": ops.launch_counts()})
    if rel > 2e-2:
        raise AssertionError(f"auto vs fused first loss: rel err {rel}")


def phase_resnet_parity(smoke):
    """fp32 (TF32 off), card vs CPU from the same weights: ResNet-50 at image
    112 (stages 1-2 eligible at 28² and 14², the stride-2 and 7x7 convs
    fall back), batch 4, ``conv_impl="pallas"``: the loss and every
    gradient, then two ``make_flax_train_step`` steps (SGD 0.1, momentum
    0.9, wd 1e-4) at world 1, the card's group over NCCL and the CPU's
    over gloo.  The weights are the random init: each block's last
    BatchNorm scale starts at 0, so the first backward gives the conv
    kernels zero gradients and the second step's runs them on live ones.
    (Scales redrawn to open every branch make this 50-layer ReLU network
    chaotic in fp32: a 1e-7 relative change of the input moves the CPU's
    own gradients by ~0.25% in norm, as ReLUs and max-pool windows flip,
    so no card could be held to 1e-4 there.)"""
    torch = smoke.torch
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import ARCHS, cross_entropy_loss
    from chainermn_tpu_torch.ops import conv3x3_dgrad, conv3x3_wgrad
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_flax_train_step, shard_batch
    from chainermn_tpu_torch.train_imagenet import synthetic_batch

    image, batch = 112, 4
    comms = {dev: create_communicator("xla", device=dev)   # the card's first
             for dev in ("cuda", "cpu")}
    ref = ARCHS["resnet50"](dtype=torch.float32, conv_impl="pallas", seed=3,
                            device="cpu")
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    x, y = synthetic_batch(batch, image, seed=5)
    runs, grads = {}, {}
    for dev, comm in comms.items():
        model = ARCHS["resnet50"](dtype=torch.float32, conv_impl="pallas",
                                  device=dev)
        model.load_state_dict(weights)
        names = [n for n, _ in model.named_parameters()]
        model.train()
        before = (conv3x3_wgrad.launches, conv3x3_dgrad.launches)
        loss = cross_entropy_loss(model(torch.from_numpy(x).to(dev)),
                                  torch.from_numpy(y).to(dev))
        grads[dev] = {n: g.detach().cpu() for n, g in zip(
            names, torch.autograd.grad(loss, list(model.parameters())))}
        launched = (conv3x3_wgrad.launches - before[0],
                    conv3x3_dgrad.launches - before[1])
        if dev == "cuda" and launched != (6, 6):
            raise AssertionError(f"the card's backward launched (wgrad, "
                                 f"dgrad) {launched}, want (6, 6)")
        model.load_state_dict(weights)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                            weight_decay=1e-4), comm)
        step = make_flax_train_step(
            model, lambda logits, b: (cross_entropy_loss(logits, b[1]), {}),
            opt, mesh=comm.mesh)
        b = shard_batch((x, y), comm.device, comm.mesh)
        losses = [float(step(model, b)[0]) for _ in range(2)]
        runs[dev] = (float(loss.detach()), losses,
                     {k: v.detach().float().cpu()
                      for k, v in model.state_dict().items()})
    (l0c, lc, pc), (l0h, lh, ph) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip([l0c] + lc, [l0h] + lh))
    worst = max(ph, key=lambda k: float((pc[k] - ph[k]).abs().max()))
    worst_err = float((pc[worst] - ph[worst]).abs().max())
    grad_rel = {k: float((grads["cuda"][k] - g).norm()
                         / g.norm().clamp_min(1e-30))
                for k, g in grads["cpu"].items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    emit({"check": "resnet_parity", "dtype": "float32", "arch": "resnet50",
          "image": image, "B": batch, "card_losses": [l0c] + lc,
          "cpu_losses": [l0h] + lh, "loss_max_rel_err": rel,
          "state_max_abs_err": worst_err, "state_worst": worst,
          "grad_max_rel_norm_err": grad_rel[worst_grad],
          "grad_worst_param": worst_grad, "rtol": 1e-4, "atol": 1e-4,
          "conv_launches_per_backward": 6})
    if rel > 1e-4 or worst_err > 1e-4 or grad_rel[worst_grad] > 1e-4:
        raise AssertionError(f"resnet parity: loss rel err {rel}, state abs "
                             f"err {worst_err} ({worst}), grad rel norm err "
                             f"{grad_rel[worst_grad]} ({worst_grad})")


def _resnet_run(torch, step, model, batch, steps):
    """``steps`` synchronised steps: (losses, per-step ms)."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)[0]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def phase_resnet_train(smoke):
    """bf16, ``bench.py``'s headline through the port's entry points
    (``train_imagenet.build_step``: create_communicator → ResNet-50 →
    create_multi_node_optimizer → make_flax_train_step, world 1 over a
    one-rank NCCL group), ``conv_impl="pallas"``: 2 warm-up and 10 timed
    steps; then the same with ``conv_impl="xla"`` (cuDNN's backward) from
    the same weights as the yardstick."""
    import math

    torch = smoke.torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.train import shard_batch
    from chainermn_tpu_torch.train_imagenet import build_step, synthetic_batch

    image, per_card = RESNET["image"], RESNET["batch"]
    flops = RESNET_FLOPS_PER_IMAGE * (image / 224.0) ** 2 * per_card
    rows, weights = {}, None
    for impl in ("pallas", "xla"):
        step, model, comm = build_step(RESNET["arch"], image, conv_impl=impl,
                                       num_classes=RESNET["classes"])
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        batch = shard_batch(synthetic_batch(per_card * comm.size, image,
                                            RESNET["classes"]),
                            comm.device, comm.mesh)
        ops.reset_launch_counts()
        warm, _ = _resnet_run(torch, step, model, batch, 2)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, ms = _resnet_run(torch, step, model, batch, 10)
        launches = ops.launch_counts()
        p50 = _percentile(ms, 0.5)
        rows[impl] = {
            "check": "resnet_train", "dtype": "bfloat16", "conv_impl": impl,
            **RESNET, "world": comm.size,
            "n_params": sum(p.numel() for p in model.parameters()),
            "warmup_losses": warm, "losses": losses, "step_ms": ms,
            "step_ms_p50": p50, "step_ms_p99": _percentile(ms, 0.99),
            "images_per_s": per_card / (p50 / 1e3),
            "mfu_analytic": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}
        if impl == "pallas":
            smoke.add_launches(launches)
        del step, model, batch
        torch.cuda.empty_cache()
    pal, xla = rows["pallas"], rows["xla"]
    first = abs(xla["warmup_losses"][0] - pal["warmup_losses"][0]) \
        / abs(pal["warmup_losses"][0])
    xla.update(first_loss_rel_err_vs_pallas=first, rtol=2e-2,
               step_ms_p50_pallas_minus_xla=pal["step_ms_p50"]
               - xla["step_ms_p50"],
               images_per_s_pallas_over_xla=pal["images_per_s"]
               / xla["images_per_s"])
    emit(pal)
    emit(xla)
    every = pal["warmup_losses"] + pal["losses"] + xla["warmup_losses"] \
        + xla["losses"]
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"resnet losses not finite: {every}")
    n = len(pal["losses"])
    want = {"conv_wgrad": RESNET_CONV_LAUNCHES * n,
            "conv_dgrad": RESNET_CONV_LAUNCHES * n}
    wrong = {k: (pal["launches"][k], w) for k, w in want.items()
             if pal["launches"][k] != w}
    wrong.update({f"xla {k}": (xla["launches"][k], 0) for k in want
                  if xla["launches"][k] != 0})
    if wrong:
        raise AssertionError(f"resnet conv launches (got, want): {wrong}")
    if first > 2e-2:
        raise AssertionError(f"xla vs pallas first loss: rel err {first}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL phase device: torch.cuda.is_available() is False",
              flush=True)
        return 1
    try:
        import chainermn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL phase device: the chainermn_tpu_torch package is not "
              f"importable from here: {e!r}", flush=True)
        return 1

    # fp32 comparisons (kernel checks, parity) must not run in TF32, which
    # keeps ~3 decimal digits: both matmul and cuDNN TF32 are off for the run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    smoke.card = "unknown"
    smoke.phase("device", lambda: phase_device(smoke))
    smoke.phase("build", lambda: phase_build(smoke))
    if "build" not in smoke.failed:
        for name, fn in (("kernels", phase_kernels), ("parity", phase_parity),
                         ("serving", phase_serving), ("beam", phase_beam),
                         ("serving-gqa", phase_serving_gqa),
                         ("train-parity", phase_train_parity),
                         ("train", phase_train),
                         ("resnet-parity", phase_resnet_parity),
                         ("resnet-train", phase_resnet_train)):
            smoke.phase(name, lambda fn=fn: fn(smoke))
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = smoke.kernel_rows.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": smoke.launches.get(name, 0),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")})
    if torch.distributed.is_initialized():     # the ResNet phases' group
        torch.distributed.destroy_process_group()
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", flush=True)
        return 1
    emit({"kernels": kernels})
    print(smoke.card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
