#!/usr/bin/env python3
"""Where the time of a chainermn_tpu_torch ResNet-50 data-parallel step goes, on one card.

Builds ``bench.py``'s headline step through the port's entry points
(``train_imagenet.build_step``: ResNet-50, image 224, batch 128, bf16,
SGD 0.1 / momentum 0.9 / wd 1e-4 through the multi-node optimizer, world
1 over a one-rank NCCL group) for each ``--conv-impl`` (default: pallas,
then xla), and profiles ``--steps`` steps after two warm-up steps under
``torch.profiler``.  Prints one JSON line per impl: the host wall per
step, the device busy time (union of kernel, memcpy and memset
intervals), the device idle share, the device ops per step, the device
time by kernel name (top entries) and by class (the hand-written conv
kernels, cuDNN's convs, NCCL, reductions, copies, elementwise), and the
device time of each hand-written conv kernel (``conv_wgrad``, its reduce,
``conv_dgrad``); then the
card's name and power limit.  Chrome traces go to ``--out-dir``.  Needs
a card.

    python3 scripts/profile_torch_resnet.py --steps 5 --out-dir chiprun_out
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_serving import _summarise  # noqa: E402


# device-time classes, first match wins
_CLASSES = (
    ("conv kernels (hand-written)", ("(anonymous namespace)::conv_",)),
    ("cuDNN convs", ("xmma", "cudnn", "implicit_gemm", "conv2d", "wgrad",
                     "dgrad", "fprop", "sm90_")),
    ("NCCL", ("nccl",)),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise",)),
)


def _breakdown(trace_path, steps):
    """Device ms per step by class, and of the hand-written conv kernels
    by kernel."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_class, conv = defaultdict(float), defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ms, name = e["dur"] / 1e3 / steps, e["name"]
        cls = next((c for c, keys in _CLASSES
                    if any(k in name for k in keys)), "other")
        by_class[cls] += ms
        if cls == _CLASSES[0][0]:
            conv[name.split("::")[1].split("<")[0]] += ms
    return dict(by_class), dict(conv)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--conv-impl", nargs="+", default=["pallas", "xla"],
                        choices=["pallas", "xla"])
    parser.add_argument("--out-dir", default="profile")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch.train import shard_batch
    from chainermn_tpu_torch.train_imagenet import build_step, synthetic_batch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    image, per_card = 224, 128
    for impl in args.conv_impl:
        step, model, comm = build_step("resnet50", image, conv_impl=impl)
        batch = shard_batch(synthetic_batch(per_card * comm.size, image),
                            comm.device, comm.mesh)
        for _ in range(2):                               # warm-up
            step(model, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                loss, _ = step(model, batch)
            float(loss)                                  # waits for the card
            wall = time.perf_counter() - t0
        trace = os.path.join(args.out_dir, f"profile_resnet_{impl}.json")
        prof.export_chrome_trace(trace)
        row = _summarise(trace, wall, args.steps, f"resnet50_step_{impl}")
        classes, conv = _breakdown(trace, args.steps)
        row["device_ms_per_step_by_class"] = classes
        row["conv_kernel_device_ms_per_step"] = conv
        row["loss"] = float(loss)
        print(json.dumps(row), flush=True)
        del step, model, batch, prof
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
