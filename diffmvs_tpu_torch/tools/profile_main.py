"""Where the time goes on the card: the main inference path under
torch.profiler.

    python3 -m diffmvs_tpu_torch.tools.profile_main [--requests 2]

Builds DepthRunner.from_random("casdiffmvs", device="cuda", seed=0) at
DTU size (1152x1600, 5 views, 48/384 hypotheses, f32), answers one
warm-up request, then profiles --requests more. Prints the card, the
wall time per request, the device's busy time and idle share over the
profiled window, the device time per kernel group, and the top kernels.
Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("warp_corr", "warp_corr (hand-written)"),
    ("memcpy", "host-to-device copy"),
    ("bn_fw", "normalization"), ("moments", "normalization"),
    ("tonchw", "layout transform"), ("tonhwc", "layout transform"),
    ("conv", "convolution"), ("implicit", "convolution"),
    ("xmma", "convolution"), ("cudnn", "convolution"),
    ("gemm", "matmul"), ("norm", "normalization"),
    ("fft", "convolution"), ("region_transform", "convolution"),
    ("reduce", "reduction"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("index", "gather/index"), ("gather", "gather/index"),
    ("cat", "copy/cat"), ("copy", "copy/cat"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: CUDA is not available")

    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    hh, ww, views = 1152, 1600, 5
    runner = DepthRunner.from_random("casdiffmvs", image_hw=(hh, ww),
                                     views=views, device="cuda", seed=0)
    inputs = synthetic_inputs(1, views, hh, ww, 384, seed=0)
    runner(*inputs)                                      # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(args.requests):
            t0 = time.perf_counter()
            runner(*inputs)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

    per_kernel = collections.Counter()
    counts = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.device_time_total if hasattr(ev, "device_time_total") \
                else ev.cuda_time_total
            per_kernel[ev.name] += us
            counts[ev.name] += 1
    if not per_kernel:
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=args.top))
        raise SystemExit("profile_main: the trace holds no device events")
    busy_ms = sum(per_kernel.values()) / 1e3 / args.requests
    req_ms = sum(wall) / len(wall)
    groups = collections.Counter()
    for name, us in per_kernel.items():
        groups[group_of(name)] += us / 1e3 / args.requests
    print(f"card: {smi}")
    print(json.dumps({
        "request_ms": [round(w, 3) for w in wall],
        "device_busy_ms_per_request": round(busy_ms, 3),
        "device_idle_share": round(max(0.0, 1.0 - busy_ms / req_ms), 4),
        "groups_ms_per_request": {k: round(v, 3)
                                  for k, v in groups.most_common()},
    }))
    for name, us in per_kernel.most_common(args.top):
        print(f"{us / 1e3 / args.requests:9.3f} ms/req "
              f"{counts[name] // args.requests:5d}x  {name[:110]}")


if __name__ == "__main__":
    main()
