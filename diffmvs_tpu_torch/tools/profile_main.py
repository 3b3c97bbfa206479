"""Where the time goes on the card: the main inference path, or a
training step, under torch.profiler.

    python3 -m diffmvs_tpu_torch.tools.profile_main [--requests 2] [--train]
        [--dtype bf16] [--batch 16]

Default: DepthRunner.from_random("casdiffmvs", device="cuda", seed=0) at
DTU size (1152x1600, 5 views, 48/384 hypotheses) answers one warm-up
request, then --requests more are profiled; --batch view-sets a
request (default 1). The inputs are uploaded to the card once, before
the warm-up, as the bench entry holds them. --train: the training cell
instead (CasDiffMVS, B=4, 5 views, 512x640, 48/384 hypotheses, random
init from seed 0, a synthetic batch): one warm-up train_step, then
--requests steps. --dtype: the conv stacks' compute dtype, f32 (default)
or bf16, the configuration bench.py serves and trains in (with remat on
for training, as bench.py's training cell has it). Prints the card, the wall time per request or step, the
device's busy time and idle share over the profiled window, the device
time per kernel group, and the top kernels. Needs CUDA; fails without it.
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
    ("warp_corr_bwd", "warp_corr backward (K2, hand-written)"),
    # K1 and K3 are instances of warp_geom::corr_kernel
    ("sweepsamples", "warp_corr (K1, hand-written)"),
    ("cornersamples", "warp_corr_pre (K3, hand-written)"),
    ("warp_corr", "warp_corr (K1, hand-written)"),
    ("multi_tensor", "optimizer"),
    ("bn_bw", "normalization"),
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


DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def request_work(dtype, batch=1):
    """One export request at DTU size, `batch` view-sets (the inputs on
    the card already)."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    hh, ww, views = 1152, 1600, 5
    runner = DepthRunner.from_random("casdiffmvs", image_hw=(hh, ww),
                                     views=views, device="cuda", seed=0,
                                     compute_dtype=DTYPES[dtype])
    imgs, projs, dv = synthetic_inputs(batch, views, hh, ww, 384, seed=0)
    inputs = (torch.from_numpy(imgs).cuda(),
              {k: torch.from_numpy(v).cuda() for k, v in projs.items()},
              torch.from_numpy(dv).cuda())
    return lambda: runner(*inputs)


def train_work(dtype):
    """One train step of the training cell (the batch is uploaded from
    host memory in every step, as in run_training)."""
    import dataclasses

    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    model = dataclasses.replace(MODEL_PRESETS["casdiffmvs"],
                                compute_dtype=DTYPES[dtype],
                                remat=dtype == "bf16")
    cfg = TrainConfig(model=model, batch_size=4, seed=0)
    state = create_train_state(cfg, steps_per_epoch=100, device="cuda",
                               seed=0)
    batch = synthetic_train_batch(4, 5, 512, 640, 384, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return lambda: train_step(state, cfg, batch, gen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--train", action="store_true",
                    help="profile train steps of the training cell")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="f32",
                    help="compute dtype of the conv stacks")
    ap.add_argument("--batch", type=int, default=1,
                    help="view-sets a request (inference only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: CUDA is not available")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    work = (train_work(args.dtype) if args.train
            else request_work(args.dtype, args.batch))
    work()                                               # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(args.requests):
            t0 = time.perf_counter()
            work()
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
    unit = "step" if args.train else "request"
    groups = collections.Counter()
    for name, us in per_kernel.items():
        groups[group_of(name)] += us / 1e3 / args.requests
    print(f"card: {smi}")
    print(json.dumps({
        "dtype": args.dtype,
        "batch": 4 if args.train else args.batch,
        f"{unit}_ms": [round(w, 3) for w in wall],
        f"device_busy_ms_per_{unit}": round(busy_ms, 3),
        "device_idle_share": round(max(0.0, 1.0 - busy_ms / req_ms), 4),
        f"groups_ms_per_{unit}": {k: round(v, 3)
                                  for k, v in groups.most_common()},
    }))
    for name, us in per_kernel.most_common(args.top):
        print(f"{us / 1e3 / args.requests:9.3f} ms/{unit[:3]} "
              f"{counts[name] // args.requests:5d}x  {name[:110]}")


if __name__ == "__main__":
    main()
