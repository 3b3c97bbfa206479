"""Where the time goes on the card: the main inference path, or a
training step, under torch.profiler.

    python3 -m diffmvs_tpu_torch.tools.profile_main [--requests 2] [--train]
        [--dtype bf16] [--batch 16] [--host] [--ops]

Default: DepthRunner.from_random("casdiffmvs", device="cuda", seed=0) at
DTU size (1152x1600, 5 views, 48/384 hypotheses) answers one warm-up
request, then --requests more are profiled; --batch view-sets a
request (default 1). The inputs are uploaded to the card once, before
the warm-up, as the bench entry holds them; with --host each request
sends its view-set from host memory and takes its answers back to host
memory, as one client does. --train: the training cell instead
(CasDiffMVS, B=4, 5 views, 512x640, 48/384 hypotheses, random init from
seed 0, a synthetic batch in pinned host memory, uploaded in every step
as run_training's loader hands it over): one warm-up train_step, then
--requests steps. --dtype: the conv stacks' compute dtype, f32 (default)
or bf16, the configuration bench.py serves and trains in (with remat on
for training, as bench.py's training cell has it).

Prints the card, the wall time per request or step, the device's busy
time and idle share over the profiled window, the device time per kernel
group and the top kernels. Then, from the program's spans
(utils/profiling.py) over the profiled requests or steps: by span, its
host self ms, its device ms (the model's stages) and its counters a
request or step; the counters of set-up (the kernels' build, with its
seconds); and the longest idle gaps of the card, each labelled with the
innermost span (its "diffmvs." range in the trace) the host was in when
it opened. --ops records the operators' input shapes and prints the
device time by kernel and the outermost aten operator that launched it,
with its input shapes (which module a kernel belongs to). Needs CUDA;
fails without it.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from diffmvs_tpu_torch.utils import profiling

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("warp_corr_bwd", "warp_corr backward (K2, hand-written)"),
    # K1 and K3 are instances of warp_geom::corr_kernel
    ("sweepsamples", "warp_corr (K1, hand-written)"),
    ("cornersamples", "warp_corr_pre (K3, hand-written)"),
    ("warp_corr", "warp_corr (K1, hand-written)"),
    ("pvw_conv3d", "PixelViewWeight (hand-written)"),
    ("feature_stem", "FeatureNet stem (hand-written)"),
    ("cost_prob", "CostRegNet prob conv (hand-written)"),
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


def request_work(dtype, batch=1, host=False):
    """One export request at DTU size, `batch` view-sets (on the card
    already, or with host from host memory, its answers back there)."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    hh, ww, views = 1152, 1600, 5
    runner = DepthRunner.from_random("casdiffmvs", image_hw=(hh, ww),
                                     views=views, device="cuda", seed=0,
                                     compute_dtype=DTYPES[dtype])
    imgs, projs, dv = synthetic_inputs(batch, views, hh, ww, 384, seed=0)
    if host:
        def request():
            depth, confs = runner(imgs, projs, dv)
            return depth.cpu().numpy(), [c.cpu().numpy() for c in confs]
        return request
    inputs = (torch.from_numpy(imgs).cuda(),
              {k: torch.from_numpy(v).cuda() for k, v in projs.items()},
              torch.from_numpy(dv).cuda())
    return lambda: runner(*inputs)


def pinned(tree):
    """A nested dict of numpy arrays as pinned host tensors."""
    if isinstance(tree, dict):
        return {k: pinned(v) for k, v in tree.items()}
    return torch.from_numpy(tree).pin_memory()


def train_work(dtype):
    """One train step of the training cell (the batch is uploaded from
    pinned host memory in every step, as in run_training)."""
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
    batch = pinned(synthetic_train_batch(4, 5, 512, 640, 384, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    return lambda: train_step(state, cfg, batch, gen)


def span_rows(units):
    """By span name over `units` (profiling.Unit), each a unit: calls,
    host self ms, device ms (None where the span takes none) and the
    counters credited to it."""
    rows = {}
    for u in units:
        for sp in u.spans:
            r = rows.setdefault(sp.name, {"calls": 0, "self_ms": 0.0,
                                          "device_ms": None,
                                          "counts": collections.Counter()})
            r["calls"] += 1
            r["self_ms"] += (sp.ns - sp.child_ns) / 1e6
            ms = sp.device_ms()
            if ms is not None:
                r["device_ms"] = (r["device_ms"] or 0.0) + ms
            r["counts"].update(sp.counts or {})
    n = max(len(units), 1)
    return {name: {"calls": r["calls"] / n,
                   "self_ms": r["self_ms"] / n,
                   "device_ms": (None if r["device_ms"] is None
                                 else r["device_ms"] / n),
                   "counts": {k: v / n for k, v in r["counts"].items()}}
            for name, r in rows.items()}


def labelled_gaps(kernels, spans, top=10):
    """The `top` longest idle gaps between the card's busy intervals:
    [(ms, label, name of the kernel before it)], each labelled with the
    innermost span (the shortest) the host was in when it opened.
    kernels, spans: (start, end, name) on one timeline (µs)."""
    busy = []
    for s, e, _ in sorted(kernels):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    ends = {}
    for s, e, name in kernels:
        ends.setdefault(e, name)
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        inside = [sp for sp in spans if sp[0] <= e0 <= sp[1]]
        label = (min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside
                 else "outside the program's spans")
        gaps.append(((s1 - e0) / 1e3, label, ends.get(e0, "?")))
    return sorted(gaps, reverse=True)[:top]


def op_rows(events, requests, top):
    """The `top` (kernel, operator, input shapes) triples by device ms a
    request: each kernel credited to the outermost aten operator above
    the CPU event that launched it (that event itself where none is)."""
    ms = collections.Counter()
    calls = collections.Counter()
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        op, up = ev, ev.cpu_parent
        while up is not None:
            if up.name.startswith("aten::"):
                op = up
            up = up.cpu_parent
        for k in ev.kernels:
            key = (k.name, op.name, str(op.input_shapes))
            ms[key] += k.duration / 1e3 / requests
            calls[key] += 1
    return [(v, calls[key] // requests, *key)
            for key, v in ms.most_common(top)]


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
    ap.add_argument("--host", action="store_true",
                    help="each request's view-set from host memory, its "
                         "answers back there (inference only)")
    ap.add_argument("--ops", action="store_true",
                    help="device time by kernel and launching operator "
                         "with its input shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: CUDA is not available")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    work = (train_work(args.dtype) if args.train
            else request_work(args.dtype, args.batch, args.host))
    work()                                               # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts, acc_events=True,
                                record_shapes=args.ops) as prof:
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
    if args.ops:
        for ms, n, kernel, op, shapes in op_rows(prof.events(),
                                                 args.requests, 4 * args.top):
            print(f"{ms:9.3f} ms/{unit[:3]} {n:5d}x  {kernel[:60]}  {op} "
                  f"{shapes[:160]}")
    print_spans(prof, unit)


def print_spans(prof, unit):
    """The program's spans over the profiled units (the module's note)."""
    units = [u for u in profiling.units() if u.profiled]
    rows = span_rows(units)
    build = profiling.totals().get("warp_corr.build", {})
    print(json.dumps({
        f"spans_per_{unit}": {
            name: {"calls": r["calls"], "self_ms": round(r["self_ms"], 3),
                   "device_ms": (None if r["device_ms"] is None
                                 else round(r["device_ms"], 3)),
                   **{k: round(v, 1) for k, v in r["counts"].items()}}
            for name, r in sorted(rows.items(),
                                  key=lambda kv: -kv[1]["self_ms"])},
        "setup": {"build.compiled": profiling.counter("build.compiled"),
                  "build.found": profiling.counter("build.found"),
                  "build_s": round(build.get("host_ms", 0.0) / 1e3, 3)},
    }))
    kernels, ranges = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.name.startswith(profiling.PREFIX):
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges.append((tr.start, tr.end,
                               ev.name[len(profiling.PREFIX):]))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end, ev.name))
    for ms, label, prev in labelled_gaps(kernels, ranges):
        print(f"{ms:9.3f} ms idle, host in {label}; after {prev[:100]}")


if __name__ == "__main__":
    main()
