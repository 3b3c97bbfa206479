"""K1 and K2 on the card at the main path's and the training cell's
shapes: CUDA-event times with L2 warm and with L2 flushed, beside each
kernel's bound.

    python3 diffmvs_tpu_torch/tools/kernel_times.py [--root DIR]

--root is the checkout whose diffmvs_tpu_torch is timed (default: the one
this file belongs to), so that one timing code times two trees in one
call on one card, e.g. an earlier commit unpacked with `git archive`
(each tree builds its own kernels under its own build/). Inputs are made
on the card from fixed seeds, the same for every tree. Prints one JSON
line: the kernel module timed, the card (`nvidia-smi` name and power
limit) and, per kernel and shape, the median ms warm (with and without
the host's launch gap) and L2-cold, and the bound. Needs CUDA; fails
without it.

chip_smoke.py takes its timing, bounds and inputs from here too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
L2_FLUSH_BYTES = 128 * 2**20   # written between launches: > the 50 MB L2
SPIN_CYCLES = 1_000_000        # ~0.5 ms of clock cycles queued ahead of a
                               # timed call (torch.cuda._sleep)

# name: (stage key, D, C, scale); G = 4 throughout
INFER_SHAPES = {"sweep": ("stage1", 48, 48, 8),
                "stage2": ("stage2", 4, 32, 4),
                "stage3": ("stage3", 4, 16, 2),
                "diffmvs_refine": ("stage2", 6, 32, 4)}
TRAIN_SHAPES = {k: INFER_SHAPES[k] for k in ("sweep", "stage2", "stage3")}
INFER_HW, TRAIN_HW, TRAIN_B, VIEWS = (1152, 1600), (512, 640), 4, 5


def cuda_ms(fn, reps=20, warmup=3, cold=False, spin=False):
    """Median CUDA-event time of fn() in ms, inputs warm in L2. The events
    hold the card's time and any gap in which the card waits for the host
    to enqueue fn's launches. With spin=True a spin of SPIN_CYCLES is
    queued before each timed call, so the card has the launches in hand
    when it reaches them: the time is the card's alone. With cold=True L2
    is flushed before each timed call by writing L2_FLUSH_BYTES (outside
    the events), and the spin follows the flush: a cold time is the
    card's alone too."""
    if cold:
        with torch.inference_mode(False):
            flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold:
            flush.fill_(1.0)
        if spin or cold:
            # keep the card busy while the host enqueues the events and
            # fn's launches, so the events time the kernels, not the host
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(fn):
    """{ms, card_ms, cold_ms} of fn(): cuda_ms warm with the host's gap,
    warm without it (spin) and L2-cold (without it too)."""
    return dict(ms=cuda_ms(fn), card_ms=cuda_ms(fn, spin=True),
                cold_ms=cuda_ms(fn, cold=True))


def bound(nbytes, ops):
    """Least time (ms) at the card's memory rate and f32 rate, and which
    of the two bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def warp_bound(n, d, h, w, hs, ws, c, g, feat_bytes):
    """K1: each input read once and the output written once, against the
    operations it needs (coordinates ~20 per plane-pixel, 11 per channel
    for the three lerps and the product-accumulate, 1 per group mean)."""
    nbytes = (n * g * d * h * w * 4 + n * h * w * c * feat_bytes
              + n * hs * ws * c * feat_bytes + n * d * h * w * 4 + n * 48)
    return bound(nbytes, n * d * h * w * (20 + 11 * c + g))


def bwd_bound(n, d, h, w, hs, ws, c, g, inside, corners):
    """K2: g, src, ref, depth read once, d_src and d_ref written once,
    against ~20 operations per sample for the coordinates, 9 per channel of
    an in-image sample (re-sampling, the d_ref product-accumulate, the
    scatter value) and 2 per channel of an in-image corner (its weight and
    its atomic add)."""
    nbytes = 4 * (n * g * d * h * w + 2 * n * hs * ws * c + 2 * n * h * w * c
                  + n * d * h * w) + n * 48
    return bound(nbytes, 20 * n * d * h * w + 9 * c * inside + 2 * c * corners)


def sample_counts(sp, rp, depth, hs, ws):
    """(samples, samples with a corner in the image, in-image corners) of
    one warp call: the work K2 does on these inputs."""
    from diffmvs_tpu_torch.geometry.transforms import relative_projection
    from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
    rot, trans = relative_projection(sp.float(), rp.float())
    x, y = plane_sweep_coords(rot, trans, depth)
    x0, y0 = x.floor(), y.floor()
    inside = (x0 >= -1) & (x0 <= ws - 1) & (y0 >= -1) & (y0 <= hs - 1)
    vx = (x0 >= 0, x0 <= ws - 2)
    vy = (y0 >= 0, y0 <= hs - 2)
    corners = sum(int((inside & a & b).sum()) for a in vy for b in vx)
    return x.numel(), int(inside.sum()), corners


def k2_global_atomics(sp, rp, depth, hs, ws, c):
    """(128-bit global atomics K2 sends on these inputs, the scalar ones of
    one atomic per channel per in-image corner that the design before it
    sent). K2 (warp_corr_bwd.cu) holds each corner slot's sum in registers
    while a pixel's sample stays on one source pixel from plane to plane,
    and adds it to d_src, C/4 threads one float4 each, when the slot moves
    to another pixel or the planes end: replayed here from the coordinates.
    Assumes the float4 path (C/G % 4 == 0, aligned bases)."""
    from diffmvs_tpu_torch.geometry.transforms import relative_projection
    from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
    rot, trans = relative_projection(sp.float(), rp.float())
    x, y = plane_sweep_coords(rot, trans, depth)
    x0, y0 = x.floor(), y.floor()
    inside = (x0 >= -1) & (x0 <= ws - 1) & (y0 >= -1) & (y0 <= hs - 1)
    x0 = torch.where(inside, x0, 0.0).long()
    y0 = torch.where(inside, y0, 0.0).long()
    cols = ((x0.clamp_min(0), x0 >= 0),
            ((x0 + 1).clamp_max(ws - 1), x0 <= ws - 2))
    rows = ((y0.clamp_min(0), y0 >= 0),
            ((y0 + 1).clamp_max(hs - 1), y0 <= hs - 2))
    starts = corners = 0
    for yq, vy in rows:
        for xq, vx in cols:
            key = yq * ws + xq
            valid = inside & vy & vx
            held = torch.full_like(key[:, 0], -1)
            for d in range(key.shape[1]):
                start = valid[:, d] & (key[:, d] != held)
                starts += int(start.sum())
                held = torch.where(valid[:, d], key[:, d], held)
            corners += int(valid.sum())
    return starts * (c // 4), corners * c


def make_depth(name, n, d, h, w, dev, gen, smooth=False):
    """Sweep planes 4..10 m, or refinement hypotheses 0.05 m apart around
    a depth of 4..10 m drawn per pixel, or with smooth=True, a depth map
    that varies over ~16 pixels as a scene's does (bilinear from a 1/16
    grid); all with degenerate depths (zero, behind the camera, tiny and
    huge) in the first row."""
    if name == "sweep":
        inv = torch.arange(d, device=dev) / (d - 1.0)
        depth = 1.0 / (0.1 + 0.15 * inv)
        depth = depth.reshape(1, d, 1, 1).expand(n, d, h, w).contiguous()
    else:
        if smooth:
            coarse = torch.rand(n, 1, h // 16 + 2, w // 16 + 2, device=dev,
                                generator=gen)
            base = 4.0 + 6.0 * torch.nn.functional.interpolate(
                coarse, size=(h, w), mode="bilinear", align_corners=True)
        else:
            base = 4.0 + 6.0 * torch.rand(n, 1, h, w, device=dev,
                                          generator=gen)
        offs = (torch.arange(d, device=dev) - d / 2) * 0.05
        depth = (base + offs.reshape(1, d, 1, 1)).contiguous()
    depth[:, :, 0, :4] = torch.tensor([0.0, -5.0, 1e-30, 1e30], device=dev)
    return depth


def shape_inputs(name, n, hw, dev, gen, smooth=False):
    """(src/ref projection pairs of the widest baseline, depths, D, C,
    h, w) of one shape of INFER_SHAPES at image size hw."""
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs
    stage, d, c, s = INFER_SHAPES[name]
    h, w = hw[0] // s, hw[1] // s
    _, projs, _ = synthetic_inputs(n, VIEWS, hw[0], hw[1], 384)
    pairs = torch.from_numpy(projs[stage]).to(dev)
    depth = make_depth(name, n, d, h, w, dev, gen, smooth)
    return pairs[:, VIEWS - 1], pairs[:, 0], depth, d, c, h, w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from diffmvs_tpu_torch.ops import warp_corr
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    warp_corr.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"module": warp_corr.__file__, "smi": smi,
           "k1": {}, "k2": {}}
    # the refinement shapes also with smooth depth maps (make_depth)
    cases = [(name, False) for name in INFER_SHAPES] + [
        (name, True) for name in INFER_SHAPES if name != "sweep"]
    for name, smooth in cases:
        sp, rp, depth, d, c, h, w = shape_inputs(name, 1, INFER_HW, dev, gen,
                                                 smooth)
        rt = warp_corr.projection_scalars(sp, rp)
        src32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            src, ref = src32.to(dt), ref32.to(dt)
            with torch.inference_mode():
                times = timings(lambda: warp_corr.warp_corr_rt(
                    src, ref, rt, depth, 4))
            b, _ = warp_bound(1, d, h, w, h, w, c, 4, src.element_size())
            key = f"{name}{':smooth' if smooth else ''}:{tag}"
            res["k1"][key] = dict(**times, bound_ms=b)
    cases = [(name, False) for name in TRAIN_SHAPES] + [
        (name, True) for name in TRAIN_SHAPES if name != "sweep"]
    for name, smooth in cases:
        sp, rp, depth, d, c, h, w = shape_inputs(name, TRAIN_B, TRAIN_HW,
                                                 dev, gen, smooth)
        rt = warp_corr.projection_scalars(sp, rp)
        src = torch.randn(TRAIN_B, h, w, c, device=dev, generator=gen)
        ref = torch.randn(TRAIN_B, h, w, c, device=dev, generator=gen)
        g = torch.randn(TRAIN_B, 4, d, h, w, device=dev, generator=gen)
        times = timings(lambda: warp_corr.warp_corr_backward(
            src, ref, rt, depth, g, 4))
        _, inside, corners = sample_counts(sp, rp, depth, h, w)
        b, _ = bwd_bound(TRAIN_B, d, h, w, h, w, c, 4, inside, corners)
        res["k2"][name + (":smooth" if smooth else "")] = dict(
            **times, bound_ms=b)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
