"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. device       -- needs CUDA; prints the card's name and power limit;
                     TF32 off
  2. build        -- compiles both kernels with nvcc, side by side: K1
                     (ops/csrc/warp_corr.cu) and K2 (warp_corr_bwd.cu)
  3. kernel       -- K1 against its plain PyTorch version at the inference
                     path's shapes (and DiffMVS's refinement shape), f32
                     and bf16 features, with CUDA-event times and the bound
  4. train_kernel -- K2 against autograd of the plain version at the
                     training shapes (B=4 at 512x640: the sweep and the two
                     refinement stages) with degenerate depths, plus
                     batched odd sizes through the vector and scalar paths;
                     times, bound, atomic counts
  5. small        -- the port on CUDA against the port on the CPU (the path
                     the CPU tests hold against JAX), same weights, 64x96
  6. main         -- CasDiffMVS export inference at DTU size (1152x1600, 5
                     views, 48/384 hypotheses, f32, random weights from
                     seed 0): 3 requests through DepthRunner; 28 K1
                     launches each; the first request again with the plain
                     warp in place of the kernel must agree
  7. train_small  -- one train step of the port on CUDA against the same
                     step on the CPU at 64x96 (same weights, batch,
                     timesteps and noise): loss and gradient direction
  8. train        -- the training cell: CasDiffMVS f32, B=4, 5 views,
                     512x640, 48/384 hypotheses, random init from seed 0,
                     run_training over 5 steps (the first a warm-up): 28
                     K1 + 28 K2 launches and a finite loss and gradient
                     norm every step; one step's gradients against the
                     same step with the plain warp in place of the kernels
Then a JSON line of per-kernel numbers (K1's launches from main, K2's from
train), the nvidia-smi line, and last {"ok": true, "device": {...}}.

Imports torch and the port only; nothing of JAX.
"""

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
CORR_TOL = dict(rtol=1e-4, atol=1e-5)
REPO = Path(__file__).resolve().parent


def check(cond, what):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms (warm L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def bwd_bound(n, d, h, w, hs, ws, c, g, inside, corners):
    """K2: g, src, ref, depth read once, d_src and d_ref written once,
    against ~20 operations per sample for the coordinates, 9 per channel of
    an in-image sample (re-sampling, the d_ref product-accumulate, the
    scatter value) and 2 per channel of an in-image corner (its weight and
    its atomic add)."""
    nbytes = 4 * (n * g * d * h * w + 2 * n * hs * ws * c + 2 * n * h * w * c
                  + n * d * h * w) + n * 48
    return bound(nbytes, 20 * n * d * h * w + 9 * c * inside + 2 * c * corners)


def flat_grads(model):
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).flatten()
                      for p in model.parameters()]).double()


def cosine(a, b):
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))


def phase_kernel(run):
    """K1 against its plain version at the inference shapes."""
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    dev, gen = run["dev"], run["gen"]
    hh, ww, views = 1152, 1600, 5
    _, projs, _ = synthetic_inputs(1, views, hh, ww, 384)
    shapes = {  # name: (stage key, D, C, scale), G = 4 throughout
        "sweep": ("stage1", 48, 48, 8),
        "stage2": ("stage2", 4, 32, 4),
        "stage3": ("stage3", 4, 16, 2),
        "diffmvs_refine": ("stage2", 6, 32, 4),
    }
    for name, (stage, d, c, s) in shapes.items():
        h, w = hh // s, ww // s
        pairs = torch.from_numpy(projs[stage]).to(dev)
        sp, rp = pairs[:, views - 1], pairs[:, 0]       # widest baseline
        depth = make_depth(name, 1, d, h, w, dev, gen)
        src32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        row = {}
        with torch.inference_mode():
            for dt in (torch.float32, torch.bfloat16):
                src, ref = src32.to(dt), ref32.to(dt)
                got = warp_corr.warp_corr(src, ref, sp, rp, depth, 4)
                want = warp_and_correlate_plain(src.float(), ref.float(),
                                                sp, rp, depth, 4)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **CORR_TOL)
                err = (got - want).abs().max().item()
                off = (want == 0).all(-1).float().mean().item()
                rt = warp_corr.projection_scalars(sp, rp)
                ms = cuda_ms(lambda: warp_corr.warp_corr_rt(
                    src, ref, rt, depth, 4))
                plain_ms = cuda_ms(lambda: warp_and_correlate_plain(
                    src.float(), ref.float(), sp, rp, depth, 4))
                bound_ms, bound_by = warp_bound(
                    1, d, h, w, h, w, c, 4, src.element_size())
                tag = "f32" if dt == torch.float32 else "bf16"
                log("kernel", shape=name, dtype=tag, D=d, C=c,
                    hw=f"{h}x{w}", max_abs_err=f"{err:.3e}",
                    off_image=f"{off:.3f}", ms=f"{ms:.4f}",
                    plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                    bound_by=bound_by)
                row[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
        run["k1_rows"][(d, h, w, c)] = (name, row["f32"])

    # batched samples with their own projections, odd sizes, and the
    # scalar-load path (C/G = 3) next to the vector path (C/G = 4)
    for c in (12, 16):
        n, d, h, w = 2, 5, 37, 53
        sp, rp = odd_pairs(projs, dev)
        depth = 4.0 + 6.0 * torch.rand(n, d, h, w, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            src = torch.randn(n, h + 3, w - 2, c, device=dev,
                              generator=gen).to(dt)
            ref = torch.randn(n, h, w, c, device=dev, generator=gen).to(dt)
            with torch.inference_mode():
                got = warp_corr.warp_corr(src, ref, sp, rp, depth, 4)
                want = warp_and_correlate_plain(src.float(), ref.float(),
                                                sp, rp, depth, 4)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **CORR_TOL)
    log("kernel", shape="batched_odd", N=2, C="12,16", hw="37x53",
        src_hw="40x51", result="match")


def make_depth(name, n, d, h, w, dev, gen):
    """Sweep planes 4..10 m, or random refinement hypotheses; both with
    degenerate depths (zero, behind the camera, tiny and huge) in the
    first row."""
    if name == "sweep":
        inv = torch.arange(d, device=dev) / (d - 1.0)
        depth = 1.0 / (0.1 + 0.15 * inv)
        depth = depth.reshape(1, d, 1, 1).expand(n, d, h, w).contiguous()
    else:
        base = 4.0 + 6.0 * torch.rand(n, 1, h, w, device=dev, generator=gen)
        offs = (torch.arange(d, device=dev) - d / 2) * 0.05
        depth = (base + offs.reshape(1, d, 1, 1)).contiguous()
    depth[:, :, 0, :4] = torch.tensor([0.0, -5.0, 1e-30, 1e30], device=dev)
    return depth


def odd_pairs(projs, dev):
    pairs = torch.from_numpy(projs["stage1"]).to(dev)
    sp = torch.stack([pairs[0, 1], pairs[0, 3]])
    rp = torch.stack([pairs[0, 0], pairs[0, 0]])
    return sp, rp


def grads_of(fn, src, ref, g_out):
    """(d_src, d_ref) of fn(src, ref) for the cotangent g_out."""
    src = src.detach().requires_grad_()
    ref = ref.detach().requires_grad_()
    return torch.autograd.grad(fn(src, ref), (src, ref), g_out)


def phase_train_kernel(run):
    """K2 against autograd of the plain version at the training shapes."""
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    dev, gen = run["dev"], run["gen"]
    n, hh, ww, views = 4, 512, 640, 5
    _, projs, _ = synthetic_inputs(n, views, hh, ww, 384)
    shapes = {"sweep": ("stage1", 48, 48, 8),
              "stage2": ("stage2", 4, 32, 4),
              "stage3": ("stage3", 4, 16, 2)}
    for name, (stage, d, c, s) in shapes.items():
        h, w = hh // s, ww // s
        pairs = torch.from_numpy(projs[stage]).to(dev)
        sp, rp = pairs[:, views - 1], pairs[:, 0]
        depth = make_depth(name, n, d, h, w, dev, gen)
        src = torch.randn(n, h, w, c, device=dev, generator=gen)
        ref = torch.randn(n, h, w, c, device=dev, generator=gen)
        g = torch.randn(n, 4, d, h, w, device=dev, generator=gen)
        g_out = g.permute(0, 2, 3, 4, 1)                # [N, D, H, W, G]

        want = grads_of(lambda a, b: warp_and_correlate_plain(
            a, b, sp, rp, depth, 4), src, ref, g_out)
        got = grads_of(lambda a, b: warp_corr.warp_corr(
            a, b, sp, rp, depth, 4), src, ref, g_out)
        torch.cuda.synchronize()
        for k, wnt, what in zip(got, want, ("d_src", "d_ref")):
            torch.testing.assert_close(k, wnt, **CORR_TOL, msg=lambda m: (
                f"{name} {what}: {m}"))
        err = max((k - wnt).abs().max().item() for k, wnt in zip(got, want))

        rt = warp_corr.projection_scalars(sp, rp)
        ms = cuda_ms(lambda: warp_corr.warp_corr_backward(
            src, ref, rt, depth, g, 4))
        src_p = src.detach().requires_grad_()
        ref_p = ref.detach().requires_grad_()
        out_p = warp_and_correlate_plain(src_p, ref_p, sp, rp, depth, 4)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            out_p, (src_p, ref_p), g_out, retain_graph=True))
        del out_p
        samples, inside, corners = sample_counts(sp, rp, depth, h, w)
        bound_ms, bound_by = bwd_bound(n, d, h, w, h, w, c, 4, inside,
                                       corners)
        log("train_kernel", shape=name, N=n, D=d, C=c, hw=f"{h}x{w}",
            max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, atomic_adds=corners * c,
            in_image_samples=f"{inside / samples:.3f}")
        run["k2_rows"][(d, h, w, c)] = (name, dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by))

    for c in (12, 16):
        n, d, h, w = 2, 5, 37, 53
        sp, rp = odd_pairs(projs, dev)
        depth = 4.0 + 6.0 * torch.rand(n, d, h, w, device=dev, generator=gen)
        src = torch.randn(n, h + 3, w - 2, c, device=dev, generator=gen)
        ref = torch.randn(n, h, w, c, device=dev, generator=gen)
        g_out = torch.randn(n, d, h, w, 4, device=dev, generator=gen)
        want = grads_of(lambda a, b: warp_and_correlate_plain(
            a, b, sp, rp, depth, 4), src, ref, g_out)
        got = grads_of(lambda a, b: warp_corr.warp_corr(
            a, b, sp, rp, depth, 4), src, ref, g_out)
        torch.cuda.synchronize()
        for k, wnt in zip(got, want):
            torch.testing.assert_close(k, wnt, **CORR_TOL)
    log("train_kernel", shape="batched_odd", N=2, C="12,16", hw="37x53",
        src_hw="40x51", result="match")


def phase_small(run):
    """The CUDA path against the CPU path on a small input."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    small = dict(numdepth_initial=8, numdepth=32, scale=(0.0, 0.0, 0.0))
    imgs_s, projs_s, dv_s = synthetic_inputs(1, 3, 64, 96, 32, seed=1)
    outs = []
    for device in ("cpu", "cuda"):
        runner = DepthRunner.from_random("casdiffmvs", device=device,
                                         seed=0, **small)
        depth_s, _ = runner(imgs_s, projs_s, dv_s)
        outs.append(depth_s.cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=5e-3, atol=5e-3)
    log("small", hw="64x96", max_abs_diff_cuda_vs_cpu=(
        f"{(outs[1] - outs[0]).abs().max().item():.3e}"))


def phase_main(run):
    """CasDiffMVS export inference at DTU size, 3 requests."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.models import stages
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    hh, ww, views = 1152, 1600, 5
    runner = DepthRunner.from_random("casdiffmvs", image_hw=(hh, ww),
                                     views=views, device="cuda", seed=0,
                                     numdepth_initial=48, numdepth=384)
    requests = [synthetic_inputs(1, views, hh, ww, 384, seed=i)
                for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    results, req_ms = [], []
    for imgs, pr, dv in requests:
        before = warp_corr.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth, confs = runner(imgs, pr, dv)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        results.append((depth, confs))
        check(warp_corr.launches - before == 28,
              f"{warp_corr.launches - before} launches in one request")
    launches = warp_corr.launches
    by_shape = dict(warp_corr.launches_by_shape)
    check(warp_corr.bwd_launches == 0, "K2 launched during inference")
    peak = torch.cuda.max_memory_allocated()

    for depth, confs in results:
        check(depth.shape == (1, hh, ww), f"depth shape {depth.shape}")
        check(len(confs) == 3 and all(cf.shape == (1, hh, ww)
                                      for cf in confs), "3 full-res confs")
        check(bool(torch.isfinite(depth).all()) and all(
            bool(torch.isfinite(cf).all()) for cf in confs), "finite")
    check(launches == 28 * len(requests), f"{launches} kernel launches")
    check(sorted(by_shape.values()) == [12, 36, 36], f"by shape {by_shape}")
    run["k1_launches"] = by_shape

    # the first request once more, the plain warp in place of the kernel
    dispatch = stages.warp_and_correlate
    stages.warp_and_correlate = warp_and_correlate_plain
    try:
        depth_plain, _ = runner(*requests[0])
    finally:
        stages.warp_and_correlate = dispatch
    rel = ((results[0][0] - depth_plain).abs()
           / depth_plain.abs().clamp_min(1e-12))
    check(rel.mean().item() < 1e-4, f"plain vs kernel {rel.mean().item()}")
    steady = statistics.mean(req_ms[1:])
    log("main", requests=len(requests),
        request_ms=repr([round(m, 1) for m in req_ms]),
        maps_per_s=f"{1e3 / steady:.3f}",
        peak_mem_gib=f"{peak / 2**30:.3f}",
        launches=launches, launches_per_request=launches // len(requests),
        plain_vs_kernel_mean_rel=f"{rel.mean().item():.3e}",
        plain_vs_kernel_max_rel=f"{rel.max().item():.3e}")


def phase_train_small(run):
    """One train step on CUDA against the same step on the CPU, 64x96."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step
    from diffmvs_tpu_torch.utils.synthetic import (
        synthetic_train_batch, synthetic_train_overrides)

    model_cfg = dataclasses.replace(MODEL_PRESETS["casdiffmvs"],
                                    numdepth_initial=8, numdepth=32)
    cfg = TrainConfig(model=model_cfg, batch_size=2)
    batch = synthetic_train_batch(2, 3, 64, 96, 32, seed=1)
    overrides = synthetic_train_overrides(model_cfg, 2, 64, 96, seed=2)
    res = []
    for device in ("cpu", "cuda"):
        state = create_train_state(cfg, steps_per_epoch=1, device=device,
                                   seed=0)
        scalars, images = train_step(state, cfg, batch,
                                     train_overrides=overrides)
        res.append((float(scalars["loss"]), flat_grads(state.model).cpu(),
                    images["depth_est_nomask"].cpu()))
    (loss_cpu, g_cpu, d_cpu), (loss_cuda, g_cuda, d_cuda) = res
    rel = abs(loss_cuda - loss_cpu) / abs(loss_cpu)
    cos = cosine(g_cuda, g_cpu)
    log("train_small", hw="64x96", B=2, views=3, loss_cpu=f"{loss_cpu:.7f}",
        loss_cuda=f"{loss_cuda:.7f}", loss_rel=f"{rel:.3e}",
        depth_max_abs_diff=f"{(d_cuda - d_cpu).abs().max().item():.3e}",
        grad_cosine=f"{cos:.9f}")
    check(rel < 1e-4, f"train step loss CUDA vs CPU rel {rel}")
    check(cos > 0.9999, f"train step gradient cosine CUDA vs CPU {cos}")


def phase_train(run):
    """The training cell through run_training, then kernel vs plain."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.models import stages
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.train.loop import run_training
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import (batch_to_device,
                                              compute_gradients)
    from diffmvs_tpu_torch.utils.synthetic import (
        synthetic_train_batch, synthetic_train_overrides)

    b, views, hh, ww, steps = 4, 5, 512, 640, 5
    model_cfg = MODEL_PRESETS["casdiffmvs"]
    check(model_cfg.numdepth_initial == 48 and model_cfg.numdepth == 384
          and model_cfg.compute_dtype == "float32", "the preset's widths")
    cfg = TrainConfig(model=model_cfg, batch_size=b, epochs=1,
                      summary_freq=1, seed=0)
    state = create_train_state(cfg, steps_per_epoch=steps, device="cuda",
                               seed=0)
    batches = [synthetic_train_batch(b, views, hh, ww, 384, seed=i)
               for i in range(steps)]
    logdir = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(logdir, ignore_errors=True)

    marks = []

    def on_step(step, scalars):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), warp_corr.launches,
                      warp_corr.bwd_launches, float(scalars["loss"]),
                      float(scalars["grad_norm"])))

    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), 0, 0, 0.0, 0.0))
    run_training(state, cfg, batches, batches[:1], str(logdir),
                 on_step=on_step)
    torch.cuda.synchronize()
    run["k2_launches"] = dict(warp_corr.bwd_launches_by_shape)
    k1_total, k2_total = warp_corr.launches, warp_corr.bwd_launches
    peak = torch.cuda.max_memory_allocated()

    step_ms = []
    for prev, cur in zip(marks, marks[1:]):
        check(cur[1] - prev[1] == 28, f"{cur[1] - prev[1]} K1 launches in "
              f"a step")
        check(cur[2] - prev[2] == 28, f"{cur[2] - prev[2]} K2 launches in "
              f"a step")
        check(all(math.isfinite(v) for v in cur[3:]),
              f"loss / gradient norm {cur[3:]}")
        step_ms.append((cur[0] - prev[0]) * 1e3)
    check(len(step_ms) == steps, f"{len(step_ms)} steps")
    check(k2_total == 28 * steps, f"{k2_total} K2 launches")
    check(k1_total == 28 * (steps + 1), f"{k1_total} K1 launches (with "
          f"one validation batch)")
    check(sorted(run["k2_launches"].values()) == [4 * steps, 12 * steps,
                                                  12 * steps],
          f"K2 by shape {run['k2_launches']}")
    check((logdir / "model_000000.ckpt").exists(), "checkpoint written")

    # one step's gradients, kernels against the plain warp (same weights,
    # batch, timesteps and noise)
    batch = batch_to_device(batches[0], state.device)
    overrides = synthetic_train_overrides(model_cfg, b, hh, ww, seed=7)

    def loss_and_grads():
        before = (warp_corr.launches, warp_corr.bwd_launches)
        loss, _, outputs, _ = compute_gradients(state.model, cfg, batch,
                                                train_overrides=overrides)
        torch.cuda.synchronize()
        counts = (warp_corr.launches - before[0],
                  warp_corr.bwd_launches - before[1])
        return (loss.item(), flat_grads(state.model),
                outputs["depth"][-1].detach(), counts)

    loss_k, g_k, depth_k, counts_k = loss_and_grads()
    dispatch = stages.warp_and_correlate
    stages.warp_and_correlate = warp_and_correlate_plain
    try:
        loss_p, g_p, depth_p, counts_p = loss_and_grads()
    finally:
        stages.warp_and_correlate = dispatch
    check(counts_k == (28, 28) and counts_p == (0, 0),
          f"launches with the kernels {counts_k}, with the plain warp "
          f"{counts_p}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = cosine(g_k, g_p)
    depth_rel = ((depth_k - depth_p).abs()
                 / depth_p.abs().clamp_min(1e-12)).mean().item()
    steady = statistics.mean(step_ms[1:])
    log("train", B=b, views=views, hw=f"{hh}x{ww}", steps=steps,
        step_ms=repr([round(m, 1) for m in step_ms]),
        samples_per_s=f"{b * 1e3 / steady:.3f}",
        peak_mem_gib=f"{peak / 2**30:.3f}",
        losses=repr([round(m[3], 4) for m in marks[1:]]),
        k1_per_step=28, k2_per_step=28,
        plain_vs_kernel_loss_rel=f"{rel:.3e}",
        plain_vs_kernel_depth_mean_rel=f"{depth_rel:.3e}",
        plain_vs_kernel_grad_cosine=f"{cos:.8f}")
    check(rel < 1e-5, f"train loss kernel vs plain rel {rel}")
    check(depth_rel < 1e-4, f"train depth kernel vs plain rel {depth_rel}")
    check(cos > 0.9999, f"train gradients kernel vs plain cosine {cos}")


def main():
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log("device", name=repr(kind), smi=repr(smi),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    from diffmvs_tpu_torch.ops import warp_corr

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    libs = warp_corr.build()
    warp_corr._load()
    for name, lib in libs.items():
        ptxas = [l.strip() for l in (lib.parent / f"{name}.log").read_text()
                 .splitlines() if "registers" in l or "spill" in l]
        log("build", lib=lib.name, ptxas=repr(" | ".join(ptxas)))
    log("build", seconds=f"{time.time() - t0:.1f}")

    dev = torch.device("cuda")
    run = {"dev": dev, "gen": torch.Generator(device=dev).manual_seed(0),
           "k1_rows": {}, "k2_rows": {}, "k1_launches": {},
           "k2_launches": {}}
    for phase in (phase_kernel, phase_train_kernel, phase_small, phase_main,
                  phase_train_small, phase_train):
        phase(run)

    kernels = []
    for rows, counts, src, replaces, tag in (
            (run["k1_rows"], run["k1_launches"], "warp_corr.cu",
             "warp_corr.py:210", "warp_corr"),
            (run["k2_rows"], run["k2_launches"], "warp_corr_bwd.cu",
             "warp_corr_bwd.py:61", "warp_corr_bwd")):
        for key, (name, r) in rows.items():
            if key not in counts:     # measured, not on a path (DiffMVS)
                continue
            kernels.append({
                "name": f"{tag}:{name}", "route": "cuda",
                "source": f"diffmvs_tpu_torch/ops/csrc/{src}",
                "replaces": f"diffmvs_tpu/ops/pallas/{replaces}",
                "launches": counts[key], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None})
    check(len(kernels) == 6, f"{len(kernels)} kernel rows")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
