"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. device       -- needs CUDA; prints the card's name and power limit;
                     TF32 off
  2. build        -- compiles the three kernels with nvcc, side by side: K1
                     (ops/csrc/warp_corr.cu), K2 (warp_corr_bwd.cu) and K3
                     (warp_corr_pre.cu)
  3. kernel       -- K1 against its plain PyTorch version at the inference
                     path's shapes (and DiffMVS's refinement shape), f32
                     and bf16 features, with CUDA-event times (ms: L2 warm,
                     the host's launch gap included; card_ms: without it;
                     cold_ms: L2 flushed) and the bound; batched odd sizes
                     (N=2) through every load width, misaligned bases, G =
                     1, 8 and above 256 (launches over group slices),
                     degenerate depths
  4. train_kernel -- K2 against autograd of the plain version at the
                     training shapes (B=4 at 512x640: the sweep and the two
                     refinement stages) with degenerate depths, plus
                     batched odd sizes through the vector and scalar paths,
                     C / K above 256 (launches over channel slices) and
                     depths that jump by decades from plane to plane;
                     times as in kernel, bound, global atomic counts
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
  9. k3_kernel    -- K3, warp_corr(..., batch_rows=False), its only path:
                     against its plain version and against K1 on the same
                     inputs at the sweep / stage-2 / stage-3 DTU shapes, f32
                     and bf16, degenerate depths in the first row; CUDA-event
                     times and the bound; batched odd sizes (N=2) through
                     its four instantiations (f32 float4 and scalar, bf16
                     two pairs and one pair, aligned and misaligned bases);
                     the gradients through K3 against those through K1
                     (both K2) at the training stage-3 shape
 10. export       -- the scene export entry point as a user runs it:
                     cli.test.main on a synthetic DTU-layout scan of 7 views
                     at 1152x1600 (uint8 .npy serving caches), CasDiffMVS
                     f32 48/384, 5 views per depth map, random weights from
                     seed 0, loose fusion thresholds: 28 K1 launches per
                     view, finite PFM/cam/JPEG files and the fused .ply; the
                     fusion again on the CPU (masks equal but at pixels
                     within 1e-4 of a threshold, points within 1e-4), and
                     accuracy/completeness against a plane on card and CPU;
                     views/s and its split into load, inference, write and
                     fusion on the host's and the card's clock
Then a JSON line of per-kernel numbers (K1's launches from main, K2's from
train, K3's from the k3_kernel entry calls), the nvidia-smi line, and last
{"ok": true, "device": {...}}.

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

from diffmvs_tpu_torch.tools.kernel_times import (
    bound, bwd_bound, cuda_ms, k2_global_atomics, make_depth, sample_counts,
    timings, warp_bound)

CORR_TOL = dict(rtol=1e-4, atol=1e-5)
REPO = Path(__file__).resolve().parent


def check(cond, what):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def pre_bound(n, d, h, w, hs, ws, c, g, feat_bytes):
    """K3: the output written once and src, ref and the five corner
    operands (int32 xi, yi, f32 fx, fy, a validity byte: 17 bytes per
    plane-pixel) read once, against ~10 operations per plane-pixel, 11 per
    channel (two y-lerps, the x-lerp, the product-accumulate) and 1 per
    group mean."""
    nbytes = (n * g * d * h * w * 4 + n * h * w * c * feat_bytes
              + n * hs * ws * c * feat_bytes + n * d * h * w * 17)
    return bound(nbytes, n * d * h * w * (10 + 11 * c + g))


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
                t = timings(lambda: warp_corr.warp_corr_rt(src, ref, rt,
                                                           depth, 4))
                plain_ms = cuda_ms(lambda: warp_and_correlate_plain(
                    src.float(), ref.float(), sp, rp, depth, 4))
                bound_ms, bound_by = warp_bound(
                    1, d, h, w, h, w, c, 4, src.element_size())
                tag = "f32" if dt == torch.float32 else "bf16"
                log("kernel", shape=name, dtype=tag, D=d, C=c,
                    hw=f"{h}x{w}", max_abs_err=f"{err:.3e}",
                    off_image=f"{off:.3f}", ms=f"{t['ms']:.4f}",
                    card_ms=f"{t['card_ms']:.4f}",
                    cold_ms=f"{t['cold_ms']:.4f}", plain_ms=f"{plain_ms:.4f}",
                    bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
                row[tag] = dict(max_abs_err=err, ms=t["ms"],
                                card_ms=t["card_ms"], plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
        run["k1_rows"][(d, h, w, c)] = (name, row["f32"])

    # batched samples with their own projections, odd sizes (ragged
    # tiles), degenerate depths in the first row, through every load
    # width: f32 float4 (C/G = 4, 8, 12) and scalar (C/G = 3, 6, bases 4
    # and 8 bytes off), bf16 uint4 (C/G = 8), uint2 (C/G = 4, 12 and an
    # 8-byte base), pairs (C/G = 6, a 4-byte base) and scalar (C/G = 3, a
    # 2-byte base); two groups per thread (C/G <= 4) and one; G = 1 (C/G =
    # 48, a group wider than the registers hold), G = 8, and G = 520 and
    # 257, more groups than a block has threads (two launches, two groups
    # per thread and one)
    n, d, h, w = 2, 5, 37, 53
    sp, rp = odd_pairs(projs, dev)
    depth = odd_depth(n, d, h, w, dev, gen)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        for c, groups, shift in ((12, 4, 0), (16, 4, 0), (24, 4, 0),
                                 (32, 4, 0), (48, 4, 0), (16, 4, 1),
                                 (32, 4, 2), (32, 4, 4), (48, 1, 0),
                                 (64, 8, 0), (1040, 520, 0), (514, 257, 0)):
            src = shifted(torch.randn(n, h + 3, w - 2, c, device=dev,
                                      generator=gen).to(dt), shift)
            ref = shifted(torch.randn(n, h, w, c, device=dev,
                                      generator=gen).to(dt), shift)
            with torch.inference_mode():
                got = warp_corr.warp_corr(src, ref, sp, rp, depth, groups)
                want = warp_and_correlate_plain(src.float(), ref.float(),
                                                sp, rp, depth, groups)
            torch.cuda.synchronize()
            tag = (f"{'f32' if dt == torch.float32 else 'bf16'}:"
                   f"C{c}G{groups}+{shift}")
            torch.testing.assert_close(got, want, **CORR_TOL, msg=lambda m: (
                f"batched_odd {tag}: {m}"))
            errs.append(f"{tag}={(got - want).abs().max().item():.1e}")
    log("kernel", shape="batched_odd", N=n, D=d, hw=f"{h}x{w}",
        src_hw=f"{h + 3}x{w - 2}", max_abs_err=",".join(errs))


def odd_depth(n, d, h, w, dev, gen):
    """Refinement-like hypotheses 4..10 m with degenerate depths (zero,
    behind the camera, tiny and huge) in the first row."""
    depth = 4.0 + 6.0 * torch.rand(n, d, h, w, device=dev, generator=gen)
    depth[:, :, 0, :4] = torch.tensor([0.0, -5.0, 1e-30, 1e30], device=dev)
    return depth


def odd_pairs(projs, dev):
    pairs = torch.from_numpy(projs["stage1"]).to(dev)
    sp = torch.stack([pairs[0, 1], pairs[0, 3]])
    rp = torch.stack([pairs[0, 0], pairs[0, 0]])
    return sp, rp


def shifted(t, elems):
    """A contiguous copy of t whose data starts `elems` elements into its
    storage (a base off the allocator's alignment)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


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
        t = timings(lambda: warp_corr.warp_corr_backward(src, ref, rt, depth,
                                                         g, 4))
        src_p = src.detach().requires_grad_()
        ref_p = ref.detach().requires_grad_()
        out_p = warp_and_correlate_plain(src_p, ref_p, sp, rp, depth, 4)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            out_p, (src_p, ref_p), g_out, retain_graph=True))
        del out_p
        samples, inside, corners = sample_counts(sp, rp, depth, h, w)
        bound_ms, bound_by = bwd_bound(n, d, h, w, h, w, c, 4, inside,
                                       corners)
        v4, scalar = k2_global_atomics(sp, rp, depth, h, w, c)
        log("train_kernel", shape=name, N=n, D=d, C=c, hw=f"{h}x{w}",
            max_abs_err=f"{err:.3e}", ms=f"{t['ms']:.4f}",
            card_ms=f"{t['card_ms']:.4f}", cold_ms=f"{t['cold_ms']:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, global_atomics_v4=v4,
            scalar_atomics_one_per_channel=scalar,
            fewer_by=f"{scalar / max(1, v4):.2f}",
            in_image_samples=f"{inside / samples:.3f}")
        run["k2_rows"][(d, h, w, c)] = (name, dict(
            max_abs_err=err, ms=t["ms"], card_ms=t["card_ms"],
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))

    # batched samples with odd sizes and degenerate depths in the first
    # row through the float4 path (C/G = 4, 12) and the scalar one (C/G =
    # 3, 6, a base 4 bytes off), G = 1; more channel lanes than a block has
    # threads (C = 1040 float4, C = 264 and 1040 scalar: launches over
    # channel slices); then depths from 1e-2 to 1e3 drawn per pixel and
    # plane, whose corners move to other source pixels at every plane, so
    # no sum is held across planes
    n, d, h, w = 2, 5, 37, 53
    sp, rp = odd_pairs(projs, dev)
    wide = 10.0 ** (5.0 * torch.rand(n, d, h, w, device=dev,
                                     generator=gen) - 2.0)
    odd = []
    for c, groups, shift, depth in (
            (12, 4, 0, odd_depth(n, d, h, w, dev, gen)),
            (16, 4, 0, odd_depth(n, d, h, w, dev, gen)),
            (24, 4, 0, odd_depth(n, d, h, w, dev, gen)),
            (48, 4, 0, odd_depth(n, d, h, w, dev, gen)),
            (16, 4, 1, odd_depth(n, d, h, w, dev, gen)),
            (48, 1, 0, odd_depth(n, d, h, w, dev, gen)),
            (1040, 4, 0, odd_depth(n, d, h, w, dev, gen)),
            (264, 4, 0, odd_depth(n, d, h, w, dev, gen)),
            (1040, 520, 0, odd_depth(n, d, h, w, dev, gen)),
            (16, 4, 0, wide), (12, 4, 0, wide)):
        src = shifted(torch.randn(n, h + 3, w - 2, c, device=dev,
                                  generator=gen), shift)
        ref = shifted(torch.randn(n, h, w, c, device=dev, generator=gen),
                      shift)
        g_out = torch.randn(n, d, h, w, groups, device=dev, generator=gen)
        want = grads_of(lambda a, b: warp_and_correlate_plain(
            a, b, sp, rp, depth, groups), src, ref, g_out)
        got = grads_of(lambda a, b: warp_corr.warp_corr(
            a, b, sp, rp, depth, groups), src, ref, g_out)
        torch.cuda.synchronize()
        tag = f"C{c}G{groups}+{shift}{':wide' if depth is wide else ''}"
        for k, wnt, what in zip(got, want, ("d_src", "d_ref")):
            torch.testing.assert_close(k, wnt, **CORR_TOL, msg=lambda m: (
                f"batched_odd {tag} {what}: {m}"))
        err = max((k - wnt).abs().max().item() for k, wnt in zip(got, want))
        odd.append(f"{tag}={err:.1e}")
    v4, scalar = k2_global_atomics(sp, rp, wide, h + 3, w - 2, 16)
    log("train_kernel", shape="batched_odd", N=n, D=d, hw=f"{h}x{w}",
        src_hw=f"{h + 3}x{w - 2}", max_abs_err=",".join(odd),
        wide_depths_v4_atomics=v4, wide_depths_scalar_atomics=scalar)


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


def phase_k3_kernel(run):
    """K3 (the batch_rows=False mode) against its plain version and K1."""
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import corner_correlate_plain
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    dev, gen = run["dev"], run["gen"]
    hh, ww, views = 1152, 1600, 5
    _, projs, _ = synthetic_inputs(1, views, hh, ww, 384)
    shapes = {"sweep": ("stage1", 48, 48, 8),
              "stage2": ("stage2", 4, 32, 4),
              "stage3": ("stage3", 4, 16, 2)}
    cases = []
    for name, (stage, d, c, s) in shapes.items():
        h, w = hh // s, ww // s
        pairs = torch.from_numpy(projs[stage]).to(dev)
        sp, rp = pairs[:, views - 1], pairs[:, 0]
        depth = make_depth(name, 1, d, h, w, dev, gen)
        src32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            cases.append((name, d, c, h, w, sp, rp, depth, src32.to(dt),
                          ref32.to(dt)))

    # the path: the op's batch_rows=False entry point, counted from 0
    warp_corr.reset_counts()
    outs, counts = [], []
    with torch.inference_mode():
        for name, d, c, h, w, sp, rp, depth, src, ref in cases:
            before = warp_corr.pre_launches
            outs.append(warp_corr.warp_corr(src, ref, sp, rp, depth, 4,
                                            batch_rows=False))
            counts.append(warp_corr.pre_launches - before)
            check(counts[-1] == 1, f"{counts[-1]} K3 launches in one call")
    torch.cuda.synchronize()
    check(warp_corr.pre_launches == len(cases) and warp_corr.launches == 0,
          f"{warp_corr.pre_launches} K3 / {warp_corr.launches} K1 launches")
    launches = warp_corr.pre_launches

    for (name, d, c, h, w, sp, rp, depth, src, ref), got, count in zip(
            cases, outs, counts):
        tag = "f32" if src.dtype == torch.float32 else "bf16"
        with torch.inference_mode():
            ops = warp_corr.corner_operands(src, sp, rp, depth)
            want = corner_correlate_plain(src, ref, *ops, 4)
            k1 = warp_corr.warp_corr(src, ref, sp, rp, depth, 4)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_k1 = (got - k1).abs().max().item()
        check(err <= 1e-5, f"K3 {name} {tag} vs plain {err}")
        check(err_k1 <= 1e-5, f"K3 {name} {tag} vs K1 {err_k1}")
        check(bool(torch.isfinite(got).all()), "K3 finite")
        ms = cuda_ms(lambda: warp_corr.launch_pre(src, ref, *ops, 4))
        entry_ms = cuda_ms(lambda: warp_corr.warp_corr(
            src, ref, sp, rp, depth, 4, batch_rows=False))
        rt = warp_corr.projection_scalars(sp, rp)
        k1_ms = cuda_ms(lambda: warp_corr.warp_corr_rt(src, ref, rt, depth,
                                                       4))
        plain_ms = cuda_ms(lambda: corner_correlate_plain(src, ref, *ops, 4))
        bound_ms, bound_by = pre_bound(1, d, h, w, h, w, c, 4,
                                       src.element_size())
        log("k3_kernel", shape=name, dtype=tag, D=d, C=c, hw=f"{h}x{w}",
            max_abs_err=f"{err:.3e}", vs_k1_max_abs=f"{err_k1:.3e}",
            ms=f"{ms:.4f}",
            entry_ms=f"{entry_ms:.4f}", k1_ms=f"{k1_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by)
        run["k3_rows"].append((f"{name}" if tag == "f32" else f"{name}:bf16",
                               dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, launches=count)))
    run["k3_launches"] = launches

    # batched samples with their own projections and odd sizes through all
    # four instantiations: f32 float4 (C/G = 4) and scalar (C/G = 3, and
    # C/G = 4 at a base 4 bytes off 16-byte alignment), bf16 two pairs
    # (C/G = 4) and one pair (C/G = 6, and C/G = 4 at a base 4 bytes off
    # 8-byte alignment)
    n, d, h, w = 2, 5, 37, 53
    sp, rp = odd_pairs(projs, dev)
    depth = 4.0 + 6.0 * torch.rand(n, d, h, w, device=dev, generator=gen)
    depth[:, :, 0, :4] = torch.tensor([0.0, -5.0, 1e-30, 1e30], device=dev)
    odd = []
    for dt, c, shift in ((torch.float32, 16, 0), (torch.float32, 12, 0),
                         (torch.float32, 16, 1), (torch.bfloat16, 16, 0),
                         (torch.bfloat16, 24, 0), (torch.bfloat16, 16, 2)):
        src = shifted(torch.randn(n, h + 3, w - 2, c, device=dev,
                                  generator=gen).to(dt), shift)
        ref = shifted(torch.randn(n, h, w, c, device=dev,
                                  generator=gen).to(dt), shift)
        with torch.inference_mode():
            got = warp_corr.warp_corr(src, ref, sp, rp, depth, 4,
                                      batch_rows=False)
            want = corner_correlate_plain(
                src, ref, *warp_corr.corner_operands(src, sp, rp, depth), 4)
            k1 = warp_corr.warp_corr(src, ref, sp, rp, depth, 4)
        torch.cuda.synchronize()
        tag = f"{'f32' if dt == torch.float32 else 'bf16'}:C{c}+{shift}"
        err = (got - want).abs().max().item()
        err_k1 = (got - k1).abs().max().item()
        check(err <= 1e-5, f"K3 batched_odd {tag} vs plain {err}")
        check(err_k1 <= 1e-5, f"K3 batched_odd {tag} vs K1 {err_k1}")
        odd.append(f"{tag}={max(err, err_k1):.1e}")
    log("k3_kernel", shape="batched_odd", N=n, D=d, hw=f"{h}x{w}",
        src_hw=f"{h + 3}x{w - 2}", max_abs_err_vs_plain_and_k1=",".join(odd))

    # gradients through K3 against those through K1 (both K2), at the
    # training stage-3 shape
    n, d, c, h, w = 4, 4, 16, 256, 320
    _, tprojs, _ = synthetic_inputs(n, views, 512, 640, 384)
    pairs = torch.from_numpy(tprojs["stage3"]).to(dev)
    sp, rp = pairs[:, views - 1], pairs[:, 0]
    depth = make_depth("stage3", n, d, h, w, dev, gen)
    src = torch.randn(n, h, w, c, device=dev, generator=gen)
    ref = torch.randn(n, h, w, c, device=dev, generator=gen)
    g_out = torch.randn(n, d, h, w, 4, device=dev, generator=gen)
    before = (warp_corr.pre_launches, warp_corr.bwd_launches)
    k3 = grads_of(lambda a, b: warp_corr.warp_corr(
        a, b, sp, rp, depth, 4, batch_rows=False), src, ref, g_out)
    check((warp_corr.pre_launches - before[0],
           warp_corr.bwd_launches - before[1]) == (1, 1),
          "K3 forward + K2 backward")
    k1 = grads_of(lambda a, b: warp_corr.warp_corr(
        a, b, sp, rp, depth, 4), src, ref, g_out)
    torch.cuda.synchronize()
    cos = cosine(torch.cat([x.flatten() for x in k3]).double(),
                 torch.cat([x.flatten() for x in k1]).double())
    diff = max((a - b).abs().max().item() for a, b in zip(k3, k1))
    check(cos > 0.9999, f"K3 vs K1 gradient cosine {cos}")
    log("k3_kernel", grad_shape=f"N={n} D={d} C={c} {h}x{w}",
        grad_cosine_vs_k1=f"{cos:.9f}", grad_max_abs_diff=f"{diff:.3e}")


def make_dtu_scan(root, scan, views, hh, ww, seed=0):
    """A DTU-layout scan: scanN/images/*.npy (uint8 serving caches at the
    eval size), cams_1/*_cam.txt and a pair.txt that lists, for every view,
    the other views with scores > 0.1. The cameras sit on a gentle arc
    (4.6 degrees apart) 650 mm from a point in front of view 0, with
    DTU-like intrinsics and the DTU depth range 425-935 mm."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = root / scan
    (base / "images").mkdir(parents=True)
    (base / "cams_1").mkdir()
    k = np.array([[2892.3, 0.0, ww / 2 + 23.0], [0.0, 2883.2, hh / 2 - 8.0],
                  [0.0, 0.0, 1.0]], np.float32)
    center = np.array([0.0, 0.0, 650.0])
    for i in range(views):
        th = 0.08 * (i - views // 2)
        rot_y = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]])
        cam_center = center + rot_y @ np.array([0.0, 0.0, -650.0])
        e = np.eye(4)
        e[:3, :3] = rot_y.T
        e[:3, 3] = -rot_y.T @ cam_center
        low = rng.randint(0, 256, (hh // 16, ww // 16, 3)).astype(np.uint8)
        img = np.kron(low, np.ones((16, 16, 1), np.uint8))
        np.save(base / "images" / f"{i:08d}.npy", img)
        with open(base / "cams_1" / f"{i:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(f"{v:.6f}" for v in e[r]) + "\n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(f"{v:.6f}" for v in k[r]) + "\n")
            f.write("\n425.0 2.5 192 935.0\n")
    with open(base / "pair.txt", "w") as f:
        f.write(f"{views}\n")
        for i in range(views):
            others = sorted((j for j in range(views) if j != i),
                            key=lambda j: abs(j - i))
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {10.0 / abs(j - i):.2f}" for j in others) + "\n")


class Spans:
    """Time of every call of one function (patched in for the phase,
    restored by close(), which returns the ms of each call): on the card's
    clock by CUDA events around it, or with card=False on the host's."""

    def __init__(self, owner, attr, card=True):
        self.owner, self.attr, self.card = owner, attr, card
        self.fn = getattr(owner, attr)
        self.marks = []

        def timed(*args, **kwargs):
            if self.card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = self.fn(*args, **kwargs)
                end.record()
                self.marks.append((start, end))
            else:
                t0 = time.perf_counter()
                out = self.fn(*args, **kwargs)
                self.marks.append((t0, time.perf_counter()))
            return out

        setattr(owner, attr, timed)

    def close(self):
        setattr(self.owner, self.attr, self.fn)
        if self.card:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.marks]
        return [(e - s) * 1e3 for s, e in self.marks]


def phase_export(run):
    """cli.test.main at DTU size on a synthetic scan, then the fusion on
    the CPU and the point-cloud metrics on card and CPU."""
    import numpy as np

    from PIL import Image

    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.cli import test as cli
    from diffmvs_tpu_torch.data import io as data_io
    from diffmvs_tpu_torch.data import native_io
    from diffmvs_tpu_torch.data.io import read_pair_file, read_pfm
    from diffmvs_tpu_torch.fusion import fuse, metrics
    from diffmvs_tpu_torch.fusion.ply import read_ply
    from diffmvs_tpu_torch.ops import warp_corr

    hh, ww, views, scan = 1152, 1600, 7, "scan9"
    root = REPO / "build" / "chip_smoke_export"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_dtu_scan(root / "dtu", scan, views, hh, ww)
    (root / "test.txt").write_text(scan + "\n")
    setup_s = time.perf_counter() - t0
    out = root / "out"
    thres = dict(geo_mask_thres=1, geo_pixel_thres=8.0, geo_depth_thres=0.5)
    args = ["--dataset", "dtu", "--testpath", str(root / "dtu"),
            "--testlist", str(root / "test.txt"), "--save_depth",
            "--num_view", "5", "--batch_size", "1", "--outdir", str(out),
            "--workers", "2", "--device", "cuda",
            "--geo_mask_thres", str(thres["geo_mask_thres"]),
            "--geo_pixel_thres", str(thres["geo_pixel_thres"]),
            "--geo_depth_thres", str(thres["geo_depth_thres"]),
            "--photo_thres", "0", "0", "0"]

    # card spans: the model call, fusion's consistency pass; host spans:
    # the export's file writes (save_scene_depth imports the codecs when
    # it runs, so patching data.io reaches it) and fusion's file I/O
    spans = {"infer_card": Spans(DepthRunner, "__call__"),
             "fuse_card": Spans(fuse, "_consistency_batch"),
             "pfm_write": Spans(data_io, "save_pfm", card=False),
             "cam_write": Spans(data_io, "write_cam", card=False),
             "jpeg_write": Spans(Image.Image, "save", card=False),
             "fuse_pfm_read": Spans(fuse, "read_pfm", card=False),
             "fuse_jpeg_read": Spans(fuse, "read_img", card=False),
             "fuse_mask_write": Spans(fuse, "save_mask", card=False),
             "fuse_unproject": Spans(fuse, "_unproject_masked", card=False),
             "fuse_ply_write": Spans(fuse, "write_ply", card=False)}
    warp_corr.reset_counts()
    try:
        res = cli.main(args)
    finally:
        ms = {k: sp.close() for k, sp in spans.items()}
    infer_card, fuse_card = ms["infer_card"], ms["fuse_card"]
    k1, by_shape = warp_corr.launches, dict(warp_corr.launches_by_shape)
    check(k1 == 28 * views, f"{k1} K1 launches for {views} views")
    check(sorted(by_shape.values()) == [views * 4, views * 12, views * 12],
          f"K1 by shape {by_shape}")
    check(warp_corr.bwd_launches == 0 and warp_corr.pre_launches == 0,
          "only K1 on the export path")
    exp = res["export"]
    check(exp["views"] == views and len(infer_card) == views,
          f"{exp['views']} views exported")

    scan_out = out / scan
    for i in range(views):
        for sub in ("depth_est", "conf0", "conf1", "conf2"):
            arr, _ = read_pfm(str(scan_out / sub / f"{i:08d}.pfm"))
            check(arr.shape == (hh, ww) and bool(np.isfinite(arr).all()),
                  f"{sub}/{i:08d}.pfm finite {hh}x{ww}")
        check((scan_out / "cams" / f"{i:08d}_cam.txt").exists()
              and (scan_out / "images" / f"{i:08d}.jpg").exists(),
              f"cam and jpg of view {i}")
    ply = out / "pc" / "mvs009_l3.ply"
    check(ply.exists(), f"{ply} written")
    xyz, _ = read_ply(str(ply))
    check(xyz.shape[0] == res["points"][str(ply)] > 0
          and bool(np.isfinite(xyz).all()), "a finite, non-empty cloud")

    # the same fusion on the CPU, view by view, against the card
    t0 = time.perf_counter()
    cpu_pts, flips, band, compared = [], 0, 0, 0
    for ref_view, src_views in read_pair_file(
            str(root / "dtu" / scan / "pair.txt"), "dtu"):
        res_dev = []
        for device in ("cuda", "cpu"):
            loaded = fuse.load_views(str(scan_out), ref_view, src_views, 10,
                                     torch.device(device))
            (k_ref, e_ref, dmax, dmin, ref_depth, k_srcs, e_srcs,
             d_srcs) = loaded
            dist, rel, _, _, geo_sum, depth_avg = fuse._consistency_batch(
                ref_depth, k_ref, e_ref, d_srcs, k_srcs, e_srcs, dmax, dmin,
                thres["geo_pixel_thres"], thres["geo_depth_thres"])
            res_dev.append((dist.cpu(), rel.cpu(), geo_sum.cpu(),
                            depth_avg.cpu(), k_ref.cpu().numpy(),
                            e_ref.cpu().numpy()))
        (_, _, geo_cuda, avg_cuda, _, _), (dist, rel, geo_cpu, avg_cpu,
                                           k_ref, e_ref) = res_dev
        near = ((dist - thres["geo_pixel_thres"]).abs()
                <= 1e-4 * thres["geo_pixel_thres"]) | (
            (rel - thres["geo_depth_thres"]).abs()
            <= 1e-4 * thres["geo_depth_thres"])
        near = near.any(0)
        mask_cpu = geo_cpu >= thres["geo_mask_thres"]
        mask_cuda = geo_cuda >= thres["geo_mask_thres"]
        differ = mask_cpu != mask_cuda
        check(not bool((differ & ~near).any()),
              f"view {ref_view}: masks differ away from the thresholds")
        flips += int(differ.sum())
        band += int(near.sum())
        common = mask_cpu & mask_cuda
        compared += int(common.sum())
        rel_avg = ((avg_cuda - avg_cpu).abs()
                   / avg_cpu.abs().clamp_min(1e-12))[common]
        check(rel_avg.numel() == 0 or rel_avg.max().item() <= 1e-4,
              f"view {ref_view}: depth averages differ {rel_avg.max()}")
        photo = fuse._photo_mask(str(scan_out), ref_view, (0.0, 0.0, 0.0),
                                 "casdiffmvs")
        pts, _ = fuse._unproject_masked(avg_cpu.numpy(),
                                        photo & mask_cpu.numpy(),
                                        np.zeros((hh, ww, 3)), k_ref, e_ref)
        cpu_pts.append(pts)
    cpu_pts = np.concatenate(cpu_pts)
    if cpu_pts.shape[0] == xyz.shape[0]:
        rel_pts = (np.linalg.norm(xyz - cpu_pts, axis=1)
                   / np.linalg.norm(cpu_pts, axis=1)).max()
        check(rel_pts <= 1e-4, f"card vs CPU points rel {rel_pts}")
    else:
        rel_pts = float("nan")
        check(abs(cpu_pts.shape[0] - xyz.shape[0]) <= flips,
              "point counts differ by more than the flipped pixels")
    cpu_fuse_s = time.perf_counter() - t0

    # accuracy / completeness against a plane through the object point,
    # on card and CPU (the cloud thinned to <= 20k points for the CPU)
    gt = metrics.sample_mesh_plane(650.0, (-180.0, 180.0), (-130.0, 130.0),
                                   3.0)
    pred = xyz[::max(1, xyz.shape[0] // 20000)]
    t0 = time.perf_counter()
    m_cuda = metrics.accuracy_completeness(pred, gt, max_dist=1000.0,
                                           tau=10.0, device="cuda")
    nn_cuda_s = time.perf_counter() - t0
    m_cpu = metrics.accuracy_completeness(pred, gt, max_dist=1000.0,
                                          tau=10.0, device="cpu")
    for key, v in m_cuda.items():
        check(math.isclose(v, m_cpu[key], rel_tol=1e-5, abs_tol=1e-9),
              f"{key}: card {v} vs CPU {m_cpu[key]}")

    batches = exp["batches"]
    steady = batches[1:]
    steady_s = sum(b["load_s"] + b["infer_s"] + b["write_s"] for b in steady)
    all_s = exp["load_s"] + exp["infer_s"] + exp["write_s"]

    def per_view_ms(key):
        return 1e3 * sum(b[key] for b in steady) / len(steady)

    log("export", views=views, hw=f"{hh}x{ww}", src_views=4, setup_s=(
        f"{setup_s:.2f}"), decoder=native_io.decoder(),
        native_build=repr(native_io.build_error or "ok"),
        views_per_s=f"{views / all_s:.3f}",
        views_per_s_steady=f"{len(steady) / steady_s:.3f}",
        load_ms=f"{per_view_ms('load_s'):.1f}",
        infer_ms=f"{per_view_ms('infer_s'):.1f}",
        write_ms=f"{per_view_ms('write_s'):.1f}",
        first_view_s=f"{sum(batches[0][k] for k in ('load_s', 'infer_s', 'write_s')):.2f}",
        infer_card_ms=f"{statistics.mean(infer_card[1:]):.1f}",
        fusion_s=f"{res['fusion_s']:.3f}",
        fusion_card_ms_per_view=f"{statistics.mean(fuse_card):.2f}",
        k1_launches=k1, k1_per_view=k1 // views, points=xyz.shape[0])
    # host ms per view (the mask PNGs are written through PIL too, so
    # jpeg_write less fuse_mask_write is the export's reference JPEGs)
    per_view = {k: sum(v) / views for k, v in ms.items()
                if k not in ("infer_card", "fuse_card")}
    log("export", host_ms_per_view=repr(
        {k: round(v, 1) for k, v in per_view.items()}),
        jpeg_export_ms=f"{per_view['jpeg_write'] - per_view['fuse_mask_write']:.1f}")
    log("export", cpu_fusion_s=f"{cpu_fuse_s:.1f}", mask_flips=flips,
        threshold_band_pixels=band, compared_pixels=compared,
        points_cpu=cpu_pts.shape[0], points_max_rel=f"{rel_pts:.3e}",
        nn_points=f"{pred.shape[0]}x{gt.shape[0]}",
        nn_card_s=f"{nn_cuda_s:.3f}",
        acc_mean=f"{m_cuda['acc_mean']:.4f}",
        comp_mean=f"{m_cuda['comp_mean']:.4f}",
        acc_rel_card_cpu=f"{abs(m_cuda['acc_mean'] - m_cpu['acc_mean']) / abs(m_cpu['acc_mean']):.3e}")


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
           "k1_rows": {}, "k2_rows": {}, "k3_rows": [], "k1_launches": {},
           "k2_launches": {}}
    for phase in (phase_kernel, phase_train_kernel, phase_small, phase_main,
                  phase_train_small, phase_train, phase_k3_kernel,
                  phase_export):
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
                "ms": r["ms"], "card_ms": r["card_ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None})
    for name, r in run["k3_rows"]:
        kernels.append({
            "name": f"warp_corr_pre:{name}", "route": "cuda",
            "source": "diffmvs_tpu_torch/ops/csrc/warp_corr_pre.cu",
            "replaces": "diffmvs_tpu/ops/pallas/warp_corr.py:55",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    check(len(kernels) == 12, f"{len(kernels)} kernel rows")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
