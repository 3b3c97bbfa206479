"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. device       -- needs CUDA; prints the card's name and power limit;
                     TF32 off
  2. build        -- ops/native.py compiles every source of ops/csrc/ with
                     nvcc, side by side, six today: K1
                     (ops/csrc/warp_corr.cu), K2 (warp_corr_bwd.cu),
                     K3 with its operand and projection kernels
                     (warp_corr_pre.cu), PixelViewWeight's
                     (pixel_view_weight.cu), FeatureNet's stem
                     (feature_stem.cu) and CostRegNet's prob layer
                     (cost_prob.cu)
  3. jax_ckpt     -- the JAX package's orbax checkpoints with no JAX on the
                     machine: tests/data/orbax_state/ (a toy train state
                     saved by its save_checkpoint, and arrays orbax split
                     into several zarr chunks) through train/orbax_read.py
                     and the system's libzstd.so.1, every leaf bit-equal to
                     expected.npz; the optax state into torch's AdamW on
                     the card; the read's host ms
  4. kernel       -- K1 against its plain PyTorch version at the inference
                     path's shapes (and DiffMVS's refinement shape), f32
                     and bf16 features, with CUDA-event times (ms: L2 warm,
                     the host's launch gap included; card_ms: without it;
                     cold_ms: L2 flushed) and the bound; batched odd sizes
                     (N=2) through every load width, misaligned bases, G =
                     1, 8 and above 256 (launches over group slices),
                     degenerate depths; the width shards' shapes (rank 1
                     of 2 at x_off = W/2, the source twice as wide as
                     ref), f32 and bf16, timed as the others; the bench
                     entry's batch, N = 16 at the sweep / stage-2 /
                     stage-3 shapes, each sample with its own view pair,
                     features and depths, f32 and bf16
  4b. pvw_kernel  -- PixelViewWeight's fused kernel (ops/view_weight.py)
                     against the module's cuDNN chain, view by view, at the
                     sweep's shape (4 views, D = 48, 144x200, G = 4) for
                     B = 16 and B = 1, bf16 and f32 volumes: max abs error
                     <= 1e-5, times (ms, card_ms, cold_ms), the FFMA bound,
                     the chain's ms (plain_ms and library_ms: the module is
                     both the kernel's plain version and the library it
                     replaces at inference); then
                     ragged shapes that cut every tile edge, one plane, and
                     G = 8
  4c. stem_kernel -- FeatureNet's stem kernel (ops/feature_stem.py: conv0
                     and conv1[0], BatchNorm and ReLU, bf16) against the
                     module chain over the 80 and 5 images of B = 16 and
                     B = 1 at 1152x1600 (kernel_times.time_stem), both
                     held to the float32 chain: the kernel's max and mean
                     abs error at most 1.5x the bf16 chain's, the chain's
                     strides; times, the bytes bound, the chain's ms; then
                     ragged and odd sizes, and one launch through
                     FeatureNet.forward (none in training mode)
  4d. cost_prob_kernel -- CostRegNet's prob kernel (ops/cost_prob.py: the
                     8 -> 1 3x3x3 conv) against the module's cuDNN conv at
                     the sweep's shape (D = 48, 144x200) for B = 16 and
                     B = 1, bf16 and f32 (kernel_times.time_prob): bf16
                     within one bf16 ulp, f32 within 1e-5; times, the
                     bound, the module's ms; then odd shapes (one plane,
                     ragged tiles, D = 96, a contiguous NCDHW input), and
                     one launch through CostRegNet.forward (none in
                     training mode)
  5. train_kernel -- K2 against autograd of the plain version at the
                     training shapes (B=4 at 512x640: the sweep and the two
                     refinement stages) with degenerate depths, f32 and
                     bf16 features, plus batched odd sizes through the
                     vector and scalar paths, C / K above 256 (launches
                     over channel slices) and depths that jump by decades
                     from plane to plane, in both dtypes; times as in
                     kernel, bound, global atomic counts; the width
                     shards' training shapes (x_off = W/2, d_src full
                     width), f32 and bf16
  6. small        -- the port on CUDA against the port on the CPU (the path
                     the CPU tests hold against JAX), same weights, 64x96,
                     f32 and bf16 compute
  7. main         -- CasDiffMVS export inference at DTU size (1152x1600, 5
                     views, 48/384 hypotheses, f32, random weights from
                     seed 0): 3 requests through DepthRunner; 28 K1
                     launches and one PixelViewWeight kernel launch each;
                     the first request again with the plain warp in place
                     of the kernel must agree
  8. main_bf16    -- the same in bf16 compute, beside main's maps/s and
                     peak memory
  9. main_b16     -- one forward of the bench entry's main cell (bf16, B =
                     16, 1152x1600, 5 views, 48/384), each sample with its
                     own baselines, whose warp runs K1 and holds each of
                     its 28 results against the plain warp on the same
                     inputs
 10. train_small  -- one train step of the port on CUDA against the same
                     step on the CPU at 64x96 (same weights, batch,
                     timesteps and noise), f32, and bf16 with remat:
                     loss and gradient direction
 11. train        -- the training cell: CasDiffMVS f32, B=4, 5 views,
                     512x640, 48/384 hypotheses, random init from seed 0,
                     run_training over 5 steps (the first a warm-up): 28
                     K1 + 28 K2 launches and a finite loss and gradient
                     norm every step; one step's gradients against the
                     same step with the plain warp in place of the kernels
 12. train_bf16   -- the same in bf16 compute with remat (the configuration
                     bench.py trains in): 52 K1 (the backward recomputes
                     each refinement iteration) + 28 K2 launches a step;
                     also one step's gradients with remat off; samples/s
                     and peak memory beside train's
 13. k3_kernel    -- K3 and its operand and projection kernels, warp_corr(
                     ..., batch_rows=False), their only path: the projection
                     kernel bit for bit against projection_scalars; K3
                     against its plain version and against K1 on the same
                     inputs at the sweep / stage-2 / stage-3 DTU shapes, f32
                     and bf16,
                     degenerate depths in the first row; the operand kernel
                     against corner_operands (the share of samples whose
                     operands differ, validity flips only at the image's
                     edges); times as in kernel for K3, the operands and
                     the entry, and the bounds; batched odd sizes (N=2)
                     through every instantiation (K1's odd cases: C/G = 3
                     in f32 and bf16, G = 1, 8, 257 and 520, misaligned
                     bases); the gradients through K3 against those through
                     K1 (both K2) at the training stage-3 shape
 14. export       -- the scene export entry point as a user runs it:
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
 15. train_cli    -- the training entry point through the data layer:
                     cli.train.main on a synthetic DTU training scan (5
                     views x 7 lights, 512x640 PNGs, 1200x1600 depth and
                     visibility), CasDiffMVS f32, B=4, 48/384, 2 loader
                     workers: an epoch of 8 steps and its validation,
                     --resume for the second (its first logged step 8 at
                     the schedule's learning rate), --mode test; 28 K1 +
                     28 K2 launches every step, finite losses, both
                     checkpoints; samples/s beside train's, the host gaps
                     between steps one by one with the loop's image saving
                     in each, peak memory
 16. train_cli_blend -- cli.train on a synthetic BlendedMVS scan at 576x768,
                     B=2, 2 steps from train_cli's checkpoint through
                     --loadckpt's strict .ckpt path; its step times and
                     the gap between them
 17. ddp          -- the data-parallel step (SyncBatchNorm, DDP, the global
                     batch's noise) in an NCCL group of one on 127.0.0.1
                     against the plain step, two steps of the training cell:
                     loss rel < 1e-5, gradient cosine > 0.9999, BatchNorm
                     running statistics within 1e-5 after each step
 18. sp           -- width sharding, sp = 2: two ranks on the one card in a
                     gloo group (NCCL takes one rank per card), spawned
                     with a timeout and killed on it; gloo's all_gather
                     and all_reduce on CUDA tensors checked first. The
                     sharded export forward at main's configuration (800
                     columns a rank) in f32 and bf16 against the
                     unsharded forward with the same weights (f32: final
                     depth mean rel < 1e-4, confidences max abs < 1e-3;
                     bf16: depth mean rel < 5e-2), 28 K1 launches a
                     request a rank; two training-cell steps on dp = 1 x
                     sp = 2 against the plain step (loss rel < 1e-4,
                     gradient cosine > 0.9999, BatchNorm statistics <
                     1e-5), 28 K1 + 28 K2 a step a rank; each rank's peak
                     memory and times beside the unsharded ones
 19. dp_shard     -- the data-parallel step in mode "shard" (the JAX
                     package's shard_map step: per-rank BatchNorm
                     statistics averaged after the step, per-rank noise
                     from a generator folded with the rank, per-rank mask
                     counts) in two gloo ranks on the one card: one
                     training-cell step, B = 2 a rank, 28 K1 + 28 K2 a
                     rank, against the plain per-shard computation (each
                     shard's rows in one process with that rank's
                     generator and the plain warp, gradients and
                     statistics averaged, one AdamW step): loss rel <
                     1e-5, gradient cosine > 0.9999, parameters < 1e-4 and
                     statistics < 1e-5 (relative to 1 + |value|); each
                     rank's ms and peak memory
 20. colmap       -- tools.colmap.convert(..., vggt=True) on a synthetic
                     49-image sparse model with the DeiT-S retrieval ViT
                     (random weights from seed 0) on the card: descriptors
                     against the CPU's (max abs < 1e-4), cams/ and
                     pair.txt equal to a CPU conversion's; images/s
 21. bench        -- the port's bench entry as a user runs it, `python -m
                     diffmvs_tpu_torch.bench --all` in a subprocess (with
                     a timeout): the parity gate passes (K1 forward and
                     K2 gradients within 1e-4 max relative error of the
                     plain warp), the inference line at B = 16 (bf16,
                     1152x1600, 5 views, 48/384) with 28 K1 launches a
                     forward, the training line (bf16 + remat, B = 4,
                     512x640) with 52 K1 + 28 K2 a step, the loader line;
                     every value finite and positive, every vs_baseline
                     null; the lines logged as they came
Then a JSON line of per-kernel numbers (K1's launches from main and
main_bf16, K2's from train and train_bf16, at the shards' shapes both
from sp's rank 0, K3's, the operand and the projection kernel's from the
k3_kernel entry calls, PixelViewWeight's from main, main_bf16 and
main_b16, null for its float32 volume at B = 16, which no phase runs),
the nvidia-smi line, and last {"ok": true, "device": {...}}.

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
    bound, bwd_bound, cuda_ms, k2_global_atomics, make_depth, operands_bound,
    pre_bound, sample_counts, timings, warp_bound)
from diffmvs_tpu_torch.utils import profiling

CORR_TOL = dict(rtol=1e-4, atol=1e-5)
# PixelViewWeight's kernel against the module's chain: float32 sums of 27 G
# and 216 terms in another order, ~1e-6 on the [0, 1] weights
PVW_TOL = 1e-5
# (V-1, B, D, H, W, G) of the kernel's odd cases: ragged tiles (output
# tiles of 18 x 30), one plane, G = 8
PVW_ODD = ((2, 2, 5, 7, 13, 4), (2, 1, 5, 19, 37, 4), (1, 1, 1, 9, 31, 4),
           (2, 1, 6, 19, 37, 8))
# CostRegNet's prob kernel against the module: float32 within this; bf16
# within one bf16 ulp (kernel_times.prob_errors)
PROB_F32_TOL = 1e-5
# (B, D, H, W) of the prob kernel's odd cases: one plane, ragged tiles
# (output tiles of 16 x 30), the Tanks presets' 96 planes at B = 2
PROB_ODD = ((1, 1, 9, 31), (2, 5, 25, 61), (1, 7, 1, 1), (2, 96, 33, 40))
# FeatureNet's stem kernel against the float32 chain: at most this times
# the bf16 module chain's own max and mean abs error
STEM_ERR_RATIO = 1.5
# (N, H, W) of the stem kernel's odd cases: ragged tiles (output tiles of
# 16 x 32 half-res pixels), odd sizes, the tank preset's size
STEM_ODD = ((2, 96, 160), (3, 37, 75), (1, 5, 9), (2, 1056, 1920))
# K2's bf16 gradients against the plain version's: both are the bf16
# roundings of float32 sums taken in other orders, so they differ by at
# most one bf16 ulp (2^-8 to 2^-7 relative) where a sum lies near a
# rounding boundary, and by the float32 sums' own difference near zero
BF16_GRAD_TOL = dict(rtol=2 ** -7, atol=1e-5)
REPO = Path(__file__).resolve().parent


def check(cond, what):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# (C, G, elements the bases lie off the allocator's alignment) of the
# forward kernels' odd cases: every load width, f32 float4 (C/G = 4, 8,
# 12) and scalar (C/G = 3, 6, bases 4 and 8 bytes off), bf16 uint4 (C/G =
# 8), uint2 (C/G = 4, 12 and an 8-byte base), pairs (C/G = 6, a 4-byte
# base) and scalar (C/G = 3, a 2-byte base); two or four adjacent groups
# per thread in bf16 (C/G = 12 or 4), two groups per thread (C/G <= 4,
# C/G = 4 at G = 6 in bf16 through uint2) and one; G = 1 (C/G = 48, a
# group wider than the registers hold), G = 8, and G = 520 and 257, more
# groups than a block has threads (two launches, two groups per thread and
# one)
ODD_CASES = ((12, 4, 0), (16, 4, 0), (24, 4, 0), (32, 4, 0), (48, 4, 0),
             (16, 4, 1), (32, 4, 2), (32, 4, 4), (48, 1, 0), (64, 8, 0),
             (24, 6, 0), (1040, 520, 0), (514, 257, 0))


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
        run["k1_rows_bf16"][(d, h, w, c)] = (name, row["bf16"])

    # width shards (the sp phase's shapes): rank 1 of 2, its depths and ref
    # of columns [W/2, W) at offset x_off = W/2, the source twice as wide
    for name in ("sweep", "stage2", "stage3"):
        stage, d, c, s = shapes[name]
        sp, rp, depth, h, w, x_off = shard_inputs(
            name, stage, d, s, 1, hh, ww, projs, views, dev, gen)
        src32 = torch.randn(1, h, 2 * w, c, device=dev, generator=gen)
        ref32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            src, ref = src32.to(dt), ref32.to(dt)
            with torch.inference_mode():
                got = warp_corr.warp_corr(src, ref, sp, rp, depth, 4,
                                          x_off=x_off)
                want = warp_and_correlate_plain(src.float(), ref.float(), sp,
                                                rp, depth, 4, x_off)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **CORR_TOL,
                                           msg=lambda m: f"{name} sp: {m}")
                err = (got - want).abs().max().item()
                rt = warp_corr.projection_scalars(sp, rp)
                t = timings(lambda: warp_corr.warp_corr_rt(
                    src, ref, rt, depth, 4, x_off))
                plain_ms = cuda_ms(lambda: warp_and_correlate_plain(
                    src.float(), ref.float(), sp, rp, depth, 4, x_off))
            bound_ms, bound_by = warp_bound(1, d, h, w, h, 2 * w, c, 4,
                                            src.element_size())
            log("kernel", shape=f"{name}:sp2", dtype=tag, D=d, C=c,
                hw=f"{h}x{w}", src_hw=f"{h}x{2 * w}", x_off=x_off,
                max_abs_err=f"{err:.3e}", ms=f"{t['ms']:.4f}",
                card_ms=f"{t['card_ms']:.4f}", cold_ms=f"{t['cold_ms']:.4f}",
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                bound_by=bound_by)
            rows = run["k1_rows_sp" if tag == "f32" else "k1_rows_sp_bf16"]
            rows[(d, h, w, c)] = (f"{name}:sp2", dict(
                max_abs_err=err, ms=t["ms"], card_ms=t["card_ms"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))

    # the bench entry's batch: N = 16 samples at the sweep / stage-2 /
    # stage-3 shapes, each with its own (ref, source) view pair, features
    # and (refinement) depths, so an error in a sample's offsets or
    # projection shows
    n = 16
    order = [(r, q) for r in range(views) for q in range(views) if r != q]
    errs = []
    for name in ("sweep", "stage2", "stage3"):
        stage, d, c, s = shapes[name]
        h, w = hh // s, ww // s
        pairs = torch.from_numpy(projs[stage][0]).to(dev)      # [V, 2, 4, 4]
        rp = pairs[[r for r, _ in order[:n]]]
        sp = pairs[[q for _, q in order[:n]]]
        depth = make_depth(name, n, d, h, w, dev, gen)
        src32 = torch.randn(n, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(n, h, w, c, device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{name}:{'f32' if dt == torch.float32 else 'bf16'}"
            src, ref = src32.to(dt), ref32.to(dt)
            with torch.inference_mode():
                got = warp_corr.warp_corr(src, ref, sp, rp, depth, 4)
                worst = 0.0
                for j in range(0, n, 4):       # the plain version by quarters
                    want = warp_and_correlate_plain(
                        src[j:j + 4].float(), ref[j:j + 4].float(),
                        sp[j:j + 4], rp[j:j + 4], depth[j:j + 4], 4)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        got[j:j + 4], want, **CORR_TOL,
                        msg=lambda m: f"N=16 {tag} samples {j}+: {m}")
                    worst = max(worst,
                                (got[j:j + 4] - want).abs().max().item())
            errs.append(f"{tag}={worst:.1e}")
        del src32, ref32, src, ref, got, want, depth
    log("kernel", shape="batch16", N=n, max_abs_err=",".join(errs))

    # batched samples with their own projections, odd sizes (ragged
    # tiles), degenerate depths in the first row, through every load width
    # (ODD_CASES)
    n, d, h, w = 2, 5, 37, 53
    sp, rp = odd_pairs(projs, dev)
    depth = odd_depth(n, d, h, w, dev, gen)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        for c, groups, shift in ODD_CASES:
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


def phase_pvw_kernel(run):
    """PixelViewWeight's kernel against the module's chain at the sweep's
    shape (kernel_times.time_pvw) and at odd shapes."""
    from diffmvs_tpu_torch.ops import view_weight
    from diffmvs_tpu_torch.tools.kernel_times import (
        pvw_library, pvw_module, pvw_views, time_pvw)

    dev, gen = run["dev"], run["gen"]
    res = {"pvw": {}}
    time_pvw(res, dev, gen)
    for key, r in res["pvw"].items():
        check(r["route"] == "kernel" and r["max_abs_err"] <= PVW_TOL,
              f"pvw {key}: {r}")
        log("pvw_kernel", shape=key, max_abs_err=f"{r['max_abs_err']:.3e}",
            ms=f"{r['ms']:.4f}", card_ms=f"{r['card_ms']:.4f}",
            cold_ms=f"{r['cold_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"])
    run["pvw_rows"] = res["pvw"]
    errs = []
    for v, b, d, h, w, g in PVW_ODD:
        m = pvw_module(g, dev, seed=1)
        x32 = torch.randn((v, b, d, h, w, g), device=dev, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            with torch.inference_mode():
                got = view_weight.view_weights(x, *view_weight.weights(m))
                want = pvw_library(m, pvw_views(x))
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tag = (f"{'f32' if dt == torch.float32 else 'bf16'}:"
                   f"{v}x{b}x{d}x{h}x{w}xG{g}")
            check(err <= PVW_TOL, f"pvw {tag}: max abs err {err}")
            errs.append(f"{tag}={err:.1e}")
    log("pvw_kernel", shape="odd", max_abs_err=",".join(errs))


def stem_ok(r):
    """The stem kernel's errors within STEM_ERR_RATIO of the bf16 chain's,
    and the chain's strides."""
    return (r["strides_equal"] and r["max_abs_err"]
            <= STEM_ERR_RATIO * r["module_max_abs_err"]
            and r["mean_abs_err"]
            <= STEM_ERR_RATIO * r["module_mean_abs_err"])


def phase_stem_kernel(run):
    """FeatureNet's stem kernel against the module chain at the cells'
    shapes (kernel_times.time_stem) and at odd sizes; its launches through
    FeatureNet.forward."""
    from diffmvs_tpu_torch.ops import feature_stem
    from diffmvs_tpu_torch.tools.kernel_times import (
        stem_chain, stem_errors, stem_images, stem_net, time_stem)

    dev, gen = run["dev"], run["gen"]
    res = {"stem": {}}
    time_stem(res, dev, gen)
    for key, r in res["stem"].items():
        check(r["route"] == "kernel" and stem_ok(r), f"stem {key}: {r}")
        log("stem_kernel", shape=key, **{
            k: (f"{v:.4g}" if isinstance(v, float) else v)
            for k, v in r.items() if k != "route"})
    run["stem_rows"] = res["stem"]
    errs = []
    net = stem_net(dev, seed=1)
    for n, h, w in STEM_ODD:
        x = stem_images(n, h, w, dev, gen)
        with torch.inference_mode():
            got = feature_stem.stem(x, feature_stem.params(net))
            r = dict(stem_errors(net, x, got),
                     strides_equal=got.stride() == stem_chain(net, x).stride())
        torch.cuda.synchronize()
        check(stem_ok(r), f"stem {n}x{h}x{w}: {r}")
        errs.append(f"{n}x{h}x{w}={r['max_abs_err']:.1e}/"
                    f"{r['module_max_abs_err']:.1e}")
    x = stem_images(2, 64, 96, dev, gen)
    counts = []
    for train in (False, True):
        net.train(train)
        before = profiling.counter(feature_stem.COUNTER)
        with torch.no_grad():
            net(x)
        counts.append(profiling.counter(feature_stem.COUNTER) - before)
    net.eval()
    check(counts == [1, 0], f"stem launches eval / train {counts}")
    log("stem_kernel", shape="odd", max_abs_err_kernel_vs_module=",".join(errs),
        launches_eval_train=repr(counts))


def prob_ok(r, dtype):
    """The prob kernel's errors within the bound of its dtype."""
    if dtype == torch.float32:
        return r["max_abs_err"] <= PROB_F32_TOL
    return r["max_ulp_err"] <= 1.0


def phase_cost_prob_kernel(run):
    """CostRegNet's prob kernel against the module's convolution at the
    sweep's shape (kernel_times.time_prob) and at odd shapes; its launches
    through CostRegNet.forward."""
    from diffmvs_tpu_torch.nn.costreg import CostRegNet
    from diffmvs_tpu_torch.ops import cost_prob
    from diffmvs_tpu_torch.tools.kernel_times import (
        prob_errors, prob_input, prob_module, time_prob)

    dev, gen = run["dev"], run["gen"]
    res = {"prob": {}}
    time_prob(res, dev, gen)
    for key, r in res["prob"].items():
        dtype = torch.float32 if key.endswith("f32") else torch.bfloat16
        check(r["route"] == "kernel" and prob_ok(r, dtype), f"prob {key}: {r}")
        log("cost_prob_kernel", shape=key, **{
            k: (f"{v:.4g}" if isinstance(v, float) else v)
            for k, v in r.items() if k != "route"})
    run["prob_rows"] = res["prob"]
    errs = []
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        m = prob_module(dev, dt, seed=1)
        for b, d, h, w in PROB_ODD:
            for layout in ("channels_last", "ncdhw"):
                x = prob_input(b, d, h, w, dt, dev, gen)
                if layout == "ncdhw":
                    x = x.contiguous()
                with torch.inference_mode():
                    r = prob_errors(cost_prob.prob_conv(x, m.weight),
                                    m(x)[:, 0])
                torch.cuda.synchronize()
                check(prob_ok(r, dt), f"prob {tag}:{b}x{d}x{h}x{w}:{layout}: "
                      f"{r}")
            errs.append(f"{tag}:{b}x{d}x{h}x{w}={r['max_abs_err']:.1e}/"
                        f"{r['max_ulp_err']:.2f}ulp")
    net = CostRegNet(4, dtype=torch.bfloat16).to(dev)
    x = torch.randn((2, 8, 12, 20, 4), device=dev, generator=gen).to(
        torch.bfloat16).permute(0, 4, 1, 2, 3)
    counts = []
    for train in (False, True):
        net.train(train)
        before = profiling.counter(cost_prob.COUNTER)
        with torch.no_grad():
            net(x)
        counts.append(profiling.counter(cost_prob.COUNTER) - before)
    net.eval()
    check(counts == [1, 0], f"prob launches eval / train {counts}")
    log("cost_prob_kernel", shape="odd", max_err_abs_ulp=",".join(errs),
        launches_eval_train=repr(counts))


def shard_inputs(name, stage, d, s, n, hh, ww, projs, views, dev, gen):
    """(src / ref pairs of the widest baseline, depths, h, w, x_off) of
    rank 1 of 2 width shards of a map at 1/s of hh x ww: w = ww / (2 s)
    columns at offset x_off = w."""
    h, w = hh // s, ww // (2 * s)
    pairs = torch.from_numpy(projs[stage]).to(dev)
    return (pairs[:, views - 1], pairs[:, 0],
            make_depth(name, n, d, h, w, dev, gen), h, w, w)


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
    """K2 against autograd of the plain version at the training shapes,
    f32 and bf16 features."""
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
        src32 = torch.randn(n, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(n, h, w, c, device=dev, generator=gen)
        g = torch.randn(n, 4, d, h, w, device=dev, generator=gen)
        g_out = g.permute(0, 2, 3, 4, 1)                # [N, D, H, W, G]
        samples, inside, corners = sample_counts(sp, rp, depth, h, w)
        rt = warp_corr.projection_scalars(sp, rp)
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            tol = CORR_TOL if dt == torch.float32 else BF16_GRAD_TOL
            src, ref = src32.to(dt), ref32.to(dt)
            want = grads_of(lambda a, b: warp_and_correlate_plain(
                a, b, sp, rp, depth, 4), src, ref, g_out)
            got = grads_of(lambda a, b: warp_corr.warp_corr(
                a, b, sp, rp, depth, 4), src, ref, g_out)
            torch.cuda.synchronize()
            for k, wnt, what in zip(got, want, ("d_src", "d_ref")):
                check(k.dtype == dt, f"{name} {tag} {what} dtype {k.dtype}")
                torch.testing.assert_close(
                    k.float(), wnt.float(), **tol,
                    msg=lambda m: f"{name} {tag} {what}: {m}")
            err = max((k.float() - wnt.float()).abs().max().item()
                      for k, wnt in zip(got, want))

            t = timings(lambda: warp_corr.warp_corr_backward(
                src, ref, rt, depth, g, 4))
            src_p = src.detach().requires_grad_()
            ref_p = ref.detach().requires_grad_()
            out_p = warp_and_correlate_plain(src_p, ref_p, sp, rp, depth, 4)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                out_p, (src_p, ref_p), g_out, retain_graph=True))
            del out_p
            bound_ms, bound_by = bwd_bound(n, d, h, w, h, w, c, 4, inside,
                                           corners, src.element_size())
            v4, scalar = k2_global_atomics(sp, rp, depth, h, w, c)
            log("train_kernel", shape=name, dtype=tag, N=n, D=d, C=c,
                hw=f"{h}x{w}", max_abs_err=f"{err:.3e}",
                tol=f"rtol={tol['rtol']:.3g},atol={tol['atol']:.0e}",
                ms=f"{t['ms']:.4f}", card_ms=f"{t['card_ms']:.4f}",
                cold_ms=f"{t['cold_ms']:.4f}", plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                global_atomics_v4=v4, scalar_atomics_one_per_channel=scalar,
                fewer_by=f"{scalar / max(1, v4):.2f}",
                in_image_samples=f"{inside / samples:.3f}")
            rows = run["k2_rows" if tag == "f32" else "k2_rows_bf16"]
            rows[(d, h, w, c)] = (name, dict(
                max_abs_err=err, ms=t["ms"], card_ms=t["card_ms"],
                cold_ms=t["cold_ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by))

    # width shards (the sp phase's training shapes): rank 1 of 2, the
    # source twice as wide as ref, d_src full width
    for name, (stage, d, c, s) in shapes.items():
        sp, rp, depth, h, w, x_off = shard_inputs(
            name, stage, d, s, n, hh, ww, projs, views, dev, gen)
        src32 = torch.randn(n, h, 2 * w, c, device=dev, generator=gen)
        ref32 = torch.randn(n, h, w, c, device=dev, generator=gen)
        g = torch.randn(n, 4, d, h, w, device=dev, generator=gen)
        g_out = g.permute(0, 2, 3, 4, 1)
        _, inside, corners = sample_counts(sp, rp, depth, h, 2 * w, x_off)
        rt = warp_corr.projection_scalars(sp, rp)
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            tol = CORR_TOL if dt == torch.float32 else BF16_GRAD_TOL
            src, ref = src32.to(dt), ref32.to(dt)
            want = grads_of(lambda a, b: warp_and_correlate_plain(
                a, b, sp, rp, depth, 4, x_off), src, ref, g_out)
            got = grads_of(lambda a, b: warp_corr.warp_corr(
                a, b, sp, rp, depth, 4, x_off=x_off), src, ref, g_out)
            torch.cuda.synchronize()
            for k, wnt, what in zip(got, want, ("d_src", "d_ref")):
                check(k.dtype == dt and k.shape == wnt.shape,
                      f"{name} sp {tag} {what} {k.dtype} {tuple(k.shape)}")
                torch.testing.assert_close(
                    k.float(), wnt.float(), **tol,
                    msg=lambda m: f"{name} sp {tag} {what}: {m}")
            err = max((k.float() - wnt.float()).abs().max().item()
                      for k, wnt in zip(got, want))
            t = timings(lambda: warp_corr.warp_corr_backward(
                src, ref, rt, depth, g, 4, x_off))
            src_p = src.detach().requires_grad_()
            ref_p = ref.detach().requires_grad_()
            out_p = warp_and_correlate_plain(src_p, ref_p, sp, rp, depth, 4,
                                             x_off)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                out_p, (src_p, ref_p), g_out, retain_graph=True))
            del out_p
            bound_ms, bound_by = bwd_bound(n, d, h, w, h, 2 * w, c, 4,
                                           inside, corners,
                                           src.element_size())
            log("train_kernel", shape=f"{name}:sp2", dtype=tag, N=n, D=d,
                C=c, hw=f"{h}x{w}", src_hw=f"{h}x{2 * w}", x_off=x_off,
                max_abs_err=f"{err:.3e}", ms=f"{t['ms']:.4f}",
                card_ms=f"{t['card_ms']:.4f}", cold_ms=f"{t['cold_ms']:.4f}",
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                bound_by=bound_by)
            rows = run["k2_rows_sp" if tag == "f32" else "k2_rows_sp_bf16"]
            rows[(d, h, w, c)] = (f"{name}:sp2", dict(
                max_abs_err=err, ms=t["ms"], card_ms=t["card_ms"],
                cold_ms=t["cold_ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by))

    # batched samples with odd sizes and degenerate depths in the first
    # row through the vector path (C/G = 4, 12) and the scalar one (C/G =
    # 3, 6, a base 4 bytes off), G = 1; more channel lanes than a block has
    # threads (C = 1040 vector, C = 264 and 1040 scalar: launches over
    # channel slices); then depths from 1e-2 to 1e3 drawn per pixel and
    # plane, whose corners move to other source pixels at every plane, so
    # no sum is held across planes; f32 and bf16 features
    n, d, h, w = 2, 5, 37, 53
    sp, rp = odd_pairs(projs, dev)
    wide = 10.0 ** (5.0 * torch.rand(n, d, h, w, device=dev,
                                     generator=gen) - 2.0)
    odd = []
    for dt in (torch.float32, torch.bfloat16):
        tol = CORR_TOL if dt == torch.float32 else BF16_GRAD_TOL
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
                                      generator=gen).to(dt), shift)
            ref = shifted(torch.randn(n, h, w, c, device=dev,
                                      generator=gen).to(dt), shift)
            g_out = torch.randn(n, d, h, w, groups, device=dev, generator=gen)
            want = grads_of(lambda a, b: warp_and_correlate_plain(
                a, b, sp, rp, depth, groups), src, ref, g_out)
            got = grads_of(lambda a, b: warp_corr.warp_corr(
                a, b, sp, rp, depth, groups), src, ref, g_out)
            torch.cuda.synchronize()
            tag = (f"{'f32' if dt == torch.float32 else 'bf16'}:C{c}G{groups}"
                   f"+{shift}{':wide' if depth is wide else ''}")
            for k, wnt, what in zip(got, want, ("d_src", "d_ref")):
                torch.testing.assert_close(
                    k.float(), wnt.float(), **tol,
                    msg=lambda m: f"batched_odd {tag} {what}: {m}")
            err = max((k.float() - wnt.float()).abs().max().item()
                      for k, wnt in zip(got, want))
            odd.append(f"{tag}={err:.1e}")
    v4, scalar = k2_global_atomics(sp, rp, wide, h + 3, w - 2, 16)
    log("train_kernel", shape="batched_odd", N=n, D=d, hw=f"{h}x{w}",
        src_hw=f"{h + 3}x{w - 2}", max_abs_err=",".join(odd),
        wide_depths_v4_atomics=v4, wide_depths_scalar_atomics=scalar)


def phase_small(run):
    """The CUDA path against the CPU path on a small input, f32 and bf16
    compute. bf16 gate: mean |depth diff| < 0.3 in the [4, 10] depth range,
    tests/test_torch_bf16.py's whole-model gate (cuDNN's and the CPU's
    bf16 convolutions round alike but sum in other orders, and random
    weights amplify that through the soft-argmax and the diffusion)."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    imgs_s, projs_s, dv_s = synthetic_inputs(1, 3, 64, 96, 32, seed=1)
    for dtype in ("float32", "bfloat16"):
        small = dict(numdepth_initial=8, numdepth=32, scale=(0.0, 0.0, 0.0),
                     compute_dtype=dtype)
        outs = []
        for device in ("cpu", "cuda"):
            runner = DepthRunner.from_random("casdiffmvs", device=device,
                                             seed=0, **small)
            depth_s, _ = runner(imgs_s, projs_s, dv_s)
            outs.append(depth_s.cpu())
        diff = (outs[1] - outs[0]).abs()
        if dtype == "float32":
            torch.testing.assert_close(outs[1], outs[0], rtol=5e-3,
                                       atol=5e-3)
        else:
            check(bool(torch.isfinite(outs[1]).all())
                  and diff.mean().item() < 0.3,
                  f"bf16 CUDA vs CPU mean |diff| {diff.mean().item()}")
        log("small", hw="64x96", dtype=dtype,
            max_abs_diff_cuda_vs_cpu=f"{diff.max().item():.3e}",
            mean_abs_diff_cuda_vs_cpu=f"{diff.mean().item():.3e}",
            gate=("rtol=atol=5e-3" if dtype == "float32"
                  else "mean<0.3"))


def serve(run, phase, compute_dtype, gate):
    """CasDiffMVS export inference at DTU size in compute_dtype, 3
    requests with 28 K1 launches each, then the first again with the plain
    warp: mean relative depth difference below `gate`. Returns maps/s and
    the peak memory (GiB)."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.ops import (cost_prob, feature_stem, view_weight,
                                       warp_corr)
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    hh, ww, views = 1152, 1600, 5
    # the stem kernel runs in bf16 only (a float32 stem keeps the module)
    stem_per_request = int(compute_dtype == "bfloat16")
    runner = DepthRunner.from_random("casdiffmvs", image_hw=(hh, ww),
                                     views=views, device="cuda", seed=0,
                                     numdepth_initial=48, numdepth=384,
                                     compute_dtype=compute_dtype)
    requests = [synthetic_inputs(1, views, hh, ww, 384, seed=i)
                for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    results, req_ms = [], []
    pvw0 = profiling.counter(view_weight.COUNTER)
    stem0 = profiling.counter(feature_stem.COUNTER)
    for imgs, pr, dv in requests:
        before = profiling.counter("warp_corr.k1")
        pvw = profiling.counter(view_weight.COUNTER)
        prob = profiling.counter(cost_prob.COUNTER)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth, confs = runner(imgs, pr, dv)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        results.append((depth, confs))
        k1 = profiling.counter("warp_corr.k1") - before
        check(k1 == 28, f"{k1} launches in one request")
        check(profiling.counter(view_weight.COUNTER) - pvw == 1,
              "one PixelViewWeight kernel launch a request")
        check(profiling.counter(cost_prob.COUNTER) - prob == 1,
              "one CostRegNet prob kernel launch a request")
    launches = profiling.counter("warp_corr.k1")
    pvw_launches = profiling.counter(view_weight.COUNTER) - pvw0
    stem_launches = profiling.counter(feature_stem.COUNTER) - stem0
    check(stem_launches == stem_per_request * len(requests),
          f"{stem_launches} stem kernel launches in {len(requests)} "
          f"{compute_dtype} requests")
    by_shape = dict(profiling.keyed("warp_corr.k1"))
    check(not any(profiling.counter(f"warp_corr.{k}")
                  for k in ("k2", "k3", "operands", "projection")),
          "only K1 during inference")
    peak = torch.cuda.max_memory_allocated()

    for depth, confs in results:
        check(depth.shape == (1, hh, ww) and depth.dtype == torch.float32,
              f"depth {depth.shape} {depth.dtype}")
        check(len(confs) == 3 and all(cf.shape == (1, hh, ww)
                                      for cf in confs), "3 full-res confs")
        check(bool(torch.isfinite(depth).all()) and all(
            bool(torch.isfinite(cf).all()) for cf in confs), "finite")
    check(launches == 28 * len(requests), f"{launches} kernel launches")
    check(sorted(by_shape.values()) == [12, 36, 36], f"by shape {by_shape}")

    # the first request once more, through a twin of the runner (the same
    # weights) whose model warps with the plain version
    plain = DepthRunner(runner.cfg, runner.model.state_dict(),
                        device="cuda", seed=runner.seed,
                        warp=warp_and_correlate_plain)
    depth_plain, _ = plain(*requests[0])
    check(profiling.counter("warp_corr.k1") == launches,
          "no K1 launch on the plain path")
    del plain
    rel = ((results[0][0] - depth_plain).abs()
           / depth_plain.abs().clamp_min(1e-12))
    steady = statistics.mean(req_ms[1:])
    figures = dict(maps_per_s=1e3 / steady, peak_gib=peak / 2**30)
    log(phase, dtype=compute_dtype, requests=len(requests),
        request_ms=repr([round(m, 1) for m in req_ms]),
        maps_per_s=f"{figures['maps_per_s']:.3f}",
        peak_mem_gib=f"{figures['peak_gib']:.3f}",
        launches=launches, launches_per_request=launches // len(requests),
        pvw_launches=pvw_launches, stem_launches=stem_launches,
        plain_vs_kernel_mean_rel=f"{rel.mean().item():.3e}",
        plain_vs_kernel_max_rel=f"{rel.max().item():.3e}",
        gate_mean_rel=f"{gate:.0e}")
    check(rel.mean().item() < gate, f"plain vs kernel {rel.mean().item()}")
    figures["pvw_launches"] = pvw_launches
    figures["stem_launches"] = stem_launches
    figures["prob_launches"] = len(requests)
    return by_shape, figures


def phase_main(run):
    """CasDiffMVS export inference at DTU size, f32, 3 requests."""
    run["k1_launches"], run["main_f32"] = serve(run, "main", "float32", 1e-4)


def phase_main_bf16(run):
    """The same in bf16 compute, beside main's figures. The plain warp
    computes in f32 what K1 computes, in another summation order; rounding
    the correlations to bf16 turns the rare last-bit difference into a
    bf16 ulp, which random weights amplify through the soft-argmax and the
    diffusion: the mean relative depth difference measured 1.2e-2 on an
    H100 (against 1.1e-6 in f32), so the gate is 5e-2."""
    run["k1_launches_bf16"], fig = serve(run, "main_bf16", "bfloat16", 5e-2)
    run["main_bf16"] = fig
    f32 = run["main_f32"]
    log("main_bf16", maps_per_s_bf16=f"{fig['maps_per_s']:.3f}",
        maps_per_s_f32=f"{f32['maps_per_s']:.3f}",
        peak_mem_gib_bf16=f"{fig['peak_gib']:.3f}",
        peak_mem_gib_f32=f"{f32['peak_gib']:.3f}")


def phase_main_b16(run):
    """One forward of the bench entry's main cell (bench.infer_config:
    CasDiffMVS bf16, B = 16, 1152x1600, 5 views, 48/384, random weights
    from seed 0) whose warp runs K1 and holds each of its 28 results
    against the plain warp on the same inputs, by quarters of the batch
    (CORR_TOL). Sample i scales its sources' baselines by 1 + i / 16, so
    each sample has its own projections."""
    import numpy as np

    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.bench import infer_config
    from diffmvs_tpu_torch.ops import cost_prob, feature_stem, view_weight
    from diffmvs_tpu_torch.ops.correlation import (warp_and_correlate,
                                                   warp_and_correlate_plain)
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    dev = run["dev"]
    cfg, shape = infer_config("cuda")
    n = shape.batch
    worst, calls = {}, []

    def checked(src, ref, sp, rp, depth, groups, x_off=0):
        got = warp_and_correlate(src, ref, sp, rp, depth, groups, x_off)
        key = (f"{tuple(depth.shape[1:])}:C{src.shape[-1]}:"
               f"{str(src.dtype)[6:]}")
        calls.append((src.shape[0], key))
        for j in range(0, src.shape[0], 4):
            want = warp_and_correlate_plain(
                src[j:j + 4], ref[j:j + 4], sp[j:j + 4], rp[j:j + 4],
                depth[j:j + 4], groups, x_off)
            torch.cuda.synchronize()
            torch.testing.assert_close(got[j:j + 4], want, **CORR_TOL,
                                       msg=lambda m: f"{key} {j}+: {m}")
            worst[key] = max(worst.get(key, 0.0),
                             (got[j:j + 4] - want).abs().max().item())
        return got

    imgs, projs, dv = synthetic_inputs(n, 5, shape.h, shape.w, cfg.numdepth)
    for p in projs.values():
        p[:, 1:, 0, :3, 3] *= (1.0 + np.arange(n) / n).reshape(n, 1, 1)
    runner = DepthRunner(cfg, device=dev, seed=0, warp=checked)
    t0 = time.time()
    pvw = profiling.counter(view_weight.COUNTER)
    stem = profiling.counter(feature_stem.COUNTER)
    prob = profiling.counter(cost_prob.COUNTER)
    depth, confs = runner(imgs, projs, dv)
    torch.cuda.synchronize()
    run["prob_launches_b16"] = profiling.counter(cost_prob.COUNTER) - prob
    check(run["prob_launches_b16"] == 1,
          f"{run['prob_launches_b16']} prob kernel launches a forward")
    run["pvw_launches_b16"] = profiling.counter(view_weight.COUNTER) - pvw
    run["stem_launches_b16"] = profiling.counter(feature_stem.COUNTER) - stem
    check(run["stem_launches_b16"] == 1,
          f"{run['stem_launches_b16']} stem kernel launches a forward")
    check(len(calls) == 28 and all(b == n for b, _ in calls),
          f"{len(calls)} warps, batches {sorted({b for b, _ in calls})}")
    check(run["pvw_launches_b16"] == 1,
          f"{run['pvw_launches_b16']} PixelViewWeight launches a forward")
    check(depth.shape == (n, shape.h, shape.w)
          and bool(torch.isfinite(depth).all()), f"depth {depth.shape}")
    log("main_b16", batch=n, warps=len(calls),
        by_shape=repr({k: sum(1 for _, c in calls if c == k)
                       for k in worst}),
        max_abs_err=repr({k: f"{v:.1e}" for k, v in worst.items()}),
        seconds=f"{time.time() - t0:.1f}")
    del runner, depth, confs
    torch.cuda.empty_cache()


def phase_train_small(run):
    """One train step on CUDA against the same step on the CPU, 64x96:
    f32, and bf16 with remat (gates: loss rel < 2e-3, gradient cosine >
    0.99, tests/test_torch_bf16.py's gates against JAX's bf16 step)."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step
    from diffmvs_tpu_torch.utils.synthetic import (
        synthetic_train_batch, synthetic_train_overrides)

    batch = synthetic_train_batch(2, 3, 64, 96, 32, seed=1)
    for dtype, loss_gate, cos_gate in (("float32", 1e-4, 0.9999),
                                       ("bfloat16", 2e-3, 0.99)):
        model_cfg = dataclasses.replace(
            MODEL_PRESETS["casdiffmvs"], numdepth_initial=8, numdepth=32,
            compute_dtype=dtype, remat=dtype == "bfloat16")
        cfg = TrainConfig(model=model_cfg, batch_size=2)
        overrides = synthetic_train_overrides(model_cfg, 2, 64, 96, seed=2)
        res = []
        for device in ("cpu", "cuda"):
            state = create_train_state(cfg, steps_per_epoch=1,
                                       device=device, seed=0)
            scalars, images = train_step(state, cfg, batch,
                                         train_overrides=overrides)
            res.append((float(scalars["loss"]),
                        flat_grads(state.model).cpu(),
                        images["depth_est_nomask"].cpu()))
        (loss_cpu, g_cpu, d_cpu), (loss_cuda, g_cuda, d_cuda) = res
        rel = abs(loss_cuda - loss_cpu) / abs(loss_cpu)
        cos = cosine(g_cuda, g_cpu)
        log("train_small", hw="64x96", B=2, views=3, dtype=dtype,
            remat=model_cfg.remat, loss_cpu=f"{loss_cpu:.7f}",
            loss_cuda=f"{loss_cuda:.7f}", loss_rel=f"{rel:.3e}",
            depth_max_abs_diff=f"{(d_cuda - d_cpu).abs().max().item():.3e}",
            grad_cosine=f"{cos:.9f}",
            gates=f"loss_rel<{loss_gate:.0e},cosine>{cos_gate}")
        check(rel < loss_gate, f"train step {dtype} loss CUDA vs CPU rel "
              f"{rel}")
        check(cos > cos_gate, f"train step {dtype} gradient cosine CUDA vs "
              f"CPU {cos}")


def train_cell(run, phase, model_cfg, gates):
    """The training cell through run_training (5 steps), then one step's
    gradients with the kernels against the plain warp. gates: (loss rel,
    mean depth rel, gradient cosine). Returns (K2 launches by shape,
    {samples_per_s, peak_gib}, the state, cfg, batch, overrides)."""
    from diffmvs_tpu_torch.config import TrainConfig
    from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
    from diffmvs_tpu_torch.ops import cost_prob, warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.train.loop import run_training
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import (batch_to_device,
                                              compute_gradients)
    from diffmvs_tpu_torch.utils.synthetic import (
        synthetic_train_batch, synthetic_train_overrides)

    b, views, hh, ww, steps = 4, 5, 512, 640, 5
    check(model_cfg.numdepth_initial == 48 and model_cfg.numdepth == 384,
          "the preset's widths")
    # K1 per step: each source view's sweep and refinement iterations, and
    # the iterations once more in the backward under remat; K2 per step:
    # the backward of each forward warp
    iters = sum(model_cfg.stage_iters[1:])
    k1_step = (views - 1) * (1 + (2 if model_cfg.remat else 1) * iters)
    k2_step = (views - 1) * (1 + iters)
    k1_eval = (views - 1) * (1 + iters)
    cfg = TrainConfig(model=model_cfg, batch_size=b, epochs=1,
                      summary_freq=1, seed=0)
    state = create_train_state(cfg, steps_per_epoch=steps, device="cuda",
                               seed=0)
    check({p.dtype for p in state.model.parameters()} == {torch.float32},
          "float32 parameters")
    batches = [synthetic_train_batch(b, views, hh, ww, 384, seed=i)
               for i in range(steps)]
    logdir = REPO / "build" / f"chip_smoke_{phase}"
    shutil.rmtree(logdir, ignore_errors=True)

    marks = []

    def on_step(step, scalars):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), profiling.counter("warp_corr.k1"),
                      profiling.counter("warp_corr.k2"),
                      float(scalars["loss"]), float(scalars["grad_norm"])))

    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), 0, 0, 0.0, 0.0))
    prob0 = profiling.counter(cost_prob.COUNTER)
    run_training(state, cfg, batches, batches[:1], str(logdir),
                 on_step=on_step)
    torch.cuda.synchronize()
    prob_launches = profiling.counter(cost_prob.COUNTER) - prob0
    check(prob_launches == 1, f"{prob_launches} prob kernel launches in "
          f"{steps} training steps and one validation batch (1 wanted)")
    k2_launches = dict(profiling.keyed("warp_corr.k2"))
    k1_total = profiling.counter("warp_corr.k1")
    k2_total = profiling.counter("warp_corr.k2")
    check(not any(profiling.counter(f"warp_corr.{k}")
                  for k in ("k3", "operands", "projection")),
          "no K3, operand or projection launches in training")
    peak = torch.cuda.max_memory_allocated()
    check(all(s["exp_avg"].dtype == torch.float32
              for s in state.optimizer.state.values()),
          "float32 optimizer state")

    step_ms = []
    for prev, cur in zip(marks, marks[1:]):
        check(cur[1] - prev[1] == k1_step, f"{cur[1] - prev[1]} K1 "
              f"launches in a step, not {k1_step}")
        check(cur[2] - prev[2] == k2_step, f"{cur[2] - prev[2]} K2 "
              f"launches in a step, not {k2_step}")
        check(all(math.isfinite(v) for v in cur[3:]),
              f"loss / gradient norm {cur[3:]}")
        step_ms.append((cur[0] - prev[0]) * 1e3)
    check(len(step_ms) == steps, f"{len(step_ms)} steps")
    check(k2_total == k2_step * steps, f"{k2_total} K2 launches")
    check(k1_total == k1_step * steps + k1_eval, f"{k1_total} K1 launches "
          f"(with one validation batch)")
    check(sorted(k2_launches.values()) == [4 * steps, 12 * steps,
                                           12 * steps],
          f"K2 by shape {k2_launches}")
    check((logdir / "model_000000.ckpt").exists(), "checkpoint written")

    # one step's gradients, kernels against the plain warp (same weights,
    # batch, timesteps and noise)
    batch = batch_to_device(batches[0], state.device)
    overrides = synthetic_train_overrides(model_cfg, b, hh, ww, seed=7)

    def loss_and_grads(model=state.model):
        k1 = profiling.counter("warp_corr.k1")
        k2 = profiling.counter("warp_corr.k2")
        prob = profiling.counter(cost_prob.COUNTER)
        loss, _, outputs, _ = compute_gradients(model, cfg, batch,
                                                train_overrides=overrides)
        torch.cuda.synchronize()
        check(profiling.counter(cost_prob.COUNTER) == prob,
              "no prob kernel launch in a training step")
        counts = (profiling.counter("warp_corr.k1") - k1,
                  profiling.counter("warp_corr.k2") - k2)
        return (loss.item(), flat_grads(model),
                outputs["depth"][-1].detach(), counts)

    loss_k, g_k, depth_k, counts_k = loss_and_grads()
    # a twin of the model (the same weights and statistics) whose stages
    # warp with the plain version
    plain = CasDiffMVS(model_cfg, warp=warp_and_correlate_plain)
    plain.load_state_dict(state.model.state_dict())
    loss_p, g_p, depth_p, counts_p = loss_and_grads(plain.to(state.device))
    del plain
    check(counts_k == (k1_step, k2_step) and counts_p == (0, 0),
          f"launches with the kernels {counts_k}, with the plain warp "
          f"{counts_p}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = cosine(g_k, g_p)
    depth_rel = ((depth_k - depth_p).abs()
                 / depth_p.abs().clamp_min(1e-12)).mean().item()
    steady = statistics.mean(step_ms[1:])
    figures = dict(samples_per_s=b * 1e3 / steady, peak_gib=peak / 2**30)
    log(phase, dtype=model_cfg.compute_dtype, remat=model_cfg.remat, B=b,
        views=views, hw=f"{hh}x{ww}", steps=steps,
        step_ms=repr([round(m, 1) for m in step_ms]),
        samples_per_s=f"{figures['samples_per_s']:.3f}",
        peak_mem_gib=f"{figures['peak_gib']:.3f}",
        losses=repr([round(m[3], 4) for m in marks[1:]]),
        k1_per_step=k1_step, k2_per_step=k2_step,
        plain_vs_kernel_loss_rel=f"{rel:.3e}",
        plain_vs_kernel_depth_mean_rel=f"{depth_rel:.3e}",
        plain_vs_kernel_grad_cosine=f"{cos:.8f}",
        gates=f"loss_rel<{gates[0]:.0e},depth_rel<{gates[1]:.0e},"
              f"cosine>{gates[2]}")
    check(rel < gates[0], f"train loss kernel vs plain rel {rel}")
    check(depth_rel < gates[1], f"train depth kernel vs plain rel "
          f"{depth_rel}")
    check(cos > gates[2], f"train gradients kernel vs plain cosine {cos}")
    return (k2_launches, figures,
            (state, cfg, batch, overrides, g_k, loss_and_grads))


def phase_train(run):
    """The f32 training cell through run_training, then kernel vs plain."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS

    model_cfg = MODEL_PRESETS["casdiffmvs"]
    check(model_cfg.compute_dtype == "float32" and not model_cfg.remat,
          "the preset's f32 policy")
    run["k2_launches"], run["train_f32"], _ = train_cell(
        run, "train", model_cfg, (1e-5, 1e-4, 0.9999))


def phase_train_bf16(run):
    """The bf16 + remat training cell (bench.py's training configuration),
    beside train's figures; then the same step with remat off: the same
    gradients, and the peak memory of one step each way."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS

    model_cfg = dataclasses.replace(MODEL_PRESETS["casdiffmvs"],
                                    compute_dtype="bfloat16", remat=True)
    # gates: loss rel < 1e-4, mean depth rel < 1e-2, gradient cosine >
    # 0.9995 (measured on an H100: 1.4e-5, 1.3e-3, 0.99998; the plain warp
    # and K1 differ in f32 summation order, which bf16 rounding of the
    # correlations and random weights amplify as in main_bf16)
    k2, fig, (state, cfg, batch, overrides, g_on, loss_and_grads) = \
        train_cell(run, "train_bf16", model_cfg, (1e-4, 1e-2, 0.9995))
    run["k2_launches_bf16"] = k2

    blocks = [m for m in state.model.modules() if hasattr(m, "remat")]
    check(len(blocks) == 2 and all(m.remat for m in blocks),
          "remat on in both refinement stages")
    peaks = {}
    for remat in (True, False):
        for m in blocks:
            m.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, grads, _, counts = loss_and_grads()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
        if not remat:
            g_off, counts_off = grads, counts
    for m in blocks:
        m.remat = True
    cos = cosine(g_on, g_off)
    check(counts_off == (28, 28), f"remat off: {counts_off} launches")
    check(cos > 0.9999, f"remat on vs off gradient cosine {cos}")
    f32 = run["train_f32"]
    log("train_bf16", remat_on_vs_off_grad_cosine=f"{cos:.8f}",
        step_peak_gib_remat_on=f"{peaks[True]:.3f}",
        step_peak_gib_remat_off=f"{peaks[False]:.3f}",
        samples_per_s_bf16=f"{fig['samples_per_s']:.3f}",
        samples_per_s_f32=f"{f32['samples_per_s']:.3f}",
        peak_mem_gib_bf16=f"{fig['peak_gib']:.3f}",
        peak_mem_gib_f32=f"{f32['peak_gib']:.3f}")


def operand_check(kops, src, sp, rp, depth):
    """The operand kernel's (xi, yi, fx, fy, valid) against corner_operands
    on the same inputs: (samples, samples where any operand differs,
    validity flips farther than 1e-5 relative from the validity's edges
    x = -1, Ws and y = -1, Hs, max abs difference of the fractions)."""
    from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
    from diffmvs_tpu_torch.ops import warp_corr

    hs, ws = src.shape[1], src.shape[2]
    with torch.inference_mode():
        want = warp_corr.corner_operands(src, sp, rp, depth)
        rt = warp_corr.projection_scalars(sp, rp)
        x, y = plane_sweep_coords(rt[:, :9].reshape(-1, 3, 3), rt[:, 9:],
                                  depth)
    differ = torch.zeros_like(want[4])
    for a, b in zip(kops, want):
        differ |= a != b
    edge = torch.zeros_like(differ)
    for v, edges in ((x, (-1.0, ws)), (y, (-1.0, hs))):
        for e in edges:
            edge |= (v - e).abs() <= 1e-5 * (abs(e) + 1.0)
    far_flips = int(((kops[4] != want[4]) & ~edge).sum())
    frac = max((a - b).abs().max().item() for a, b in zip(kops[2:4],
                                                          want[2:4]))
    return differ.numel(), int(differ.sum()), far_flips, frac


def phase_k3_kernel(run):
    """K3 (the batch_rows=False mode) and its operand and projection
    kernels against their plain versions, K3 against K1."""
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
    k3_names = ("warp_corr.k3", "warp_corr.operands", "warp_corr.projection")
    with torch.inference_mode():
        for name, d, c, h, w, sp, rp, depth, src, ref in cases:
            before = [profiling.counter(n) for n in k3_names]
            outs.append(warp_corr.warp_corr(src, ref, sp, rp, depth, 4,
                                            batch_rows=False))
            counts.append(tuple(profiling.counter(n) - b
                                for n, b in zip(k3_names, before)))
            check(counts[-1] == (1, 1, 1), f"{counts[-1]} K3 / operand / "
                  f"projection launches in one call")
    torch.cuda.synchronize()
    k3, ops, proj, k1 = (profiling.counter(n)
                         for n in (*k3_names, "warp_corr.k1"))
    check(k3 == ops == proj == len(cases) and k1 == 0,
          f"{k3} K3 / {ops} operand / {proj} projection / {k1} K1 launches")
    projection_launches = proj
    operand_launches = {}
    for (name, *_), (_, n_ops, _) in zip(cases, counts):
        operand_launches[name] = operand_launches.get(name, 0) + n_ops

    samples = mismatched = 0
    for (name, d, c, h, w, sp, rp, depth, src, ref), got, (count, *_) in zip(
            cases, outs, counts):
        tag = "f32" if src.dtype == torch.float32 else "bf16"
        rt = warp_corr.projection_scalars(sp, rp)
        rt_kernel = warp_corr.launch_projection(sp, rp)
        check(torch.equal(rt_kernel, rt),
              f"projection kernel {name} differs from projection_scalars")
        with torch.inference_mode():
            kops = warp_corr.launch_operands(rt, depth, h, w)
            want = corner_correlate_plain(src, ref, *kops, 4)
            k1 = warp_corr.warp_corr(src, ref, sp, rp, depth, 4)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_k1 = (got - k1).abs().max().item()
        check(err <= 1e-5, f"K3 {name} {tag} vs plain {err}")
        check(err_k1 <= 1e-5, f"K3 {name} {tag} vs K1 {err_k1}")
        check(bool(torch.isfinite(got).all()), "K3 finite")
        t = timings(lambda: warp_corr.launch_pre(src, ref, *kops, 4))
        entry = timings(lambda: warp_corr.warp_corr(
            src, ref, sp, rp, depth, 4, batch_rows=False))
        k1_ms = cuda_ms(lambda: warp_corr.warp_corr_rt(src, ref, rt, depth,
                                                       4), spin=True)
        plain_ms = cuda_ms(lambda: corner_correlate_plain(src, ref, *kops,
                                                          4))
        bound_ms, bound_by = pre_bound(1, d, h, w, h, w, c, 4,
                                       src.element_size())
        if name == "sweep" and tag == "f32":
            t_pr = timings(lambda: warp_corr.launch_projection(sp, rp))
            plain_pr_ms = cuda_ms(lambda: warp_corr.projection_scalars(sp,
                                                                        rp))
            pr_bound, pr_by = bound(2 * 128 + 48, 300)
            log("k3_kernel", projection="sweep", N=1, equal_bits=True,
                ms=f"{t_pr['ms']:.4f}", card_ms=f"{t_pr['card_ms']:.4f}",
                cold_ms=f"{t_pr['cold_ms']:.4f}",
                plain_ms=f"{plain_pr_ms:.4f}", bound_ms=f"{pr_bound:.6f}",
                bound_by=pr_by)
            run["projection_row"] = dict(
                max_abs_err=(rt_kernel - rt).abs().max().item(),
                ms=t_pr["ms"], card_ms=t_pr["card_ms"],
                cold_ms=t_pr["cold_ms"], plain_ms=plain_pr_ms,
                bound_ms=pr_bound, bound_by=pr_by,
                launches=projection_launches)
        if tag == "f32":
            # the operand kernel once per shape (it reads no features)
            n_all, n_diff, far, frac = operand_check(kops, src, sp, rp,
                                                     depth)
            check(far == 0, f"operands {name}: {far} validity flips away "
                  f"from the edges")
            samples += n_all
            mismatched += n_diff
            t_ops = timings(lambda: warp_corr.launch_operands(rt, depth, h,
                                                              w))
            plain_ops_ms = cuda_ms(lambda: warp_corr.corner_operands(
                src, sp, rp, depth))
            ops_bound, ops_by = operands_bound(1, d, h, w)
            log("k3_kernel", operands=name, D=d, hw=f"{h}x{w}",
                mismatched=f"{n_diff}/{n_all}", far_flips=far,
                frac_max_abs_err=f"{frac:.3e}", ms=f"{t_ops['ms']:.4f}",
                card_ms=f"{t_ops['card_ms']:.4f}",
                cold_ms=f"{t_ops['cold_ms']:.4f}",
                plain_ms=f"{plain_ops_ms:.4f}", bound_ms=f"{ops_bound:.4f}",
                bound_by=ops_by)
            run["operand_rows"].append((name, dict(
                max_abs_err=frac, ms=t_ops["ms"], card_ms=t_ops["card_ms"],
                cold_ms=t_ops["cold_ms"], plain_ms=plain_ops_ms,
                bound_ms=ops_bound, bound_by=ops_by,
                launches=operand_launches[name], mismatched=n_diff)))
        log("k3_kernel", shape=name, dtype=tag, D=d, C=c, hw=f"{h}x{w}",
            max_abs_err=f"{err:.3e}", vs_k1_max_abs=f"{err_k1:.3e}",
            ms=f"{t['ms']:.4f}", card_ms=f"{t['card_ms']:.4f}",
            cold_ms=f"{t['cold_ms']:.4f}", entry_ms=f"{entry['ms']:.4f}",
            entry_card_ms=f"{entry['card_ms']:.4f}",
            k1_card_ms=f"{k1_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
        run["k3_rows"].append((f"{name}" if tag == "f32" else f"{name}:bf16",
                               dict(max_abs_err=err, ms=t["ms"],
                                    card_ms=t["card_ms"],
                                    cold_ms=t["cold_ms"], plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    launches=count)))

    # batched samples with their own projections, odd sizes (ragged tiles)
    # and degenerate depths in the first row, through every instantiation
    # K1 has (ODD_CASES) and bf16 C/G = 4 at a base 4 bytes off: C/G = 3 in
    # f32 and bf16, G = 1 (a group wider than 16 channels), G = 8, 257 and
    # 520, misaligned bases
    n, d, h, w = 2, 5, 37, 53
    sp, rp = odd_pairs(projs, dev)
    depth = odd_depth(n, d, h, w, dev, gen)
    check(torch.equal(warp_corr.launch_projection(sp, rp),
                      warp_corr.projection_scalars(sp, rp)),
          "projection kernel batched_odd differs from projection_scalars")
    with torch.inference_mode():
        kops = warp_corr.launch_operands(warp_corr.projection_scalars(sp, rp),
                                         depth, h + 3, w - 2)
    odd = []
    for dt in (torch.float32, torch.bfloat16):
        for c, groups, shift in ODD_CASES + ((16, 4, 2),):
            src = shifted(torch.randn(n, h + 3, w - 2, c, device=dev,
                                      generator=gen).to(dt), shift)
            ref = shifted(torch.randn(n, h, w, c, device=dev,
                                      generator=gen).to(dt), shift)
            with torch.inference_mode():
                got = warp_corr.warp_corr(src, ref, sp, rp, depth, groups,
                                          batch_rows=False)
                want = corner_correlate_plain(src, ref, *kops, groups)
                k1 = warp_corr.warp_corr(src, ref, sp, rp, depth, groups)
            torch.cuda.synchronize()
            tag = (f"{'f32' if dt == torch.float32 else 'bf16'}:"
                   f"C{c}G{groups}+{shift}")
            err = (got - want).abs().max().item()
            err_k1 = (got - k1).abs().max().item()
            check(err <= 1e-5, f"K3 batched_odd {tag} vs plain {err}")
            check(err_k1 <= 1e-5, f"K3 batched_odd {tag} vs K1 {err_k1}")
            odd.append(f"{tag}={max(err, err_k1):.1e}")
    n_all, n_diff, far, frac = operand_check(kops, src, sp, rp, depth)
    check(far == 0, f"operands batched_odd: {far} validity flips away "
          f"from the edges")
    samples += n_all
    mismatched += n_diff
    log("k3_kernel", shape="batched_odd", N=n, D=d, hw=f"{h}x{w}",
        src_hw=f"{h + 3}x{w - 2}", max_abs_err_vs_plain_and_k1=",".join(odd),
        operands_mismatched=f"{n_diff}/{n_all}")
    share = mismatched / samples
    log("k3_kernel", operand_samples=samples, operands_mismatched=mismatched,
        mismatch_share=f"{share:.3e}")
    check(share <= 1e-6, f"operand mismatch share {share}")

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
    check(torch.equal(warp_corr.launch_projection(sp, rp),
                      warp_corr.projection_scalars(sp, rp)),
          "projection kernel (N = 4) differs from projection_scalars")
    names = ("warp_corr.k3", "warp_corr.k2", "warp_corr.operands",
             "warp_corr.projection")
    before = [profiling.counter(n) for n in names]
    k3 = grads_of(lambda a, b: warp_corr.warp_corr(
        a, b, sp, rp, depth, 4, batch_rows=False), src, ref, g_out)
    check(tuple(profiling.counter(n) - b for n, b in zip(names, before))
          == (1, 1, 1, 1), "projection + operands + K3 forward + K2 backward")
    k1 = grads_of(lambda a, b: warp_corr.warp_corr(
        a, b, sp, rp, depth, 4), src, ref, g_out)
    torch.cuda.synchronize()
    cos = cosine(torch.cat([x.flatten() for x in k3]).double(),
                 torch.cat([x.flatten() for x in k1]).double())
    diff = max((a - b).abs().max().item() for a, b in zip(k3, k1))
    check(cos > 0.9999, f"K3 vs K1 gradient cosine {cos}")
    log("k3_kernel", grad_shape=f"N={n} D={d} C={c} {h}x{w}",
        grad_cosine_vs_k1=f"{cos:.9f}", grad_max_abs_diff=f"{diff:.3e}")


def arc_extrinsic(i, views):
    """World-to-camera extrinsic of camera i of `views` on a gentle arc
    (4.6 degrees apart) 650 mm from a point in front of the middle one."""
    import numpy as np

    center = np.array([0.0, 0.0, 650.0])
    th = 0.08 * (i - views // 2)
    rot_y = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
    cam_center = center + rot_y @ np.array([0.0, 0.0, -650.0])
    e = np.eye(4)
    e[:3, :3] = rot_y.T
    e[:3, 3] = -rot_y.T @ cam_center
    return e


def write_cam_txt(path, e, k, depth_line):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for r in range(4):
            f.write(" ".join(f"{v:.6f}" for v in e[r]) + "\n")
        f.write("\nintrinsic\n")
        for r in range(3):
            f.write(" ".join(f"{v:.6f}" for v in k[r]) + "\n")
        f.write(f"\n{depth_line}\n")


def write_pair_txt(path, views):
    """Every other view for every view, nearest first, scores > 0.1."""
    with open(path, "w") as f:
        f.write(f"{views}\n")
        for i in range(views):
            others = sorted((j for j in range(views) if j != i),
                            key=lambda j: abs(j - i))
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {10.0 / abs(j - i):.2f}" for j in others) + "\n")


def blocky_image(rng, hh, ww, block=16):
    """A random uint8 [hh, ww, 3] image of block x block squares."""
    import numpy as np

    low = rng.randint(0, 256, (hh // block, ww // block, 3)).astype(np.uint8)
    return np.kron(low, np.ones((block, block, 1), np.uint8))


def make_dtu_scan(root, scan, views, hh, ww, seed=0):
    """A DTU-layout scan: scanN/images/*.npy (uint8 serving caches at the
    eval size), cams_1/*_cam.txt and a pair.txt that lists, for every view,
    the other views with scores > 0.1. The cameras sit on arc_extrinsic's
    arc, with DTU-like intrinsics and the DTU depth range 425-935 mm."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = root / scan
    (base / "images").mkdir(parents=True)
    (base / "cams_1").mkdir()
    k = np.array([[2892.3, 0.0, ww / 2 + 23.0], [0.0, 2883.2, hh / 2 - 8.0],
                  [0.0, 0.0, 1.0]], np.float32)
    for i in range(views):
        np.save(base / "images" / f"{i:08d}.npy", blocky_image(rng, hh, ww))
        write_cam_txt(base / "cams_1" / f"{i:08d}_cam.txt",
                      arc_extrinsic(i, views), k, "425.0 2.5 192 935.0")
    write_pair_txt(base / "pair.txt", views)


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
    k1 = profiling.counter("warp_corr.k1")
    by_shape = dict(profiling.keyed("warp_corr.k1"))
    check(k1 == 28 * views, f"{k1} K1 launches for {views} views")
    check(sorted(by_shape.values()) == [views * 4, views * 12, views * 12],
          f"K1 by shape {by_shape}")
    check(not any(profiling.counter(f"warp_corr.{k}")
                  for k in ("k2", "k3", "operands", "projection")),
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


def make_dtu_train_tree(root, scan, views, seed=0):
    """The DTU training layout (MVSNet's preprocessing) for one scan:
    Rectified/{scan}_train/rect_{v+1:03}_{light}_r5000.png (7 lights,
    512x640 uint8), Depths_raw/{scan}/depth_map_{v:04}.pfm and
    depth_visual_{v:04}.png at 1200x1600, Cameras/pair.txt, and
    Cameras/train/{v:08}_cam.txt with DTU's 1/4-resolution intrinsics of
    the 512x640 crop and its depth line 'depth_min interval' (425 mm, 2.5
    mm). The cameras sit on arc_extrinsic's arc; the GT depth is a plane
    slanting from 550 to 750 mm across the image; the visibility is 255
    but for a band along the top."""
    import numpy as np
    from PIL import Image

    from diffmvs_tpu_torch.data.io import save_pfm

    rng = np.random.RandomState(seed)
    (root / "Cameras" / "train").mkdir(parents=True)
    (root / f"Rectified/{scan}_train").mkdir(parents=True)
    (root / f"Depths_raw/{scan}").mkdir(parents=True)
    k = np.array([[361.54, 0.0, 82.90], [0.0, 360.40, 66.38],
                  [0.0, 0.0, 1.0]])
    depth = np.broadcast_to(np.linspace(550.0, 750.0, 1600, dtype=np.float32),
                            (1200, 1600))
    vis = np.full((1200, 1600), 255, np.uint8)
    vis[:160] = 0
    for i in range(views):
        write_cam_txt(root / "Cameras" / "train" / f"{i:08d}_cam.txt",
                      arc_extrinsic(i, views), k, "425.0 2.5")
        for light in range(7):
            Image.fromarray(blocky_image(rng, 512, 640)).save(
                root / f"Rectified/{scan}_train" /
                f"rect_{i + 1:0>3}_{light}_r5000.png")
        save_pfm(str(root / f"Depths_raw/{scan}/depth_map_{i:0>4}.pfm"),
                 np.ascontiguousarray(depth))
        Image.fromarray(vis).save(
            root / f"Depths_raw/{scan}/depth_visual_{i:0>4}.png")
    write_pair_txt(root / "Cameras" / "pair.txt", views)


def make_blend_scan(root, scan, views, hh, ww, seed=0):
    """A BlendedMVS-layout scan: blended_images/*.jpg, rendered_depth_maps/
    *.pfm (a plane slanting from 600 to 700 mm) and cams/ with full-
    resolution intrinsics, the depth line 'min interval planes max' and
    pair.txt; the cameras on arc_extrinsic's arc."""
    import numpy as np
    from PIL import Image

    from diffmvs_tpu_torch.data.io import save_pfm

    rng = np.random.RandomState(seed)
    base = root / scan
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        (base / sub).mkdir(parents=True)
    k = np.array([[1.2 * ww, 0.0, ww / 2], [0.0, 1.2 * ww, hh / 2],
                  [0.0, 0.0, 1.0]])
    depth = np.broadcast_to(np.linspace(600.0, 700.0, ww, dtype=np.float32),
                            (hh, ww))
    for i in range(views):
        Image.fromarray(blocky_image(rng, hh, ww)).save(
            base / "blended_images" / f"{i:08d}.jpg", quality=90)
        write_cam_txt(base / "cams" / f"{i:08d}_cam.txt",
                      arc_extrinsic(i, views), k, "425.0 2.5 192 935.0")
        save_pfm(str(base / "rendered_depth_maps" / f"{i:08d}.pfm"),
                 np.ascontiguousarray(depth))
    write_pair_txt(base / "cams" / "pair.txt", views)


class StepMarks:
    """Patches train/loop's train_step and save_images for a phase: for
    every step its host-clock start and end (the card synchronized at
    both), its K1 / K2 launches and the host ms of the images the loop
    saved after it; close() restores both."""

    def __init__(self):
        from diffmvs_tpu_torch.ops import warp_corr
        from diffmvs_tpu_torch.train import loop

        self.loop, self.fn, self.steps = loop, loop.train_step, []
        self.save = loop.save_images

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            k1 = profiling.counter("warp_corr.k1")
            k2 = profiling.counter("warp_corr.k2")
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.steps.append(dict(
                start=t0, end=time.perf_counter(), images_ms=0.0,
                k1=profiling.counter("warp_corr.k1") - k1,
                k2=profiling.counter("warp_corr.k2") - k2))
            return out

        def save_images(*args, **kwargs):
            t0 = time.perf_counter()
            self.save(*args, **kwargs)
            self.steps[-1]["images_ms"] += 1e3 * (time.perf_counter() - t0)

        loop.train_step = timed
        loop.save_images = save_images

    def close(self):
        self.loop.train_step = self.fn
        self.loop.save_images = self.save
        return self.steps


def train_cli_run(argv, b):
    """cli.train.main(argv) with StepMarks; checks 28 K1 and 28 K2
    launches every step. Returns (main's result, the steps, samples/s
    after the first step, the host gaps between steps in ms: the loader's
    wait and the loop's logging, and of those the ms of the images the
    loop saved in each)."""
    from diffmvs_tpu_torch.cli import train as cli_train

    marks = StepMarks()
    try:
        res = cli_train.main(argv)
    finally:
        steps = marks.close()
    for i, st in enumerate(steps):
        check((st["k1"], st["k2"]) == (28, 28),
              f"step {i}: {st['k1']} K1 / {st['k2']} K2 launches, not 28 / 28")
    rate = (b * (len(steps) - 1) / (steps[-1]["end"] - steps[0]["end"])
            if len(steps) > 1 else float("nan"))
    gaps = [1e3 * (cur["start"] - prev["end"])
            for prev, cur in zip(steps, steps[1:])]
    return res, steps, rate, gaps, [st["images_ms"] for st in steps[:-1]]


def ms_list(xs):
    return repr([round(x, 1) for x in xs])


def data_wait_ms(gaps, images):
    """The mean host gap between steps less the loop's image saving: the
    loader's wait and the scalar logging."""
    return statistics.mean(g - i for g, i in zip(gaps, images))


def phase_train_cli(run):
    """The training entry point through the data layer: cli.train.main on a
    synthetic DTU training scan of 5 views x 7 lights, CasDiffMVS f32,
    B = 4, 5 views, 512x640, 48/384, 2 loader workers: one epoch (8 steps)
    and its validation, --resume for the second, then --mode test."""
    import json

    from diffmvs_tpu_torch.cli import train as cli_train
    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.train.schedules import make_lr_lambda

    root = REPO / "build" / "chip_smoke_train_cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_dtu_train_tree(root / "dtu", "scan1", 5)
    (root / "list.txt").write_text("scan1\n")
    setup_s = time.perf_counter() - t0
    logdir = root / "log"
    b, epochs, steps_per_epoch = 4, 2, 35 // 4
    base = ["--dataset", "dtu", "--preset", "casdiffmvs", "--trainpath",
            str(root / "dtu"), "--trainlist", str(root / "list.txt"),
            "--testlist", str(root / "list.txt"), "--batch_size", str(b),
            "--trainviews", "5", "--testviews", "5", "--epochs",
            str(epochs), "--summary_freq", "1", "--logdir", str(logdir),
            "--device", "cuda", "--seed", "0"]

    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    res1, steps1, rate1, gaps1, img1 = train_cli_run(
        base + ["--workers", "2", "--train_epochs", "1"], b)
    k1_total = profiling.counter("warp_corr.k1")
    k2_total = profiling.counter("warp_corr.k2")
    peak = torch.cuda.max_memory_allocated()
    check(len(steps1) == steps_per_epoch, f"{len(steps1)} steps in epoch 0")
    # 28 K1 launches per validation batch: 5 test views in batches of 4, 1
    check(k1_total == 28 * steps_per_epoch + 28 * 2 and
          k2_total == 28 * steps_per_epoch,
          f"{k1_total} K1 / {k2_total} K2 launches in the first run")
    check(res1["state"].step == steps_per_epoch, "the step count")
    res2, steps2, rate2, gaps2, img2 = train_cli_run(
        base + ["--workers", "2", "--resume"], b)
    check(res2["state"].step == 2 * steps_per_epoch, "the resumed steps")
    # the validation alone, its two batches loaded in-process
    res3 = cli_train.main(base + ["--workers", "0", "--mode", "test",
                                  "--loadckpt", str(logdir)])

    recs = [json.loads(line) for line in open(logdir / "scalars.jsonl")]
    train_recs = [r for r in recs if r["mode"] == "train"]
    check([r["step"] for r in train_recs]
          == list(range(epochs * steps_per_epoch)),
          f"train steps logged {[r['step'] for r in train_recs]}")
    check(all(math.isfinite(r["loss"]) for r in recs), "finite losses")
    cfg = TrainConfig(model=MODEL_PRESETS["casdiffmvs"], epochs=epochs)
    lr8 = cfg.lr * make_lr_lambda(cfg, steps_per_epoch)(steps_per_epoch)
    first = train_recs[steps_per_epoch]
    check(first["step"] == steps_per_epoch
          and math.isclose(first["lr"], lr8, rel_tol=1e-12),
          f"resumed at step {first['step']} lr {first['lr']}, schedule {lr8}")
    check((logdir / "model_000000.ckpt").exists()
          and (logdir / "model_000001.ckpt").exists(), "both checkpoints")
    check(recs[-1]["mode"] == "eval" and res3["eval"] is not None
          and math.isfinite(res3["eval"]["loss"]), "--mode test")
    run["train_cli_ckpt"] = logdir / "model_000001.ckpt"
    log("train_cli", setup_s=f"{setup_s:.1f}", B=b, views=5, hw="512x640",
        steps=len(steps1) + len(steps2), workers=2,
        samples_per_s=f"{rate1:.3f}", samples_per_s_resumed=f"{rate2:.3f}",
        samples_per_s_train_phase=f"{run['train_f32']['samples_per_s']:.3f}",
        host_gaps_ms=ms_list(gaps1), images_ms=ms_list(img1),
        host_gaps_ms_resumed=ms_list(gaps2), images_ms_resumed=ms_list(img2),
        data_wait_ms=f"{data_wait_ms(gaps1, img1):.1f}",
        data_wait_ms_resumed=f"{data_wait_ms(gaps2, img2):.1f}",
        first_step_s=f"{steps1[0]['end'] - steps1[0]['start']:.2f}",
        peak_mem_gib=f"{peak / 2**30:.3f}", k1_per_step=28, k2_per_step=28,
        losses=repr([round(r["loss"], 4) for r in train_recs]),
        resumed_step=first["step"], resumed_lr=repr(first["lr"]),
        eval_loss=f"{res3['eval']['loss']:.4f}")


def phase_train_cli_blend(run):
    """cli.train on a synthetic BlendedMVS scan at 576x768 (its
    low-resolution image size), B = 2, two steps, starting from the
    train_cli checkpoint through --loadckpt's strict .ckpt path; loading
    in-process (two steps: spawning workers would take longer than the
    steps). Two steps give one interval, so no rate: the steps' times and
    the gap between them."""
    from diffmvs_tpu_torch.ops import warp_corr

    root = REPO / "build" / "chip_smoke_train_cli_blend"
    shutil.rmtree(root, ignore_errors=True)
    make_blend_scan(root / "blend", "5c1f33f1d33e1f2e4aa6dda4", 5, 576, 768)
    (root / "list.txt").write_text("5c1f33f1d33e1f2e4aa6dda4\n")
    b = 2
    argv = ["--dataset", "blend", "--preset", "casdiffmvs", "--trainpath",
            str(root / "blend"), "--trainlist", str(root / "list.txt"),
            "--testlist", str(root / "list.txt"), "--batch_size", str(b),
            "--trainviews", "5", "--testviews", "5", "--workers", "0",
            "--epochs", "1", "--summary_freq", "1", "--logdir",
            str(root / "log"), "--device", "cuda", "--loadckpt",
            str(run["train_cli_ckpt"])]
    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    res, steps, _, gaps, images = train_cli_run(argv, b)
    check(len(steps) == 2 and res["state"].step == 2, f"{len(steps)} steps")
    check((root / "log" / "model_000000.ckpt").exists(), "checkpoint")
    log("train_cli_blend", B=b, views=5, hw="576x768", steps=len(steps),
        workers=0,
        loadckpt=run["train_cli_ckpt"].name,
        step_ms=ms_list(1e3 * (st["end"] - st["start"]) for st in steps),
        host_gaps_ms=ms_list(gaps), images_ms=ms_list(images),
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        k1_per_step=28, k2_per_step=28)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_ddp(run):
    """The data-parallel step (SyncBatchNorm, DDP, the global batch's
    noise) in an NCCL group of one on 127.0.0.1, against the plain step:
    two steps of the training cell from the same weights, batches and
    generator seed. Gates: loss rel < 1e-5 and gradient cosine > 0.9999 at
    both steps; BatchNorm running statistics within 1e-5 (relative to 1 +
    |stat|) after each step (cuDNN's float32 statistics against
    SyncBatchNorm's float64 sums)."""
    import torch.distributed as dist

    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.parallel.distributed import (DataParallel,
                                                        SyncBatchNorm)
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    b, views, hh, ww = 4, 5, 512, 640
    cfg = TrainConfig(model=MODEL_PRESETS["casdiffmvs"], batch_size=b)
    batches = [synthetic_train_batch(b, views, hh, ww, 384, seed=i)
               for i in range(2)]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        res = {}
        for mode in ("plain", "ddp"):
            state = create_train_state(cfg, steps_per_epoch=10,
                                       device="cuda", seed=0)
            dp = DataParallel(state.model) if mode == "ddp" else None
            if dp is not None:
                check(sum(isinstance(m, SyncBatchNorm)
                          for m in state.model.modules()) > 0, "SyncBN")
            gen = torch.Generator(device="cuda").manual_seed(5)
            out = []
            for batch in batches:
                warp_corr.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scalars, _ = train_step(state, cfg, batch, gen, dp=dp)
                torch.cuda.synchronize()
                out.append(dict(
                    ms=(time.perf_counter() - t0) * 1e3,
                    loss=float(scalars["loss"]),
                    grads=flat_grads(state.model),
                    launches=(profiling.counter("warp_corr.k1"),
                              profiling.counter("warp_corr.k2")),
                    stats=torch.cat([v.float().flatten() for k, v in
                                     state.model.state_dict().items()
                                     if "running_" in k])))
            res[mode] = out
    finally:
        dist.destroy_process_group()
    plain, ddp = res["plain"], res["ddp"]
    rels, coss, stat_errs = [], [], []
    for i, (p, d) in enumerate(zip(plain, ddp)):
        check(p["launches"] == d["launches"] == (28, 28),
              f"step {i}: launches {p['launches']} / {d['launches']}")
        rels.append(abs(d["loss"] - p["loss"]) / abs(p["loss"]))
        coss.append(cosine(d["grads"], p["grads"]))
        stat_errs.append(((d["stats"] - p["stats"]).abs()
                          / (1.0 + p["stats"].abs())).max().item())
    log("ddp", world_size=1, backend="nccl", B=b, hw=f"{hh}x{ww}", steps=2,
        loss_rel=repr([float(f"{r:.3e}") for r in rels]),
        grad_cosine=repr([round(c, 9) for c in coss]),
        bn_stats_max_err=repr([float(f"{e:.3e}") for e in stat_errs]),
        step_ms_plain=repr([round(p["ms"], 1) for p in plain]),
        step_ms_ddp=repr([round(d["ms"], 1) for d in ddp]),
        gates="loss_rel<1e-5,cosine>0.9999,bn_stats<1e-5")
    check(max(rels) < 1e-5, f"ddp loss rel {rels}")
    check(min(coss) > 0.9999, f"ddp gradient cosine {coss}")
    check(max(stat_errs) < 1e-5,
          f"ddp BatchNorm statistics {stat_errs}")


SP_TIMEOUT_S = 600


def sp_collectives(space, dev):
    """The collectives width sharding uses, on CUDA tensors in the gloo
    group: all_gather of float32, bfloat16 and int64, all_reduce of
    float32 and float64. Returns their names; raises on a wrong value."""
    from diffmvs_tpu_torch.parallel import spatial

    r = space.rank
    done = []
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        parts = spatial.all_gather(torch.full((3, 5), r + 1, dtype=dt,
                                              device=dev), space)
        check(all(bool((p == i + 1).all()) and p.is_cuda
                  for i, p in enumerate(parts)), f"all_gather {dt}")
        done.append(f"all_gather:{str(dt)[6:]}")
    for dt in (torch.float32, torch.float64):
        t = spatial.all_reduce(torch.full((7,), r + 1.0, dtype=dt,
                                          device=dev), space)
        check(bool((t == 3.0).all()) and t.is_cuda, f"all_reduce {dt}")
        done.append(f"all_reduce:{str(dt)[6:]}")
    return done


def sp_serve(space, dtype, gate, lead):
    """The sharded export forward at the main-path configuration (DTU
    size, 5 views, 48/384, B = 1) against the unsharded one on lead."""
    import torch.distributed as dist

    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.parallel import spatial
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    hh, ww, views = 1152, 1600, 5
    imgs, projs, dv = synthetic_inputs(1, views, hh, ww, 384, seed=0)
    kw = dict(device="cuda", seed=0, numdepth_initial=48, numdepth=384,
              compute_dtype=dtype)
    runner = DepthRunner.from_random("casdiffmvs", **kw)
    spatial.shard_width(runner.model, space)
    local = spatial.column_slice({"imgs": imgs}, space.rank,
                                 space.size)["imgs"]
    torch.cuda.reset_peak_memory_stats()
    warp_corr.reset_counts()
    # the collectives of the sharded requests, counted
    calls = {"all_gather": 0, "all_reduce": 0}
    real = {k: getattr(spatial, k) for k in calls}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return real[name](*args)
        return fn

    req_ms = []
    try:
        for k in calls:
            setattr(spatial, k, counted(k))
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth, confs = runner(local, projs, dv)
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        for k, fn in real.items():
            setattr(spatial, k, fn)
    out = dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ms=statistics.mean(req_ms[1:]), req_ms=req_ms,
               collectives={k: v // 3 for k, v in calls.items()},
               k1=profiling.counter("warp_corr.k1"),
               k1_by_shape={str(k): v for k, v in
                            profiling.keyed("warp_corr.k1").items()})
    k1 = profiling.counter("warp_corr.k1")
    check(k1 == 28 * 3, f"{k1} K1 launches in 3 sharded requests")
    check(depth.shape == (1, hh, ww // 2), f"shard depth {depth.shape}")
    shard = space.shard(local.shape[3], depth.device)
    with torch.inference_mode():
        depth = shard.gather(depth, -1)
        confs = [shard.gather(c, -1) for c in confs]
    del runner
    if lead:
        full = DepthRunner.from_random("casdiffmvs", **kw)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, want_confs = full(imgs, projs, dv)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        out.update(plain_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   plain_ms=statistics.mean(plain_ms[1:]))
        rel = ((depth - want).abs() / want.abs().clamp_min(1e-12))
        conf_err = max((c - w).abs().max().item()
                       for c, w in zip(confs, want_confs))
        out.update(depth_mean_rel=rel.mean().item(),
                   depth_max_rel=rel.max().item(), conf_max_abs=conf_err)
        check(bool(torch.isfinite(depth).all()), "finite sharded depth")
        check(rel.mean().item() < gate, f"sp {dtype} depth mean rel "
              f"{rel.mean().item()}")
        if dtype == "float32":
            check(conf_err < 1e-3, f"sp confidence max abs {conf_err}")
        del full
    dist.barrier()
    return out


def sp_train(space, lead):
    """Two training-cell steps on dp = 1 x sp = 2 (DataParallel over the
    gloo world) against the plain step on lead."""
    import torch.distributed as dist

    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.parallel import spatial
    from diffmvs_tpu_torch.parallel.distributed import DataParallel
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    b, views, hh, ww = 4, 5, 512, 640
    cfg = TrainConfig(model=MODEL_PRESETS["casdiffmvs"], batch_size=b)
    batches = [synthetic_train_batch(b, views, hh, ww, 384, seed=i)
               for i in range(2)]

    def steps(dp):
        state = create_train_state(cfg, steps_per_epoch=10, device="cuda",
                                   seed=0)
        if dp is not None:
            dp = dp(state.model)
        gen = torch.Generator(device="cuda").manual_seed(5)
        torch.cuda.reset_peak_memory_stats()
        res = []
        for batch in batches:
            if dp is not None:
                batch = spatial.column_slice(batch, space.rank, space.size)
            warp_corr.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scalars, _ = train_step(state, cfg, batch, gen, dp=dp)
            torch.cuda.synchronize()
            res.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                loss=float(scalars["loss"]), grads=flat_grads(state.model),
                launches=(profiling.counter("warp_corr.k1"),
                          profiling.counter("warp_corr.k2")),
                k2_by_shape={str(k): v for k, v in
                             profiling.keyed("warp_corr.k2").items()},
                stats=torch.cat([v.float().flatten() for k, v in
                                 state.model.state_dict().items()
                                 if "running_" in k])))
        return res, torch.cuda.max_memory_allocated() / 2**30

    sharded, peak = steps(lambda m: DataParallel(m, space))
    for i, st in enumerate(sharded):
        check(st["launches"] == (28, 28), f"sp step {i}: K1 / K2 launches "
              f"{st['launches']} a rank")
        check(math.isfinite(st["loss"]), f"sp step {i} loss {st['loss']}")
    out = dict(peak_gib=peak, step_ms=[st["ms"] for st in sharded],
               launches=[st["launches"] for st in sharded],
               k2_by_shape=sharded[0]["k2_by_shape"],
               losses=[st["loss"] for st in sharded])
    if lead:
        plain, plain_peak = steps(None)
        rels, coss, stat_errs = [], [], []
        for p, d in zip(plain, sharded):
            rels.append(abs(d["loss"] - p["loss"]) / abs(p["loss"]))
            coss.append(cosine(d["grads"], p["grads"]))
            stat_errs.append(((d["stats"] - p["stats"]).abs()
                              / (1.0 + p["stats"].abs())).max().item())
        out.update(plain_peak_gib=plain_peak,
                   plain_step_ms=[p["ms"] for p in plain], loss_rel=rels,
                   grad_cosine=coss, bn_stats_max_err=stat_errs)
        check(max(rels) < 1e-4, f"sp loss rel {rels}")
        check(min(coss) > 0.9999, f"sp gradient cosine {coss}")
        check(max(stat_errs) < 1e-5, f"sp BatchNorm statistics {stat_errs}")
    dist.barrier()
    return out


def sp_rank(rank, port, outdir):
    """One rank of the sp phase: two gloo ranks on the one card."""
    import torch.distributed as dist

    from diffmvs_tpu_torch.api import set_f32_precision
    from diffmvs_tpu_torch.ops import native
    from diffmvs_tpu_torch.parallel.distributed import space_group

    torch.cuda.set_device(0)
    set_f32_precision()
    native.build()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        space = space_group(2)
        lead = rank == 0
        res = {"collectives": sp_collectives(space, torch.device("cuda")),
               "f32": sp_serve(space, "float32", 1e-4, lead),
               "bf16": sp_serve(space, "bfloat16", 5e-2, lead),
               "train": sp_train(space, lead),
               "modules": jax_modules()}
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def spawn_card_ranks(target, name, timeout_s):
    """target(rank, port, outdir) in two spawned processes on the one card
    (a gloo group: NCCL takes one rank per card), joined with a timeout
    and killed on it. Returns each rank's rank{r}.json from outdir
    (build/chip_smoke_<name>), after checking that no rank imported
    JAX."""
    import multiprocessing as mp

    outdir = REPO / "build" / f"chip_smoke_{name}"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, port, str(outdir)))
             for r in range(2)]
    t0 = time.time()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(1.0, timeout_s - (time.time() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    check(not hung, f"a {name} rank did not finish in {timeout_s} s")
    check([p.exitcode for p in procs] == [0, 0],
          f"{name} ranks exited {[p.exitcode for p in procs]}")
    ranks = [json.loads((outdir / f"rank{r}.json").read_text())
             for r in range(2)]
    check(all(r["modules"] == [] for r in ranks),
          f"{name} ranks imported JAX")
    return ranks


def jax_modules():
    return sorted(m for m in sys.modules if m.split(".")[0]
                  in ("jax", "jaxlib", "flax", "diffmvs_tpu"))


def phase_sp(run):
    """Width sharding (sp = 2) in two gloo ranks on the one card, spawned
    with a timeout and killed on it: the sharded export forward at the
    main-path configuration in f32 and bf16 against the unsharded one, and
    two training-cell steps (dp = 1 x sp = 2) against the plain step, with
    each rank's peak memory and times beside the unsharded figures."""
    ranks = spawn_card_ranks(sp_rank, "sp", SP_TIMEOUT_S)
    lead = ranks[0]
    for tag in ("f32", "bf16"):
        f = lead[tag]
        log("sp", part="export", dtype=tag, S=2, hw="1152x1600",
            shard_w=800, collectives=",".join(lead["collectives"]),
            depth_mean_rel=f"{f['depth_mean_rel']:.3e}",
            depth_max_rel=f"{f['depth_max_rel']:.3e}",
            conf_max_abs=f"{f['conf_max_abs']:.3e}",
            peak_gib_per_rank=repr([round(r[tag]["peak_gib"], 3)
                                    for r in ranks]),
            peak_gib_unsharded=f"{f['plain_peak_gib']:.3f}",
            ms_per_rank=repr([round(r[tag]["ms"], 1) for r in ranks]),
            ms_unsharded=f"{f['plain_ms']:.1f}",
            k1_per_request=f["k1"] // 3,
            collectives_per_request=",".join(
                f"{k}:{v}" for k, v in f["collectives"].items()),
            gates=("depth_mean_rel<1e-4,conf_max_abs<1e-3" if tag == "f32"
                   else "depth_mean_rel<5e-2"))
    t = lead["train"]
    log("sp", part="train", dtype="f32", dp=1, S=2, B=4, hw="512x640",
        steps=2, loss_rel=repr([float(f"{r:.3e}") for r in t["loss_rel"]]),
        grad_cosine=repr([round(c, 9) for c in t["grad_cosine"]]),
        bn_stats_max_err=repr([float(f"{e:.3e}")
                               for e in t["bn_stats_max_err"]]),
        k1_k2_per_step_per_rank=repr([r["train"]["launches"]
                                      for r in ranks]),
        peak_gib_per_rank=repr([round(r["train"]["peak_gib"], 3)
                                for r in ranks]),
        peak_gib_unsharded=f"{t['plain_peak_gib']:.3f}",
        step_ms_per_rank=repr([[round(m, 1) for m in r["train"]["step_ms"]]
                               for r in ranks]),
        step_ms_unsharded=repr([round(m, 1) for m in t["plain_step_ms"]]),
        gates="loss_rel<1e-4,cosine>0.9999,bn_stats<1e-5")
    run["sp_k1"] = {tag: {tuple(int(x) for x in k.strip("()").split(",")):
                          v for k, v in lead[tag]["k1_by_shape"].items()}
                    for tag in ("f32", "bf16")}
    run["sp_k2"] = {tuple(int(x) for x in k.strip("()").split(",")): v
                    for k, v in t["k2_by_shape"].items()}


DP_SHARD_TIMEOUT_S = 420
# the first AdamW update moves each parameter by at most the schedule's
# first rate (onecycle: 1e-3 / 25) times (1 + weight decay x |p|); a
# gradient near zero whose sign the kernels' float32 sums flip moves its
# parameter by twice that, 8e-5, which bounds the parameters' error
DP_SHARD_GATES = dict(loss_rel=1e-5, grad_cosine=0.9999, params=1e-4,
                      stats=1e-5)


def dp_shard_case():
    """(TrainConfig, global batch) of the dp_shard phase: the training
    cell (CasDiffMVS f32, B = 4, 5 views, 512x640, 48/384) with masks
    that keep a different share of each row, so each rank's mask counts
    differ."""
    import numpy as np

    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    b, views, hh, ww = 4, 5, 512, 640
    cfg = TrainConfig(model=MODEL_PRESETS["casdiffmvs"], batch_size=b)
    batch = synthetic_train_batch(b, views, hh, ww, 384, seed=0)
    rng = np.random.RandomState(1)
    keep = (0.5 + 0.5 * np.arange(b) / b).reshape(b, 1, 1)
    for s, m in batch["mask"].items():
        batch["mask"][s] = (rng.rand(*m.shape) < keep).astype(np.float32)
    return cfg, batch


def flat_stats(model):
    return torch.cat([v.double().flatten() for k, v in
                      model.state_dict().items() if "running_" in k])


def flat_params(model):
    return torch.cat([p.detach().double().flatten()
                      for p in model.parameters()])


def dp_shard_rank(rank, port, outdir):
    """One rank of the dp_shard phase: one "shard"-mode step (per-rank
    nn.BatchNorm, this rank's generator, its rows' mask counts) of the
    training cell with K1 and K2; rank 0 then runs the plain per-shard
    computation and holds the step against it."""
    import torch.distributed as dist

    from diffmvs_tpu_torch.api import set_f32_precision
    from diffmvs_tpu_torch.ops import native, warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.parallel.distributed import (DataParallel,
                                                        SyncBatchNorm,
                                                        fold_seed)
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import (_split, batch_to_device,
                                              compute_gradients, train_step)

    torch.cuda.set_device(0)
    set_f32_precision()
    native.build()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        cfg, batch = dp_shard_case()
        state = create_train_state(cfg, steps_per_epoch=10, device="cuda",
                                   seed=0)
        dp = DataParallel(state.model, mode="shard")
        check(dp.mode == "shard" and not any(
            isinstance(m, SyncBatchNorm) for m in state.model.modules()),
            "shard mode keeps nn.BatchNorm")
        gen = dp.generator(5, "cuda")
        check(gen.initial_seed() == fold_seed(5, rank), "the rank's seed")
        local = _split(batch, 2, rank)
        # a warm-up step from a throwaway state (cuDNN's first calls, the
        # allocator), neither timed nor compared
        warm = create_train_state(cfg, steps_per_epoch=10, device="cuda",
                                  seed=0)
        wdp = DataParallel(warm.model, mode="shard")
        train_step(warm, cfg, local, wdp.generator(5, "cuda"), dp=wdp)
        del warm, wdp
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        warp_corr.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars, _ = train_step(state, cfg, local, gen, dp=dp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = (profiling.counter("warp_corr.k1"),
                    profiling.counter("warp_corr.k2"))
        res = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated()
               / 2**30, "launches": launches, "loss": float(scalars["loss"]),
               "modules": jax_modules()}
        params, stats = flat_params(state.model), flat_stats(state.model)
        grads = flat_grads(state.model)
        res["params_sum"] = float(params.sum())
        check(math.isfinite(res["loss"]), f"dp_shard loss {res['loss']}")
        if rank == 0:
            # the plain per-shard computation: each shard's rows in one
            # process with that rank's generator and the plain warp; the
            # gradients and statistics averaged; one AdamW step
            del state, dp
            shard_grads, shard_stats, losses, plain_ms = [], [], [], []
            for r in range(2):
                ref = create_train_state(cfg, steps_per_epoch=10,
                                         device="cuda", seed=0,
                                         warp=warp_and_correlate_plain)
                warp_corr.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _, _, _ = compute_gradients(
                    ref.model, cfg, batch_to_device(_split(batch, 2, r),
                                                    "cuda"),
                    torch.Generator(device="cuda").manual_seed(
                        fold_seed(5, r)))
                torch.cuda.synchronize()
                plain_ms.append((time.perf_counter() - t0) * 1e3)
                check(profiling.counter("warp_corr.k1")
                      == profiling.counter("warp_corr.k2") == 0,
                      "no kernel on the plain per-shard path")
                shard_grads.append([p.grad.clone()
                                    for p in ref.model.parameters()])
                shard_stats.append({k: v.clone() for k, v in
                                    ref.model.state_dict().items()
                                    if "running_" in k})
                losses.append(float(loss))
                del ref
            ref = create_train_state(cfg, steps_per_epoch=10, device="cuda",
                                     seed=0, warp=warp_and_correlate_plain)
            with torch.no_grad():
                for i, p in enumerate(ref.model.parameters()):
                    p.grad = (shard_grads[0][i] + shard_grads[1][i]) / 2
                sd = ref.model.state_dict()
                for k in shard_stats[0]:
                    sd[k].copy_((shard_stats[0][k] + shard_stats[1][k]) / 2)
            ref_grads = flat_grads(ref.model)
            ref.apply_gradients(cfg.grad_clip)
            want_p, want_s = flat_params(ref.model), flat_stats(ref.model)
            want_loss = sum(losses) / 2
            p_err = (params - want_p).abs() / (1.0 + want_p.abs())
            res.update(
                params_over_1e6=int((p_err > 1e-6).sum()),
                params_count=p_err.numel(),
                plain_ms=plain_ms,
                loss_rel=abs(res["loss"] - want_loss) / abs(want_loss),
                grad_cosine=cosine(grads, ref_grads),
                params_max_rel=p_err.max().item(),
                stats_max_rel=((stats - want_s).abs()
                               / (1.0 + want_s.abs())).max().item())
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def phase_dp_shard(run):
    """The data-parallel step in mode "shard" (the JAX package's
    shard_map step: per-rank BatchNorm statistics averaged after the step,
    per-rank noise from a generator folded with the rank, per-rank mask
    counts) in two gloo ranks on the one card, one training-cell step of
    B = 2 a rank with K1 and K2 (after a warm-up step from a throwaway
    state), against the plain per-shard computation
    (each shard's rows in one process with that rank's generator and the
    plain warp, gradients and statistics averaged, one AdamW step): the
    relative errors of the loss, the parameters and the statistics (the
    latter two relative to 1 + |value|), the gradient cosine; each rank's
    ms and peak memory (gloo's, not a deployment's)."""
    ranks = spawn_card_ranks(dp_shard_rank, "dp_shard", DP_SHARD_TIMEOUT_S)
    lead = ranks[0]
    for r in ranks:
        check(tuple(r["launches"]) == (28, 28), f"dp_shard K1 / K2 "
              f"launches {r['launches']} a rank")
    check(ranks[0]["params_sum"] == ranks[1]["params_sum"],
          "the ranks' parameters after the step")
    g = DP_SHARD_GATES
    log("dp_shard", dp=2, mode="shard", backend="gloo", B=4, B_rank=2,
        views=5, hw="512x640", dtype="f32",
        loss_rel=f"{lead['loss_rel']:.3e}",
        grad_cosine=f"{lead['grad_cosine']:.9f}",
        params_max_rel=f"{lead['params_max_rel']:.3e}",
        params_over_1e6=f"{lead['params_over_1e6']}/{lead['params_count']}",
        stats_max_rel=f"{lead['stats_max_rel']:.3e}",
        k1_k2_per_rank=repr([tuple(r["launches"]) for r in ranks]),
        step_ms_per_rank=repr([round(r["ms"], 1) for r in ranks]),
        peak_gib_per_rank=repr([round(r["peak_gib"], 3) for r in ranks]),
        plain_shard_ms=repr([round(m, 1) for m in lead["plain_ms"]]),
        gates=",".join(f"{k}{'>' if k == 'grad_cosine' else '<'}{v}"
                       for k, v in g.items()))
    check(lead["loss_rel"] < g["loss_rel"], f"dp_shard loss rel "
          f"{lead['loss_rel']}")
    check(lead["grad_cosine"] > g["grad_cosine"], f"dp_shard gradient "
          f"cosine {lead['grad_cosine']}")
    check(lead["params_max_rel"] < g["params"], f"dp_shard parameters "
          f"{lead['params_max_rel']}")
    check(lead["stats_max_rel"] < g["stats"], f"dp_shard statistics "
          f"{lead['stats_max_rel']}")


def toy_net():
    """The torch module whose weights tests/data/orbax_state/model_000001
    holds (tests/test_torch_orbax.py's ToyNet), and its block map."""
    net = torch.nn.Module()
    net.conv = torch.nn.Conv2d(3, 8, 3)
    net.bn = torch.nn.BatchNorm2d(8)
    net.head = torch.nn.Conv3d(8, 2, 3)
    net.dense = torch.nn.Linear(8, 4)

    def emit(e):
        e.conv2d("conv", "conv")
        e.bn("bn", "bn")
        e.conv3d("head", "head")
        e.linear("dense", "dense")
    return net, emit


def flatten_tree(tree, prefix=""):
    """{path: leaf} of a checkpoint's tree; None / {} / [] leaves kept (as
    tests/test_torch_orbax.py's flatten)."""
    if isinstance(tree, dict) and tree:
        items = tree.items()
    elif isinstance(tree, list) and tree:
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def phase_jax_ckpt(run):
    """The JAX package's orbax checkpoints on this machine, which has
    neither JAX nor tensorstore: tests/data/orbax_state/ (a toy train
    state saved by the JAX package's save_checkpoint, and arrays orbax
    split into several zarr chunks) through train/orbax_read.py and the
    system's libzstd.so.1, every leaf bit-equal to its expected.npz; the
    toy state's optax state into torch's AdamW on the card through
    tools/jax_import.optimizer_state_from_jax; the read's host ms."""
    import numpy as np

    from diffmvs_tpu_torch.tools.jax_import import (optimizer_state_from_jax,
                                                    state_dict_from_jax)
    from diffmvs_tpu_torch.train import orbax_read

    root = REPO / "tests" / "data" / "orbax_state"
    want = np.load(root / "expected.npz")
    trees, read_ms = {}, {}
    for name in ("model_000001", "chunked"):
        t0 = time.perf_counter()
        trees[name] = orbax_read.read_orbax(str(root / name))
        read_ms[name] = (time.perf_counter() - t0) * 1e3
    got, empty = {}, []
    for name, tree in trees.items():
        for path, leaf in flatten_tree(tree).items():
            if leaf is None or (isinstance(leaf, (dict, list)) and not leaf):
                empty.append(f"{name}:{path}={type(leaf).__name__}")
            else:
                got[f"{name}:{path}"] = np.asarray(leaf)
    keys = sorted(k for k in want.files if k != "__empty__")
    check(sorted(got) == keys, f"jax_ckpt leaves {sorted(got)} vs {keys}")
    for k in keys:
        check(got[k].dtype == want[k].dtype and got[k].shape ==
              want[k].shape and got[k].tobytes() == want[k].tobytes(),
              f"jax_ckpt leaf {k} differs from expected.npz")
    check(sorted(empty) == list(want["__empty__"]), f"jax_ckpt empty nodes "
          f"{sorted(empty)}")
    state = trees["model_000001"]["state"]
    net, emit = toy_net()
    net.load_state_dict(state_dict_from_jax(
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        None, emit=emit))
    net.to("cuda")
    opt = torch.optim.AdamW(net.parameters())
    position = optimizer_state_from_jax(state["opt_state"], None, net, opt,
                                        emit=emit)
    mu = state["opt_state"][1][0]["mu"]
    adam = opt.state[net.conv.weight]
    check(position == 2 and int(adam["step"]) == 2 and adam["exp_avg"]
          .is_cuda and torch.equal(adam["exp_avg"].cpu(), torch.from_numpy(
              np.transpose(mu["conv"]["kernel"], (3, 2, 0, 1)).copy())),
          "jax_ckpt AdamW state")
    log("jax_ckpt", leaves=len(keys), empty_nodes=len(empty),
        bit_equal=True, libzstd=orbax_read.LIBZSTD,
        read_ms=repr({k: round(v, 3) for k, v in read_ms.items()}),
        adamw_step=int(adam["step"]), schedule_position=position)


def make_sparse_model(root, n_images, hh, ww, n_points, seed=0):
    """A COLMAP text sparse model: one PINHOLE camera, n_images views on a
    full circle 650 mm around n_points points in a 200 mm cube (every
    point seen by every view), and the views as JPEGs of random blocks."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "sparse").mkdir(parents=True)
    (root / "images").mkdir()
    f, cx, cy = 1.2 * ww, ww / 2, hh / 2
    (root / "sparse" / "cameras.txt").write_text(
        f"# cameras\n1 PINHOLE {ww} {hh} {f} {f} {cx} {cy}\n")
    pts = rng.uniform(-100.0, 100.0, (n_points, 3))
    with open(root / "sparse" / "images.txt", "w") as fh:
        fh.write("# images\n")
        for i in range(n_images):
            th = 2 * np.pi * i / n_images
            # world-to-camera rotation about y by th, its optical axis
            # towards the origin: qvec (w, x, y, z)
            r = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]])
            center = np.array([650.0 * np.sin(th), 0.0, -650.0 * np.cos(th)])
            t = -r @ center
            fh.write(f"{i + 1} {np.cos(th / 2)} 0 {np.sin(th / 2)} 0 "
                     f"{t[0]} {t[1]} {t[2]} 1 view{i:03d}.jpg\n")
            cam = pts @ r.T + t
            uv = cam[:, :2] / cam[:, 2:] * f + [cx, cy]
            fh.write(" ".join(f"{u:.2f} {v:.2f} {p + 1}"
                              for p, (u, v) in enumerate(uv)) + "\n")
            Image.fromarray(blocky_image(rng, hh, ww)).save(
                root / "images" / f"view{i:03d}.jpg", quality=90)
    with open(root / "sparse" / "points3D.txt", "w") as fh:
        fh.write("# points\n")
        for p in range(n_points):
            track = " ".join(f"{i + 1} {p}" for i in range(n_images))
            fh.write(f"{p + 1} {pts[p, 0]:.4f} {pts[p, 1]:.4f} "
                     f"{pts[p, 2]:.4f} 128 128 128 0.5 {track}\n")


def read_pairs(path):
    with open(path) as f:
        n = int(f.readline())
        out = {}
        for _ in range(n):
            ref = int(f.readline())
            toks = f.readline().split()
            out[ref] = [(int(toks[1 + 2 * i]), float(toks[2 + 2 * i]))
                        for i in range(int(toks[0]))]
    return out


def phase_colmap(run):
    """tools.colmap.convert(..., vggt=True) on a synthetic sparse model of
    49 images at 480x640: the DeiT-S retrieval ViT at its published width
    (224^2, embed 384, 12 blocks, 6 heads, random weights from seed 0) on
    the card. Gates: the descriptors against the ViT on the CPU, max abs <
    1e-4 (TF32 off); cams/ and pair.txt byte-equal to a CPU conversion's."""
    import numpy as np

    from diffmvs_tpu_torch.tools import colmap
    from diffmvs_tpu_torch.tools.retrieval import (DistilledViT, ViTConfig,
                                                   compute_descriptors)

    n_images, hh, ww = 49, 480, 640
    root = REPO / "build" / "chip_smoke_colmap"
    shutil.rmtree(root, ignore_errors=True)
    make_sparse_model(root / "scene", n_images, hh, ww, 200)
    _, images, _ = colmap.read_model(str(root / "scene" / "sparse"), ".txt")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    colmap.convert(str(root / "scene"), str(root / "cuda"), ".txt",
                   vggt=True, device="cuda")
    convert_s = time.perf_counter() - t0
    desc = {}
    for device in ("cuda", "cpu"):
        d = colmap.compute_image_descriptors(str(root / "scene"), images,
                                             device=device)
        desc[device] = np.stack([d[k] for k in sorted(d)])
    err = float(np.abs(desc["cuda"] - desc["cpu"]).max())
    colmap.convert(str(root / "scene"), str(root / "cpu"), ".txt",
                   descriptors=dict(zip(sorted(images), desc["cpu"])))

    # the ViT alone on the card, its inputs on the host
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vit = DistilledViT(ViTConfig()).cuda().eval()
    x = np.random.RandomState(1).randn(n_images, 224, 224, 3).astype(
        np.float32)
    compute_descriptors(vit, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_descriptors(vit, x)
    vit_s = time.perf_counter() - t0

    got, want = (read_pairs(root / d / "pair.txt") for d in ("cuda", "cpu"))
    check(sorted(got) == sorted(want) == list(range(n_images)),
          "pair.txt views")
    order_ok = all([j for j, _ in got[r]] == [j for j, _ in want[r]]
                   for r in want)
    score_err = max(abs(a[1] - b[1]) for r in want
                    for a, b in zip(got[r], want[r]))
    lines = [(root / d / "pair.txt").read_text().splitlines()
             for d in ("cuda", "cpu")]
    differ = sum(a != b for a, b in zip(*lines))
    cams = {d: {p.name: p.read_bytes() for p in (root / d / "cams").iterdir()}
            for d in ("cuda", "cpu")}
    log("colmap", images=n_images, hw=f"{hh}x{ww}", vit="DeiT-S 224 384x12",
        convert_s=f"{convert_s:.2f}",
        images_per_s=f"{n_images / convert_s:.2f}",
        vit_images_per_s=f"{n_images / vit_s:.1f}",
        desc_max_abs_cuda_vs_cpu=f"{err:.3e}", pair_order_equal=order_ok,
        pair_score_max_diff=f"{score_err:.1e}", pair_lines_differ=differ,
        cams_equal=cams["cuda"] == cams["cpu"],
        gates="desc<1e-4,pair_equal,cams_equal")
    check(err < 1e-4, f"descriptors CUDA vs CPU {err}")
    check(order_ok and differ == 0 and len(lines[0]) == len(lines[1]),
          f"pair.txt CUDA vs CPU: {differ} lines differ")
    check(cams["cuda"] == cams["cpu"] and len(cams["cpu"]) == n_images,
          "cams/ CUDA vs CPU")


BENCH_TIMEOUT_S = 600


def phase_bench(run):
    """`python -m diffmvs_tpu_torch.bench --all` in a subprocess: its four
    JSON lines (parity, inference, training, loader), each logged, then
    held to the gates and launch counts."""
    torch.cuda.empty_cache()     # the bench process takes B = 16's memory
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "diffmvs_tpu_torch.bench", "--all"],
        cwd=str(REPO), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    for line in proc.stderr.strip().splitlines()[-20:]:
        log("bench", stderr=repr(line))
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith("{")]
    for line in lines:
        log("bench", line=json.dumps(line))
    check(proc.returncode == 0, f"bench --all exited {proc.returncode}")
    check([l["metric"] for l in lines] == [
        "cuda_vs_plain_parity_max_rel_err",
        "casdiffmvs_dtu1600x1152_n5_inference_throughput",
        "casdiffmvs_train_dtu640x512_n5_throughput",
        "host_input_pipeline_dtu_workers4"], "the four lines of --all")
    parity, infer, train, io = lines
    check(parity["pass"] is True and parity["value"] <= 1e-4
          and parity["bwd_value"] <= 1e-4,
          f"parity fwd {parity['value']} bwd {parity['bwd_value']}")
    check(infer["batch"] == 16 and infer["reps"] == 6
          and infer["k1_launches_per_forward"] == 28,
          f"inference B {infer['batch']}, "
          f"{infer['k1_launches_per_forward']} K1 a forward")
    check(train["k1_launches_per_step"] == 52
          and train["k2_launches_per_step"] == 28,
          f"{train['k1_launches_per_step']} K1 + "
          f"{train['k2_launches_per_step']} K2 a training step")
    for line in (infer, train, io):
        check(line["vs_baseline"] is None, f"{line['metric']} vs_baseline")
        figures = [line["value"]] + [line[k] for k in (
            "card_s_per_forward", "card_s_per_step", "host_s_per_forward",
            "host_s_per_step", "sec_per_step", "peak_gib") if k in line]
        check(all(math.isfinite(v) and v > 0 for v in figures),
              f"{line['metric']}: {figures}")
    log("bench", seconds=f"{time.time() - t0:.1f}",
        maps_per_s=f"{infer['value']:.3f}", spread=infer["spread"],
        samples_per_s=f"{train['value']:.3f}",
        view_sets_per_s=f"{io['value']:.3f}")


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

    from diffmvs_tpu_torch.ops import native

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    libs = native.build()
    for name, lib in libs.items():
        ptxas = [l.strip() for l in (lib.parent / f"{name}.log").read_text()
                 .splitlines() if "registers" in l or "spill" in l]
        log("build", lib=lib.name, ptxas=repr(" | ".join(ptxas)))
    log("build", seconds=f"{time.time() - t0:.1f}")

    dev = torch.device("cuda")
    run = {"dev": dev, "gen": torch.Generator(device=dev).manual_seed(0),
           "k1_rows": {}, "k2_rows": {}, "k1_rows_bf16": {},
           "k2_rows_bf16": {}, "k1_rows_sp": {}, "k1_rows_sp_bf16": {},
           "k2_rows_sp": {}, "k2_rows_sp_bf16": {}, "k3_rows": [],
           "operand_rows": []}
    for phase in (phase_jax_ckpt, phase_kernel, phase_pvw_kernel,
                  phase_stem_kernel, phase_cost_prob_kernel,
                  phase_train_kernel,
                  phase_small, phase_main,
                  phase_main_bf16, phase_main_b16, phase_train_small,
                  phase_train, phase_train_bf16, phase_k3_kernel, phase_export,
                  phase_train_cli, phase_train_cli_blend, phase_ddp,
                  phase_sp, phase_dp_shard, phase_colmap, phase_bench):
        phase(run)

    kernels = []
    for rows, counts, src, replaces, tag in (
            (run["k1_rows"], run["k1_launches"], "warp_corr.cu",
             "warp_corr.py:210", "warp_corr"),
            (run["k1_rows_bf16"], run["k1_launches_bf16"], "warp_corr.cu",
             "warp_corr.py:210", "warp_corr"),
            (run["k2_rows"], run["k2_launches"], "warp_corr_bwd.cu",
             "warp_corr_bwd.py:61", "warp_corr_bwd"),
            (run["k2_rows_bf16"], run["k2_launches_bf16"],
             "warp_corr_bwd.cu", "warp_corr_bwd.py:61", "warp_corr_bwd"),
            # the width shards' shapes: launches from the sp phase, a rank
            (run["k1_rows_sp"], run["sp_k1"]["f32"], "warp_corr.cu",
             "warp_corr.py:210", "warp_corr"),
            (run["k1_rows_sp_bf16"], run["sp_k1"]["bf16"], "warp_corr.cu",
             "warp_corr.py:210", "warp_corr"),
            (run["k2_rows_sp"], run["sp_k2"], "warp_corr_bwd.cu",
             "warp_corr_bwd.py:61", "warp_corr_bwd")):
        bf16 = rows is run["k1_rows_bf16"] or rows is run["k2_rows_bf16"] \
            or rows is run["k1_rows_sp_bf16"]
        for key, (name, r) in rows.items():
            if key not in counts:     # measured, not on a path (DiffMVS)
                continue
            kernels.append({
                "name": f"{tag}:{name}{':bf16' if bf16 else ''}",
                "route": "cuda",
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
            "ms": r["ms"], "card_ms": r["card_ms"], "cold_ms": r["cold_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    # K3's operand kernel is the port's own: the JAX package computes the
    # operands in XLA (plane_sweep_coords + _corner_split), not in a kernel
    for name, r in run["operand_rows"]:
        kernels.append({
            "name": f"warp_corr_operands:{name}", "route": "cuda",
            "source": "diffmvs_tpu_torch/ops/csrc/warp_corr_pre.cu",
            "replaces": "diffmvs_tpu/ops/pallas/warp_corr.py:842",
            "note": "the port's own kernel, not a TPU kernel: the XLA glue "
                    "of warp_corr_pallas(batch_rows=False)",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "mismatched_samples": r["mismatched"],
            "ms": r["ms"], "card_ms": r["card_ms"], "cold_ms": r["cold_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    r = run["projection_row"]
    kernels.append({
        "name": "warp_corr_projection", "route": "cuda",
        "source": "diffmvs_tpu_torch/ops/csrc/warp_corr_pre.cu",
        "replaces": "diffmvs_tpu/ops/pallas/warp_corr.py:834",
        "note": "the port's own kernel, not a TPU kernel: "
                "relative_projection, which the JAX package runs in XLA",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "card_ms": r["card_ms"], "cold_ms": r["cold_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None})
    # PixelViewWeight's kernel replaces no TPU kernel: the JAX package
    # leaves the module to XLA's convolutions (cuDNN's in the port before).
    # Launches as counted in main, main_bf16 and main_b16; no phase runs a
    # float32 forward at B = 16, so that row is timed and counts none (null)
    pvw_launches = {"b1:f32": run["main_f32"]["pvw_launches"],
                    "b1:bf16": run["main_bf16"]["pvw_launches"],
                    "b16:bf16": run["pvw_launches_b16"]}
    for key, r in run["pvw_rows"].items():
        kernels.append({
            "name": f"pixel_view_weight:{key}", "route": "cuda",
            "source": "diffmvs_tpu_torch/ops/csrc/pixel_view_weight.cu",
            "replaces": "diffmvs_tpu/nn/costreg.py PixelViewWeight (XLA)",
            "note": "the port's own kernel, not a TPU kernel: the conv "
                    "stack, BatchNorm, ReLU, sigmoid and max over D",
            "launches": pvw_launches.get(key),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "card_ms": r["card_ms"], "cold_ms": r["cold_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # FeatureNet's stem kernel replaces no TPU kernel either (XLA's convs
    # in the JAX package); launches as counted in main_bf16 (5 images a
    # request) and main_b16 (80)
    stem_launches = {"n5:bf16": run["main_bf16"]["stem_launches"],
                     "n80:bf16": run["stem_launches_b16"]}
    for key, r in run["stem_rows"].items():
        kernels.append({
            "name": f"feature_stem:{key}", "route": "cuda",
            "source": "diffmvs_tpu_torch/ops/csrc/feature_stem.cu",
            "replaces": "diffmvs_tpu/nn/feature.py FeatureNet conv0, "
                        "conv1[0] (XLA)",
            "note": "the port's own kernel, not a TPU kernel: three convs, "
                    "BatchNorm and ReLU, the image's bf16 cast",
            "launches": stem_launches.get(key),
            "max_abs_err": r["max_abs_err"],
            "module_max_abs_err": r["module_max_abs_err"],
            "ms": r["ms"], "card_ms": r["card_ms"], "cold_ms": r["cold_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # CostRegNet's prob kernel replaces no TPU kernel either (XLA's conv in
    # the JAX package); launches as counted in main, main_bf16 and
    # main_b16; the float32 row at B = 16 is timed and counts none (null)
    prob_launches = {"b1:f32": run["main_f32"]["prob_launches"],
                     "b1:bf16": run["main_bf16"]["prob_launches"],
                     "b16:bf16": run["prob_launches_b16"]}
    for key, r in run["prob_rows"].items():
        kernels.append({
            "name": f"cost_prob:{key}", "route": "cuda",
            "source": "diffmvs_tpu_torch/ops/csrc/cost_prob.cu",
            "replaces": "diffmvs_tpu/nn/costreg.py CostRegNet prob (XLA)",
            "note": "the port's own kernel, not a TPU kernel: the 8 -> 1 "
                    "3x3x3 conv that ends CostRegNet",
            "launches": prob_launches.get(key),
            "max_abs_err": r["max_abs_err"], "max_ulp_err": r["max_ulp_err"],
            "ms": r["ms"], "card_ms": r["card_ms"], "cold_ms": r["cold_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    check(len(kernels) == 41, f"{len(kernels)} kernel rows")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
