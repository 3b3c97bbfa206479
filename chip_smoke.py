"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. device  -- needs CUDA; prints the card's name and power limit; TF32 off
  2. build   -- compiles the warp kernel (ops/csrc/warp_corr.cu) with nvcc
  3. kernels -- the warp kernel against its plain PyTorch version at the
                main path's shapes (and DiffMVS's refinement shape), f32
                and bf16 features, with CUDA-event times and the bound
  4. small   -- the port on CUDA against the port on the CPU (the path the
                CPU tests hold against JAX), same weights, 64x96
  5. main    -- CasDiffMVS export inference at DTU size (1152x1600, 5
                views, 48/384 hypotheses, f32, random weights from seed 0):
                3 requests through DepthRunner; 28 kernel launches each;
                the first request again with the plain warp in place of
                the kernel must agree
Then a JSON line of per-kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}.

Imports torch and the port only; nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
CORR_TOL = dict(rtol=1e-4, atol=1e-5)


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


def warp_bound(n, d, h, w, hs, ws, c, g, feat_bytes):
    """Least time (ms) for one warp_corr call and what bounds it: each
    input read once and the output written once, against the operations
    it needs (coordinates ~20 per plane-pixel, 11 per channel for the
    three lerps and the product-accumulate, 1 per group mean)."""
    nbytes = (n * g * d * h * w * 4 + n * h * w * c * feat_bytes
              + n * hs * ws * c * feat_bytes + n * d * h * w * 4 + n * 48)
    ops = n * d * h * w * (20 + 11 * c + g)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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

    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.models import stages
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    lib = warp_corr.build()
    warp_corr._load()
    ptxas = [l.strip() for l in (lib.parent / "build.log").read_text()
             .splitlines() if "registers" in l or "spill" in l]
    log("build", seconds=f"{time.time() - t0:.1f}", lib=lib.name,
        ptxas=repr(" | ".join(ptxas)))

    # ---- 3. kernel against its plain version ------------------------------
    dev = torch.device("cuda")
    hh, ww, views = 1152, 1600, 5
    _, projs, _ = synthetic_inputs(1, views, hh, ww, 384)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {  # name: (stage key, D, C, scale), G = 4 throughout
        "sweep": ("stage1", 48, 48, 8),
        "stage2": ("stage2", 4, 32, 4),
        "stage3": ("stage3", 4, 16, 2),
        "diffmvs_refine": ("stage2", 6, 32, 4),
    }
    kernel_rows = {}
    for name, (stage, d, c, s) in shapes.items():
        h, w = hh // s, ww // s
        pairs = torch.from_numpy(projs[stage]).to(dev)
        sp, rp = pairs[:, views - 1], pairs[:, 0]       # widest baseline
        if name == "sweep":
            inv = torch.arange(d, device=dev) / (d - 1.0)
            depth = 1.0 / (0.1 + 0.15 * inv)            # 4..10 m planes
            depth = depth.reshape(1, d, 1, 1).expand(1, d, h, w).contiguous()
        else:
            base = 4.0 + 6.0 * torch.rand(1, 1, h, w, device=dev,
                                          generator=gen)
            offs = (torch.arange(d, device=dev) - d / 2) * 0.05
            depth = (base + offs.reshape(1, d, 1, 1)).contiguous()
            # degenerate hypotheses: zero depth (z == 0 clamp), behind the
            # camera, tiny and huge
            depth[:, :, 0, :4] = torch.tensor([0.0, -5.0, 1e-30, 1e30],
                                              device=dev)
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
        kernel_rows[(d, h, w, c)] = (name, row["f32"])

    # batched samples with their own projections, odd sizes, and the
    # scalar-load path (C/G = 3) next to the vector path (C/G = 4)
    for c in (12, 16):
        n, d, h, w = 2, 5, 37, 53
        pairs = torch.from_numpy(projs["stage1"]).to(dev)
        sp = torch.stack([pairs[0, 1], pairs[0, 3]])
        rp = torch.stack([pairs[0, 0], pairs[0, 0]])
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

    # ---- 4. CUDA path against the CPU path on a small input ---------------
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

    # ---- 5. main path ----------------------------------------------------
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
    peak = torch.cuda.max_memory_allocated()

    for depth, confs in results:
        check(depth.shape == (1, hh, ww), f"depth shape {depth.shape}")
        check(len(confs) == 3 and all(cf.shape == (1, hh, ww)
                                      for cf in confs), "3 full-res confs")
        check(bool(torch.isfinite(depth).all()) and all(
            bool(torch.isfinite(cf).all()) for cf in confs), "finite")
    check(launches == 28 * len(requests), f"{launches} kernel launches")
    main_rows = {k: v for k, v in kernel_rows.items() if k in by_shape}
    check(sorted(by_shape.values()) == [12, 36, 36], f"by shape {by_shape}")
    check(len(main_rows) == 3, f"main-path shapes {by_shape}")

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

    kernels = []
    for key, (name, r) in main_rows.items():
        kernels.append({
            "name": f"warp_corr:{name}", "route": "cuda",
            "source": "diffmvs_tpu_torch/ops/csrc/warp_corr.cu",
            "replaces": "diffmvs_tpu/ops/pallas/warp_corr.py:210",
            "launches": by_shape[key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
