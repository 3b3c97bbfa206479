"""Benchmark: CasDiffMVS depth-map inference throughput on one card.

    python -m diffmvs_tpu_torch.bench [--device cuda|cpu] [--batch N]
        [--set field=value,...] [--check]
    python -m diffmvs_tpu_torch.bench --train [--bwd kernel|plain]
    python -m diffmvs_tpu_torch.bench --io [--workers N] [--predecoded]
    python -m diffmvs_tpu_torch.bench --check | --all

Counterpart of the JAX package's bench.py, with its modes, flags, metric
names and units. Each mode prints ONE JSON line:

  default  -- depth maps per second: CasDiffMVS in bf16 compute at DTU
              size (1152x1600, 5 views, 48/384 hypotheses), B = 16
              view-sets per forward, random weights from seed 0;
  --train  -- training samples per second: bf16 + remat, B = 4, 5 views,
              512x640, 48/384;
  --io     -- view-sets per second of the host loader (data/mvs.py +
              data/pipeline.py) over a synthetic 10-view DTU scan;
  --check  -- K1 against the plain warp at the three production shapes
              and K2's gradients against the plain warp's autograd, gated
              at 1e-4 max relative error; exits non-zero when it fails;
  --all    -- check, inference, train and io, in that order.

--device defaults to cuda and raises without a card; --device cpu selects
bench.py's CPU smoke configurations (small shapes, 2 repetitions). The
parity gate is the card's: --check and --all refuse the CPU.

Timing. `reps` forwards (or train steps) run back to back with no host
read between them; each takes its own torch.Generator seeded from its
index (the counterpart of fold_in(key, i)), and a device accumulator sums
depth[-1].mean() (or the loss), read once at the chain's end. One warm-up
chain (cuDNN's autotuning, the kernels' build) precedes 3 timed chains,
each after a synchronize and between two CUDA events, Python's garbage
collector run before it and disabled inside it (timeit's convention: a
generation-2 collection, ~0.2 s on an H100's host, fell in every third
training chain): `value` is the batch over the median card seconds per
forward, `spread` (max - min) / median over the chains, the host clock
beside it. On the CPU one timed chain follows the warm-up and the host
clock is the only one.

Deliberate differences from bench.py:
  * vs_baseline is null in every line: bench.py's 20 (and its loader's 40)
    are the TPU v5e north star, not a baseline for a card;
  * the parity line is cuda_vs_plain_parity_max_rel_err (bench.py's names
    Pallas and the TPU) with backend "cuda";
  * --set refuses, by name, a field the port's ModelConfig lacks (the
    JAX package's warp-kernel, s2d and unrolling options): those layouts
    are not ported, and tpu_optimized / train_optimized return the preset
    unchanged off the TPU, so the port's configurations are the plain
    preset with bench.py's widths, dtype and remat;
  * the training line runs K1 + K2, the port's only card route, where
    bench.py trains through the XLA warp (train_optimized); --bwd plain
    trains through ops/correlation.warp_and_correlate_plain's autograd
    instead (the counterpart of warp_bwd="recompute"), passed to the
    model as its warp, never swapped into a module;
  * the train state is updated in place from chain to chain (bench.py's
    scan returns the loss only).
  * the loader line warms up with a whole pass where bench.py takes one
    batch: the port's DataLoader workers, dropped with items in flight,
    abort.

Imports torch and the port only; nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

if __name__ == "__main__":
    # for the loader's spawned workers (the package has imported torch
    # already); set by the script's run, never by a module importing it
    os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import torch

from diffmvs_tpu_torch.config import MODEL_PRESETS, ModelConfig

TIMED_CHAINS = {"cuda": 3, "cpu": 1}
PARITY_GATE = 1e-4


class Shape(NamedTuple):
    """bench.py's (batch, h, w, numdepth, numdepth_initial, reps)."""
    batch: int
    h: int
    w: int
    numdepth: int
    numdepth_initial: int
    reps: int


# bench.py:303-309 (main) and :122-125 (bench_train), by device type
INFER_SHAPES = {"cuda": Shape(16, 1152, 1600, 384, 48, 6),
                "cpu": Shape(1, 128, 160, 64, 16, 2)}
TRAIN_SHAPES = {"cuda": Shape(4, 512, 640, 384, 48, 4),
                "cpu": Shape(1, 64, 96, 32, 8, 2)}


def parse_overrides(text: str) -> dict:
    """--set's "field=value,..." as {field: literal}; commas inside
    parentheses belong to the value (tuples: "scale=(0.0, 0.5, 0.1)").
    A field the port's ModelConfig lacks raises a ValueError naming it."""
    if not text:
        return {}
    kv = dict(p.split("=", 1) for p in re.split(r",(?![^(]*\))", text))
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    for k in kv:
        if k not in known:
            raise ValueError(
                f"--set: {k!r} is not a field of the port's ModelConfig "
                f"(the JAX package's warp-kernel, s2d and unrolling "
                f"options are not ported); fields: {sorted(known)}")
    return {k: ast.literal_eval(v) for k, v in kv.items()}


def infer_config(device_type: str, overrides: str = ""):
    """(ModelConfig, Shape) of the inference line: CasDiffMVS in bf16
    compute at bench.py's widths, then --set's fields."""
    shape = INFER_SHAPES[device_type]
    cfg = dataclasses.replace(
        MODEL_PRESETS["casdiffmvs"], numdepth_initial=shape.numdepth_initial,
        numdepth=shape.numdepth, compute_dtype="bfloat16")
    return dataclasses.replace(cfg, **parse_overrides(overrides)), shape


def train_config(device_type: str, overrides: str = ""):
    """(ModelConfig, Shape) of the training line: bf16 + remat."""
    shape = TRAIN_SHAPES[device_type]
    cfg = dataclasses.replace(
        MODEL_PRESETS["casdiffmvs"], numdepth_initial=shape.numdepth_initial,
        numdepth=shape.numdepth, compute_dtype="bfloat16", remat=True)
    return dataclasses.replace(cfg, **parse_overrides(overrides)), shape


def train_batch(b, h, w, numdepth):
    """bench.py's training batch (bench.py:149-156): synthetic inputs, GT
    depth 6.0 at the four scales and masks of ones (numpy)."""
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    imgs, projs, depth_values = synthetic_inputs(b, 5, h, w, numdepth)
    gt = np.full((b, h, w), 6.0, np.float32)
    depth_ms = {f"stage{i + 1}": gt[:, ::s, ::s].copy()
                for i, s in enumerate((8, 4, 2, 1))}
    mask_ms = {k: np.ones_like(v) for k, v in depth_ms.items()}
    return {"imgs": imgs, "proj_matrices": projs,
            "depth_values": depth_values, "depth": depth_ms,
            "mask": mask_ms}


def make_cams(v, h, w):
    """[V, 2, 4, 4] (extrinsic, intrinsic): the reference view at the
    origin, the sources on a 0.04 rad/view arc; full-resolution
    intrinsics (the parity gate's rig)."""
    focal = 1.2 * w
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    cams = []
    for i in range(v):
        th = 0.0 if i == 0 else 0.04 * i
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = np.array(
            [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
             [-np.sin(th), 0, np.cos(th)]], np.float32)
        e[:3, 3] = [0.25 * i, 0.02 * i, 0.0]
        mat = np.zeros((2, 4, 4), np.float32)
        mat[0] = e
        mat[1, :3, :3] = k
        cams.append(mat)
    return np.stack(cams)


def stage_projs(cams):
    """{stage1..4: cams with the intrinsics scaled to 1/8 .. 1}."""
    out = {}
    for stage, s in (("stage1", 0.125), ("stage2", 0.25), ("stage3", 0.5),
                     ("stage4", 1.0)):
        m = cams.copy()
        m[:, 1, :2, :] = cams[:, 1, :2, :] * s
        out[stage] = m
    return out


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them; "cpu"
    off the card."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def infer_chain(runner, inputs, reps: int) -> torch.Tensor:
    """`reps` forwards of `runner` (an api.DepthRunner) on `inputs` (imgs,
    projs, depth_values), forward i drawing its noise from a generator
    seeded with i; returns the device sum of their depth[-1].mean()."""
    imgs, projs, depth_values = inputs
    with torch.inference_mode():
        acc = torch.zeros((), device=runner.device)
        for i in range(reps):
            gen = torch.Generator(device=runner.device).manual_seed(i)
            depth, _ = runner(imgs, projs, depth_values, generator=gen)
            acc = acc + depth.mean()
    return acc


def train_chain(state, cfg, batch, reps: int) -> torch.Tensor:
    """`reps` train steps of `state` on `batch` (on its device), step i
    drawing from a generator seeded with i; returns the device sum of the
    losses."""
    from diffmvs_tpu_torch.train.step import train_step

    acc = torch.zeros((), device=state.device)
    for i in range(reps):
        gen = torch.Generator(device=state.device).manual_seed(i)
        scalars, _ = train_step(state, cfg, batch, generator=gen)
        acc = acc + scalars["loss"].detach()
    return acc


def time_chains(chain, dev: torch.device):
    """TIMED_CHAINS[dev.type] timed chains (the caller has run the
    warm-up), each with Python's garbage collector run before it and
    disabled inside it, as timeit times. Returns ({"card": [s], "host":
    [s]} per chain, the last chain's value); on the CPU "card" is
    empty."""
    times, value = {"card": [], "host": []}, None
    for _ in range(TIMED_CHAINS[dev.type]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            if dev.type == "cuda":
                start.record()
            acc = chain()
            if dev.type == "cuda":
                end.record()
            value = acc.item()
            times["host"].append(time.perf_counter() - t0)
        finally:
            gc.enable()
        if dev.type == "cuda":
            times["card"].append(start.elapsed_time(end) / 1e3)
    return times, value


def timing_keys(times, reps: int, unit: str):
    """(seconds per unit the value divides by, the line's timing keys):
    the card's median where there is one, else the host's."""
    card = [t / reps for t in times["card"]]
    host = [t / reps for t in times["host"]]
    per = card or host
    med = statistics.median(per)
    return med, {
        f"card_s_per_{unit}": statistics.median(card) if card else None,
        "spread": (max(per) - min(per)) / med if len(per) > 1 else None,
        f"host_s_per_{unit}": statistics.median(host),
        f"chain_s_per_{unit}": per,
    }


def peak_gib(dev: torch.device):
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)


def reset_peak(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def check_finite(value: float, what: str):
    if not math.isfinite(value):
        raise RuntimeError(f"bench: {what} are not finite ({value})")


def main(batch: int = 0, overrides: str = "", device: str = "cuda"):
    """The inference line. batch: view-sets per forward (0: bench.py's
    16 on the card, 1 on the CPU)."""
    from diffmvs_tpu_torch.api import DepthRunner, resolve_device
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.utils import profiling
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

    dev = resolve_device(device)
    cfg, shape = infer_config(dev.type, overrides)
    bsz = batch or shape.batch
    runner = DepthRunner(cfg, device=dev, seed=0)
    imgs, projs, depth_values = synthetic_inputs(bsz, 5, shape.h, shape.w,
                                                 cfg.numdepth)
    inputs = (torch.from_numpy(imgs).to(dev),
              {k: torch.from_numpy(v).to(dev) for k, v in projs.items()},
              torch.from_numpy(depth_values).to(dev))
    reset_peak(dev)

    def chain():
        return infer_chain(runner, inputs, shape.reps)

    chain().item()                      # warm-up: autotuning, the build
    warp_corr.reset_counts()
    times, total = time_chains(chain, dev)
    n_fwd = shape.reps * len(times["host"])
    sec, keys = timing_keys(times, shape.reps, "forward")
    check_finite(total, "the chained depth means")
    value = bsz / sec
    print(json.dumps({
        "metric": "casdiffmvs_dtu1600x1152_n5_inference_throughput",
        "value": value,
        "unit": "depth_maps/s/chip",
        "vs_baseline": None,
        "batch": bsz,
        "reps": shape.reps,
        **keys,
        "peak_gib": peak_gib(dev),
        "k1_launches_per_forward": profiling.counter("warp_corr.k1") / n_fwd,
        "device": card_name(dev),
        **({"config": overrides} if overrides else {}),
    }), flush=True)


WARPS = ("kernel", "plain")


def bench_train(bwd: str = "", overrides: str = "", device: str = "cuda"):
    """The training line. bwd: "" or "kernel" (K1 + K2), or "plain" (the
    plain warp and its autograd, the model's warp argument)."""
    from diffmvs_tpu_torch.api import resolve_device
    from diffmvs_tpu_torch.config import TrainConfig
    from diffmvs_tpu_torch.ops import warp_corr
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import batch_to_device
    from diffmvs_tpu_torch.utils import profiling

    if bwd and bwd not in WARPS:
        raise ValueError(f"--bwd {bwd!r}: one of {WARPS} (bench.py's "
                         f"pallas and recompute)")
    dev = resolve_device(device)
    model_cfg, shape = train_config(dev.type, overrides)
    b = shape.batch
    cfg = TrainConfig(model=model_cfg, batch_size=b)
    state = create_train_state(
        cfg, steps_per_epoch=100, device=dev, seed=0,
        warp=warp_and_correlate_plain if bwd == "plain" else None)
    batch = batch_to_device(
        train_batch(b, shape.h, shape.w, shape.numdepth), dev)
    reset_peak(dev)

    def chain():
        return train_chain(state, cfg, batch, shape.reps)

    chain().item()                      # warm-up: autotuning, the build
    warp_corr.reset_counts()
    times, total = time_chains(chain, dev)
    steps = shape.reps * len(times["host"])
    sec, keys = timing_keys(times, shape.reps, "step")
    check_finite(total, "the chained losses")
    print(json.dumps({
        "metric": "casdiffmvs_train_dtu640x512_n5_throughput"
                  + (f"_bwd_{bwd}" if bwd else ""),
        "value": b / sec,
        "unit": "samples/s/chip",
        "sec_per_step": sec,
        "vs_baseline": None,
        "batch": b,
        "reps": shape.reps,
        **keys,
        "peak_gib": peak_gib(dev),
        "k1_launches_per_step": profiling.counter("warp_corr.k1") / steps,
        "k2_launches_per_step": profiling.counter("warp_corr.k2") / steps,
        "device": card_name(dev),
        **({"config": overrides} if overrides else {}),
    }), flush=True)


def write_io_scan(root: str, predecoded: bool, n_views_total: int = 10,
                  v: int = 5):
    """bench.py's synthetic DTU scan under root/scan1: 1200x1600 JPEGs (or
    1152x1600 uint8 .npy caches), arc cams and a pair.txt."""
    from PIL import Image

    scan = os.path.join(root, "scan1")
    os.makedirs(os.path.join(scan, "images"))
    os.makedirs(os.path.join(scan, "cams_1"))
    rng = np.random.RandomState(0)
    img = (rng.rand(1200, 1600, 3) * 255).astype(np.uint8)
    for i in range(n_views_total):
        if predecoded:
            np.save(os.path.join(scan, f"images/{i:08d}.npy"),
                    np.ascontiguousarray(
                        (rng.rand(1152, 1600, 3) * 255).astype(np.uint8)))
        else:
            Image.fromarray(img).save(
                os.path.join(scan, f"images/{i:08d}.jpg"))
        k = np.array([[1920.0, 0, 800], [0, 1920.0, 600], [0, 0, 1]])
        with open(os.path.join(scan, f"cams_1/{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            e = np.eye(4)
            e[0, 3] = 0.1 * i
            for r in range(4):
                f.write(" ".join(str(e[r, c]) for c in range(4)) + "\n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(str(k[r, c]) for c in range(3)) + "\n")
            f.write("\n425.0 2.5 192 935.0\n")
    with open(os.path.join(scan, "pair.txt"), "w") as f:
        f.write(f"{n_views_total}\n")
        for i in range(n_views_total):
            others = [j for j in range(n_views_total) if j != i][:v - 1]
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {100.0 - j}" for j in others) + "\n")


def bench_io(workers: int, predecoded: bool = False):
    """The loader line: view-sets per second of MVSDataset + DataPipeline
    over bench.py's synthetic scan, one full pass after a warm-up pass
    (spawned workers start anew with each pass)."""
    import tempfile

    from diffmvs_tpu_torch.data.mvs import MVSDataset
    from diffmvs_tpu_torch.data.pipeline import DataPipeline

    with tempfile.TemporaryDirectory() as root:
        write_io_scan(root, predecoded)
        ds = MVSDataset(root + "/", 5, 384, dataset="dtu", scan=["scan1"])
        loader = DataPipeline(ds, 1, num_workers=workers)
        # warm-up: a whole pass (page cache, the workers' imports); a pass
        # left part-way, as bench.py's next(iter(...)) leaves it, drops
        # its workers with items in flight, and they abort
        sum(1 for _ in loader)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        elapsed = time.perf_counter() - t0
    print(json.dumps({
        "metric": f"host_input_pipeline_dtu_workers{workers}"
                  + ("_predecoded" if predecoded else ""),
        "value": n / elapsed,
        "unit": "view_sets/s",
        "vs_baseline": None,
        "view_sets": n,
        "seconds": elapsed,
    }), flush=True)


CARD_ONLY = ("bench: the kernel parity gate is the card's (K1 and K2 "
             "against the plain warp on CUDA); it has no CPU form")


def check_kernel_parity(device: str = "cuda"):
    """K1 against the plain warp in f32 at bench.py's three production
    shapes (bench.py:219-221), and K2's gradients of a sum-loss against
    the plain warp's autograd at the stage-3 refinement shape; gate: max
    relative error <= 1e-4 each. Prints one JSON line; exits non-zero
    when the gate fails. Refuses the CPU."""
    from diffmvs_tpu_torch.api import resolve_device, set_f32_precision
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
    from diffmvs_tpu_torch.ops.warp_corr import warp_corr

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit(CARD_ONLY)
    set_f32_precision()

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rel_err(got, want):
        scale = want.abs().max().item()
        return (got - want).abs().max().item() / max(scale, 1e-12)

    rng = np.random.RandomState(0)
    worst = 0.0
    shapes = [("stage3", 576, 800, 16, 4, False),
              ("stage2", 288, 400, 32, 4, False),
              ("stage1", 144, 200, 48, 48, True)]
    for stage, hs, ws, c, d, sweep in shapes:
        fullmul = {"stage1": 8, "stage2": 4, "stage3": 2}[stage]
        cams = stage_projs(make_cams(2, hs * fullmul, ws * fullmul))[stage]
        rp, sp = on_card(cams[0][None]), on_card(cams[1][None])
        src = on_card(rng.randn(1, hs, ws, c).astype(np.float32))
        ref = on_card(rng.randn(1, hs, ws, c).astype(np.float32))
        if sweep:
            planes = 1.0 / np.linspace(1 / 10.0, 1 / 4.0, d,
                                       dtype=np.float32)
            depths = on_card(np.broadcast_to(
                planes.reshape(1, d, 1, 1), (1, d, hs, ws)))
        else:
            base = 6.0 + 1.5 * rng.rand(1, 1, hs, ws).astype(np.float32)
            offs = (np.arange(d, dtype=np.float32) - d / 2) * 0.005
            depths = on_card(base + offs.reshape(1, d, 1, 1))
        with torch.no_grad():
            want = warp_and_correlate_plain(src, ref, sp, rp, depths, 8)
            got = warp_corr(src, ref, sp, rp, depths, 8)
        worst = max(worst, rel_err(got, want))

    # K2: the gradients of a sum-loss at the stage-3 refinement shape
    hs, ws, c, d = 288, 400, 16, 4
    cams = stage_projs(make_cams(2, hs * 2, ws * 2))["stage3"]
    rp, sp = on_card(cams[0][None]), on_card(cams[1][None])
    src = on_card(rng.randn(1, hs, ws, c).astype(np.float32))
    ref = on_card(rng.randn(1, hs, ws, c).astype(np.float32))
    base = 6.0 + 1.5 * rng.rand(1, 1, hs, ws).astype(np.float32)
    offs = (np.arange(d, dtype=np.float32) - d / 2) * 0.005
    depths = on_card(base + offs.reshape(1, d, 1, 1))

    def grads(fn):
        s = src.clone().requires_grad_(True)
        r = ref.clone().requires_grad_(True)
        fn(s, r, sp, rp, depths, 8).float().sum().backward()
        return s.grad, r.grad

    worst_bwd = max(rel_err(g, w) for g, w in zip(
        grads(warp_corr), grads(warp_and_correlate_plain)))

    ok = worst <= PARITY_GATE and worst_bwd <= PARITY_GATE
    print(json.dumps({
        "metric": "cuda_vs_plain_parity_max_rel_err",
        "value": worst, "bwd_value": worst_bwd, "unit": "rel_err",
        "backend": "cuda",
        "pass": ok,
        "device": card_name(dev),
    }), flush=True)
    if not ok:
        raise SystemExit(f"bench: kernel parity check failed: fwd {worst} "
                         f"bwd {worst_bwd} (gate {PARITY_GATE})")


def cli(argv=None):
    parser = argparse.ArgumentParser(
        description="default: the inference-throughput JSON line")
    parser.add_argument("--io", action="store_true",
                        help="host input-pipeline throughput instead")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--predecoded", action="store_true",
                        help="--io with pre-decoded uint8 .npy images "
                             "(serving-cache contract; decode-free)")
    parser.add_argument("--train", action="store_true",
                        help="train-step throughput instead")
    parser.add_argument("--bwd", default="",
                        help="the warp's backward for --train: kernel "
                             "(K1 + K2, the default) or plain (the plain "
                             "warp's autograd)")
    parser.add_argument("--batch", type=int, default=0,
                        help="override view-set batch size (default 16)")
    parser.add_argument("--set", default="", dest="overrides",
                        help="ModelConfig overrides for A/Bs, e.g. "
                             "'scale=(0.0, 0.5, 0.1),remat=True'")
    parser.add_argument("--check", action="store_true",
                        help="gate on the kernels' parity with the plain "
                             "warp on the card before benching")
    parser.add_argument("--all", action="store_true",
                        help="emit all tracked JSON lines: parity check, "
                             "inference line, train step, host IO")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or "
                             "cpu (bench.py's smoke configurations)")
    a = parser.parse_args(argv)
    from diffmvs_tpu_torch.api import resolve_device

    dev = resolve_device(a.device)
    parse_overrides(a.overrides)        # refuse an unknown field up front
    if (a.check or a.all) and dev.type != "cuda":
        raise SystemExit(CARD_ONLY)
    if a.all:
        check_kernel_parity(a.device)
        main(a.batch, a.overrides, a.device)
        bench_train(a.bwd, device=a.device)
        bench_io(a.workers)
    elif a.io:
        bench_io(a.workers, a.predecoded)
    elif a.train:
        bench_train(a.bwd, a.overrides, a.device)
    else:
        if a.check:
            check_kernel_parity(a.device)
        main(a.batch, a.overrides, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
