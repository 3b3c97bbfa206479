"""Inference entry point: depth/confidence export + point-cloud fusion.

    python -m diffmvs_tpu_torch.cli.test --dataset dtu --testpath DTU \
        --testlist lists/dtu/test.txt --loadckpt casdiffmvs.ckpt \
        --save_depth --outdir outputs

Counterpart of diffmvs_tpu/cli/test.py (the reference's test.py): for
every scene it exports depth and confidence PFMs, cam files and the
reference JPEG of each view, then fuses them into a point cloud with the
reference's per-dataset settings (dtu: pc/mvs{scan:03d}_l3.ply; tank:
pc/{scene}.ply through the dynamic filter; eth3d: pc/{scene}.ply;
general: pc.ply).

What differs from the JAX CLI:
  * --device (default cuda): inference and fusion run on the card unless
    --device cpu is asked for; without a card the default raises.
  * --warp_kernel keeps its choices so scripts run unchanged, but every
    value runs the same exact CUDA warp kernel (K1): the port has one exact
    kernel and no window-miss guard, so there is nothing to choose.
  * --loadckpt takes what the JAX CLI's takes, read without JAX: a
    reference-format .ckpt ({"model": state_dict}), an orbax checkpoint
    directory the JAX package wrote (train/orbax_read.py, through the
    system's libzstd.so.1), or a training logdir of either package (its
    newest epoch, model_{epoch:06d}.ckpt or model_{epoch:06d}/).
  * Images reach the card as the dataset's uint8 (pinned when the device
    is CUDA); the model normalizes them there.
  * The DDIM noise of batch i comes from torch.Generator(device) seeded
    with --seed + i, as the JAX CLI seeds PRNGKey(seed + i); the two
    generators give different numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os

import numpy as np
import torch

from diffmvs_tpu_torch.utils import profiling


def build_argparser():
    p = argparse.ArgumentParser(
        description="Depth export + fusion (PyTorch / CUDA inference)")
    p.add_argument("--method", default="casdiffmvs",
                   choices=["casdiffmvs", "diffmvs"])
    p.add_argument("--preset", default=None,
                   help="model preset; defaults per --method/--dataset")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--loadckpt", default=None,
                   help="reference-format .ckpt, orbax checkpoint dir, or a "
                        "training logdir of either (its newest epoch)")
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--save_depth", action="store_true")
    p.add_argument("--dataset", default="general",
                   choices=["dtu", "tank", "eth3d", "general"])
    p.add_argument("--testpath")
    p.add_argument("--testlist")
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--max_h", type=int, default=4800)
    p.add_argument("--max_w", type=int, default=6400)
    p.add_argument("--numdepth_initial", type=int, default=None)
    p.add_argument("--numdepth", type=int, default=384)
    p.add_argument("--warp_kernel", default="auto",
                   choices=["auto", "xla", "pallas", "pallas_full"],
                   help="kept for the JAX CLI's scripts: every value runs "
                        "the exact CUDA warp kernel")
    p.add_argument("--geo_mask_thres", type=int, default=2)
    p.add_argument("--geo_pixel_thres", type=float, default=1.0)
    p.add_argument("--geo_depth_thres", type=float, default=0.01)
    p.add_argument("--photo_thres", nargs="+", type=float,
                   default=[0.3, 0.0, 0.0])
    p.add_argument("--workers", type=int, default=-1,
                   help="input-pipeline worker processes; -1 = one per "
                        "CPU core, 0 = in-process loading")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def default_preset(method: str, dataset: str) -> str:
    if dataset == "dtu":
        return method
    if dataset == "tank":
        return f"{method}_tank"
    return f"{method}_mvg"


def load_state_dict(path: str, cfg=None):
    """The model weights (the reference's key names) of --loadckpt: a
    reference-format .ckpt (a pickle: load only files you trust), an orbax
    checkpoint directory of the JAX package, or a training logdir of
    either (its newest epoch). An orbax checkpoint is carried into
    CasDiffMVS(cfg)'s keys, so it needs cfg (train/checkpoint.py)."""
    from diffmvs_tpu_torch.train.checkpoint import (is_orbax, load_variables,
                                                    resolve)

    if cfg is None and is_orbax(resolve(path)):
        raise ValueError(f"--loadckpt {path}: an orbax checkpoint needs the "
                         f"model's ModelConfig to map its variables")
    return load_variables(path, cfg)


def save_scene_depth(args, cfg, testlist) -> dict:
    """Export depth maps for the scenes in `testlist`. Returns the number
    of views and the host seconds spent waiting for batches (load), in
    the model with the results back on the host (infer) and writing files
    (write): summed, and per batch under "batches". The seconds are those
    of the spans export.load, export.infer and export.write."""
    from PIL import Image

    from diffmvs_tpu_torch.api import DepthRunner, resolve_device
    from diffmvs_tpu_torch.data.io import save_pfm, write_cam
    from diffmvs_tpu_torch.data.mvs import MVSDataset
    from diffmvs_tpu_torch.data.pipeline import DataPipeline

    dev = resolve_device(args.device)
    runner = None
    stats = {"views": 0, "load_s": 0.0, "infer_s": 0.0, "write_s": 0.0,
             "batches": []}
    times = []
    for scene in testlist:
        ds = MVSDataset(args.testpath, args.num_view, args.numdepth,
                        dataset=args.dataset, scan=[scene],
                        max_h=args.max_h, max_w=args.max_w)
        loader = DataPipeline(ds, args.batch_size, shuffle=False,
                              drop_last=False, num_workers=args.workers,
                              pin_memory=dev.type == "cuda")
        batches = None
        for batch_idx in itertools.count():
            with profiling.span("export.load") as load:
                if batches is None:
                    batches = iter(loader)
                batch = next(batches, None)
            if batch is None:
                break
            stats["load_s"] += load.seconds
            if runner is None:
                sd = (load_state_dict(args.loadckpt, cfg) if args.loadckpt
                      else None)
                runner = DepthRunner(cfg, sd, device=dev, seed=0)
            imgs = batch["imgs"]
            projs = batch["proj_matrices"]
            depth_values = batch["depth_values"].numpy()
            bsz = imgs.shape[0]

            with profiling.span("export.infer") as infer:
                gen = torch.Generator(device=dev).manual_seed(
                    args.seed + batch_idx)
                depth, confs = runner(imgs, projs, batch["depth_values"],
                                      generator=gen)
                depth = depth.cpu().numpy()
                confs = [c.cpu().numpy() for c in confs]
            stats["infer_s"] += infer.seconds
            times.append(infer.seconds / bsz)
            print(f"Iter {batch_idx}/{len(loader)}, Time:{infer.seconds:.3f} "
                  f"Res:{tuple(imgs.shape)}")

            with profiling.span("export.write") as write:
                cams = projs["stage4"].numpy()
                for j in range(bsz):
                    filename = batch["filename"][j]
                    depth_max = 1.0 / depth_values[j, 0]
                    depth_min = 1.0 / depth_values[j, -1]

                    def outpath(sub, ext, _f=filename):
                        path = os.path.join(args.outdir, _f.format(sub, ext))
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        return path

                    save_pfm(outpath("depth_est", ".pfm"), depth[j])
                    write_cam(outpath("cams", "_cam.txt"), cams[j, 0],
                              depth_max, depth_min)
                    Image.fromarray(imgs[j, 0].numpy()).save(
                        outpath("images", ".jpg"))
                    n_conf = 3 if args.method == "casdiffmvs" else 2
                    for i in range(n_conf):
                        save_pfm(outpath(f"conf{i}", ".pfm"), confs[i][j])
            stats["views"] += bsz
            stats["write_s"] += write.seconds
            stats["batches"].append({"views": bsz, "load_s": load.seconds,
                                     "infer_s": infer.seconds,
                                     "write_s": write.seconds})
    if times:
        print("avg_time", float(np.mean(times)))
    return stats


def run_fusion(args, testlist) -> dict:
    """Per-dataset fusion dispatch. Returns {ply path: points}."""
    from diffmvs_tpu_torch.config import (
        ETH3D_GEO_MASK_THRES, ETH3D_GEO_PIXEL_THRES, TANK_PHOTO_THRES)
    from diffmvs_tpu_torch.fusion.fuse import (filter_depth,
                                               filter_depth_dynamic)

    dev = args.device
    plypath = os.path.join(args.outdir, "pc")
    os.makedirs(plypath, exist_ok=True)
    points = {}

    if args.dataset == "general":
        ply = os.path.join(args.outdir, "pc.ply")
        points[ply] = filter_depth(
            args.testpath, args.outdir, ply, args.geo_mask_thres,
            args.geo_pixel_thres, args.geo_depth_thres,
            tuple(args.photo_thres), args.method, args.dataset, device=dev)
        return points

    for scan in testlist:
        pair_folder = os.path.join(args.testpath, scan)
        out_folder = os.path.join(args.outdir, scan)
        if args.dataset == "dtu":
            scan_id = int(scan[4:])
            ply = os.path.join(plypath, f"mvs{scan_id:03d}_l3.ply")
            points[ply] = filter_depth(
                pair_folder, out_folder, ply, args.geo_mask_thres,
                args.geo_pixel_thres, args.geo_depth_thres,
                tuple(args.photo_thres), args.method, args.dataset,
                device=dev)
        elif args.dataset == "tank":
            name = scan.split("/")[1]
            ply = os.path.join(plypath, f"{name}.ply")
            points[ply] = filter_depth_dynamic(
                name, pair_folder, out_folder, ply, TANK_PHOTO_THRES[name],
                args.method, device=dev)
        elif args.dataset == "eth3d":
            ply = os.path.join(plypath, f"{scan}.ply")
            points[ply] = filter_depth(
                pair_folder, out_folder, ply,
                ETH3D_GEO_MASK_THRES.get(scan, 1),
                ETH3D_GEO_PIXEL_THRES.get(scan, 1.0),
                args.geo_depth_thres, tuple(args.photo_thres), args.method,
                args.dataset, device=dev)
    return points


def parse_args(argv=None):
    args = build_argparser().parse_args(argv)
    if args.workers < 0:
        args.workers = os.cpu_count() or 1
    return args


def main(argv=None) -> dict:
    """Returns {"export": save_scene_depth's seconds (None without
    --save_depth), "fusion_s": host seconds of the fusion (its span
    export.fusion), "points": {ply: points}}."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS

    args = parse_args(argv)
    cfg = MODEL_PRESETS[args.preset or default_preset(args.method,
                                                      args.dataset)]
    if args.numdepth_initial:
        cfg = dataclasses.replace(cfg, numdepth_initial=args.numdepth_initial)
    cfg = dataclasses.replace(cfg, numdepth=args.numdepth)

    if args.dataset == "general" or not args.testlist:
        testlist = [""]
    else:
        with open(args.testlist) as f:
            testlist = [line.rstrip() for line in f.readlines()]

    export = (save_scene_depth(args, cfg, testlist)
              if args.save_depth else None)
    with profiling.span("export.fusion") as fusion:
        points = run_fusion(args, testlist)
    return {"export": export, "fusion_s": fusion.seconds, "points": points}


if __name__ == "__main__":
    main()
