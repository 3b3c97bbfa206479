"""DTU point-cloud evaluation (offline port of the official MATLAB
protocol).

    python -m diffmvs_tpu_torch.cli.eval_dtu \
        --pc_dir OUT/pc --gt_dir "SampleSet/MVS Data" \
        --scans 1 4 9 ... [--json results.json] [--device cpu]

Counterpart of diffmvs_tpu/cli/eval_dtu.py. Protocol per scan (the DTU
toolbox's BaseEvalMain_web.m / ComputeStat_web.m semantics):
  1. load the fused cloud (mvs{scan:03d}_l3.ply, cli/test.py's DTU
     naming) and grid-downsample it at `dst` = 0.2 mm (reducePts_haa);
  2. ACCURACY: distance pred -> stl, keeping only pred points inside
     the ObsMask bounding box (+ margin) whose mask cell is observed,
     and distances <= max_dist (20 mm);
  3. COMPLETENESS: distance stl -> pred, keeping only stl points above
     the ground plane (P' * [x;1] > 0), distances <= max_dist;
  4. overall = (mean_acc + mean_comp) / 2; the dataset score averages
     the per-scan overalls.

Distances use the exact chunked nearest-neighbour search of
fusion/metrics.py, on the card unless --device cpu. ObsMask/Plane .mat
files load with scipy.io. Without masks under --gt_dir (no ObsMask/Plane
files), the unmasked acc/comp is reported and flagged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def reduce_pts(xyz: np.ndarray, dst: float) -> np.ndarray:
    """Grid downsample: at most one point per dst-sized voxel (the
    toolbox's reducePts_haa enforces a dst minimum separation with a
    kd-tree; one-point-per-cell is the standard python equivalent)."""
    if xyz.shape[0] == 0:
        return xyz
    cells = np.floor(xyz / dst).astype(np.int64)
    # lexicographic unique over cells
    _, idx = np.unique(cells, axis=0, return_index=True)
    return xyz[np.sort(idx)]


def load_obs_mask(gt_dir: str, scan: int, margin: float):
    """ObsMask{scan}_10.mat -> (keep_fn(points) -> bool mask) or None."""
    from scipy.io import loadmat

    path = os.path.join(gt_dir, "ObsMask", f"ObsMask{scan}_10.mat")
    if not os.path.exists(path):
        return None
    m = loadmat(path)
    obs_mask, bb, res = m["ObsMask"], m["BB"], float(np.squeeze(m["Res"]))

    def keep(pts: np.ndarray) -> np.ndarray:
        lo = bb[0] - margin
        hi = bb[1] + margin
        inside = np.all((pts >= lo) & (pts < hi), axis=1)
        # mask grid index (MATLAB: round((p - BB(1,:)) / Res) + 1)
        gi = np.round((pts - bb[0]) / res).astype(np.int64)
        valid = np.all((gi >= 0) & (gi < np.array(obs_mask.shape)), axis=1)
        ok = np.zeros(pts.shape[0], bool)
        sel = inside & valid
        ok[sel] = obs_mask[gi[sel, 0], gi[sel, 1], gi[sel, 2]] > 0
        return ok

    return keep


def load_plane(gt_dir: str, scan: int):
    from scipy.io import loadmat

    path = os.path.join(gt_dir, "ObsMask", f"Plane{scan}.mat")
    if not os.path.exists(path):
        return None
    p = loadmat(path)["P"].reshape(4)

    def above(pts: np.ndarray) -> np.ndarray:
        return pts @ p[:3] + p[3] > 0

    return above


def find_ply(pc_dir: str, scan: int) -> str:
    for cand in (f"mvs{scan:03d}_l3.ply", f"scan{scan}.ply",
                 f"{scan}.ply"):
        path = os.path.join(pc_dir, cand)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no fused cloud for scan {scan} under {pc_dir} "
        f"(tried mvs{scan:03d}_l3.ply / scan{scan}.ply / {scan}.ply)")


def eval_scan(pc_dir: str, gt_dir: str, scan: int, dst: float,
              max_dist: float, margin: float, device=None) -> dict:
    from diffmvs_tpu_torch.fusion.metrics import nn_distances
    from diffmvs_tpu_torch.fusion.ply import read_ply

    pred = np.asarray(read_ply(find_ply(pc_dir, scan))[0], np.float32)
    stl_path = os.path.join(gt_dir, "Points", "stl",
                            f"stl{scan:03d}_total.ply")
    gt = np.asarray(read_ply(stl_path)[0], np.float32)
    pred = reduce_pts(pred, dst)

    keep = load_obs_mask(gt_dir, scan, margin)
    above = load_plane(gt_dir, scan)
    masked = keep is not None and above is not None

    d_pred = nn_distances(pred, gt, device=device)
    if keep is not None:
        d_pred = d_pred[keep(pred)]
    acc = d_pred[d_pred <= max_dist]

    d_gt = nn_distances(gt, pred, device=device)
    if above is not None:
        d_gt = d_gt[above(gt)]
    comp = d_gt[d_gt <= max_dist]

    acc_mean = float(acc.mean()) if acc.size else float("nan")
    comp_mean = float(comp.mean()) if comp.size else float("nan")
    return {
        "scan": scan,
        "acc_mean": acc_mean,
        "acc_median": float(np.median(acc)) if acc.size else float("nan"),
        "comp_mean": comp_mean,
        "comp_median": (float(np.median(comp)) if comp.size
                        else float("nan")),
        "overall": (acc_mean + comp_mean) / 2.0,
        "n_pred": int(pred.shape[0]),
        "n_gt": int(gt.shape[0]),
        "masked": masked,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pc_dir", required=True,
                    help="directory of fused clouds (cli/test.py --outdir/pc)")
    ap.add_argument("--gt_dir", required=True,
                    help="DTU eval data root (Points/stl + ObsMask)")
    ap.add_argument("--scans", type=int, nargs="+", required=True)
    ap.add_argument("--dst", type=float, default=0.2,
                    help="downsample grid (mm), toolbox default 0.2")
    ap.add_argument("--max_dist", type=float, default=20.0)
    ap.add_argument("--margin", type=float, default=10.0,
                    help="ObsMask bounding-box margin (mm)")
    ap.add_argument("--json", default="",
                    help="also write results to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the distances")
    args = ap.parse_args(argv)

    rows = []
    for scan in args.scans:
        r = eval_scan(args.pc_dir, args.gt_dir, scan, args.dst,
                      args.max_dist, args.margin, args.device)
        rows.append(r)
        flag = "" if r["masked"] else "  [UNMASKED: no ObsMask/Plane]"
        print(f"scan{scan:3d}  acc {r['acc_mean']:.4f}  "
              f"comp {r['comp_mean']:.4f}  overall {r['overall']:.4f}"
              f"{flag}")

    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("acc_mean", "comp_mean", "overall")}
    print(f"mean    acc {mean['acc_mean']:.4f}  "
          f"comp {mean['comp_mean']:.4f}  overall {mean['overall']:.4f}")
    result = {"scans": rows, "mean": mean}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
