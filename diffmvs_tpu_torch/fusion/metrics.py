"""Point-cloud quality metrics: DTU-style accuracy/completeness + F-score.

Counterpart of diffmvs_tpu/fusion/metrics.py:

  accuracy      mean / median distance from reconstructed points to the GT
                cloud (DTU "acc", lower is better), with the toolbox's
                outlier cutoff (distances > max_dist are excluded).
  completeness  mean / median distance from GT points to the reconstruction
                (DTU "comp").
  overall       (acc_mean + comp_mean) / 2, the DTU headline number.
  precision/recall/f_score
                fraction of points within tau of the other cloud, both
                directions, and their harmonic mean (the Tanks&Temples
                F-score family).

Nearest neighbours on the card: chunks of query points against the whole
target, |a - b|^2 = |a|^2 + |b|^2 - 2 a.b with the cross term as one
float32 matmul (TF32 off) per chunk, as the JAX package computes it. The
expansion only shortlists the 8 nearest target points; their distances
are then taken directly from the differences of the points and the least
one kept, so the result carries no cancellation error (at DTU's
millimetre coordinates the expansion alone is off by ~0.1 mm for
coincident points, and can rank a near tie wrongly). Exact, not
approximate; no KD-tree. The entry points take device=None, meaning CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from diffmvs_tpu_torch.fusion.fuse import fusion_device

_CHUNK = 2048
_MAX_D2 = 1 << 28          # elements of one chunk's distance matrix (1 GiB)
_SHORTLIST = 8             # candidates measured exactly per query point


def nn_distances(query, target, chunk: int = _CHUNK, device=None):
    """Distance from each query point to its nearest target point.

    query: [N, 3]; target: [M, 3] float arrays. Returns [N] float32
    numpy. A chunk holds at most `chunk` query points, fewer where the
    [chunk, M] distance matrix would pass 1 GiB.
    """
    dev = fusion_device(device)
    q = torch.as_tensor(np.asarray(query, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(target, np.float32), device=dev)
    out = torch.empty(q.shape[0], dtype=torch.float32, device=dev)
    t_sq = (t * t).sum(1)                                       # [M]
    chunk = max(1, min(chunk, _MAX_D2 // max(t.shape[0], 1)))
    for i in range(0, q.shape[0], chunk):
        qc = q[i:i + chunk]
        d2 = (qc * qc).sum(1, keepdim=True) + t_sq[None] - 2.0 * (qc @ t.T)
        cand = d2.topk(min(_SHORTLIST, t.shape[0]), dim=1,
                       largest=False).indices                   # [c, k]
        out[i:i + chunk] = (qc[:, None] - t[cand]).norm(dim=2).amin(1)
    return out.cpu().numpy()


def accuracy_completeness(pred, gt, max_dist: float = 20.0,
                          tau: float = 0.5, chunk: int = _CHUNK,
                          device=None):
    """DTU acc/comp + T&T-style precision/recall/F-score for two clouds.

    pred: [N, 3] reconstructed points; gt: [M, 3] ground-truth points.
    max_dist: outlier cutoff for the acc/comp means (the DTU toolbox uses
    20 mm); tau: inlier threshold for precision/recall/F-score.
    Returns a dict of python floats.
    """
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    if pred.size == 0 or gt.size == 0:
        nanable = float("nan")
        return {"acc_mean": nanable, "acc_median": nanable,
                "comp_mean": nanable, "comp_median": nanable,
                "overall": nanable, "precision": 0.0, "recall": 0.0,
                "f_score": 0.0}

    d_pred = nn_distances(pred, gt, chunk, device)
    d_gt = nn_distances(gt, pred, chunk, device)

    acc = d_pred[d_pred <= max_dist]
    comp = d_gt[d_gt <= max_dist]
    acc_mean = float(acc.mean()) if acc.size else float("nan")
    comp_mean = float(comp.mean()) if comp.size else float("nan")
    precision = float((d_pred < tau).mean())
    recall = float((d_gt < tau).mean())
    f_score = (2 * precision * recall / (precision + recall)
               if precision + recall > 0 else 0.0)
    return {
        "acc_mean": acc_mean,
        "acc_median": float(np.median(acc)) if acc.size else float("nan"),
        "comp_mean": comp_mean,
        "comp_median": float(np.median(comp)) if comp.size else float("nan"),
        "overall": (acc_mean + comp_mean) / 2.0,
        "precision": precision,
        "recall": recall,
        "f_score": f_score,
    }


def sample_mesh_plane(z: float, x_range, y_range, step: float):
    """Uniform GT sample grid of the plane z = const (synthetic-scene GT)."""
    xs = np.arange(x_range[0], x_range[1] + 1e-6, step, dtype=np.float32)
    ys = np.arange(y_range[0], y_range[1] + 1e-6, step, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    return np.stack([gx.ravel(), gy.ravel(),
                     np.full(gx.size, z, np.float32)], axis=1)
