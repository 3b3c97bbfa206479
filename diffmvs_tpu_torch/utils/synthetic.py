"""Synthetic scene inputs (smoke runs, timing, dry runs).

A copy of diffmvs_tpu/utils/synthetic.py:synthetic_inputs (numpy only).
"""

from __future__ import annotations

import numpy as np


def synthetic_inputs(b, v, h, w, numdepth, dmin=4.0, dmax=10.0, seed=0):
    """Random images + plausible camera arc + inverse-depth linspace,
    matching the model's forward contract (numpy arrays)."""
    rng = np.random.RandomState(seed)
    focal = 1.2 * w
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    cams = []
    for i in range(v):
        th = 0.0 if i == 0 else 0.04 * i
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                              [-np.sin(th), 0, np.cos(th)]], np.float32)
        e[:3, 3] = [0.25 * i, 0.02 * i, 0.0]
        m = np.zeros((2, 4, 4), np.float32)
        m[0] = e
        m[1, :3, :3] = k
        cams.append(m)
    cams = np.stack(cams)
    projs = {}
    for stage, s in (("stage1", 0.125), ("stage2", 0.25), ("stage3", 0.5),
                     ("stage4", 1.0)):
        mm = cams.copy()
        mm[:, 1, :2, :] = cams[:, 1, :2, :] * s
        projs[stage] = np.broadcast_to(mm, (b,) + mm.shape).copy()
    imgs = rng.rand(b, v, h, w, 3).astype(np.float32)
    depth_values = np.broadcast_to(
        np.linspace(1 / dmax, 1 / dmin, numdepth, dtype=np.float32),
        (b, numdepth)).copy()
    return imgs, projs, depth_values
