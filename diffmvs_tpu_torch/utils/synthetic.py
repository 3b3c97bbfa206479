"""Synthetic scene inputs and training batches (smoke runs, timing, dry
runs), numpy only.

synthetic_inputs is a copy of diffmvs_tpu/utils/synthetic.py; the
training batch builds its GT as the JAX package's tests and bench do.
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


def synthetic_train_batch(b, v, h, w, numdepth, seed=0, dmin=4.0, dmax=10.0):
    """synthetic_inputs plus a training target: GT depth (a slanted plane
    in the depth range) and all-ones masks at the 4 scales (1/8, 1/4,
    1/2, 1), as {"imgs", "proj_matrices", "depth_values", "depth",
    "mask"} numpy arrays."""
    imgs, projs, depth_values = synthetic_inputs(b, v, h, w, numdepth, dmin,
                                                 dmax, seed)
    _, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                        indexing="ij")
    gt = (dmin + (dmax - dmin) * (0.3 + 0.4 * xs)).astype(np.float32)
    gt = np.broadcast_to(gt, (b, h, w))
    depth = {f"stage{i + 1}": gt[:, ::s, ::s].copy()
             for i, s in enumerate((8, 4, 2, 1))}
    mask = {k: np.ones_like(d) for k, d in depth.items()}
    return {"imgs": imgs, "proj_matrices": projs,
            "depth_values": depth_values, "depth": depth, "mask": mask}


def synthetic_train_overrides(cfg, b, h, w, seed=0):
    """{stage_idx: (t [B] int64, noise [B, Hs, Ws] float32)} for the
    refinement stages of cfg (a ModelConfig), drawn with numpy: the
    timesteps and scaled noise a training forward would draw, fixed so
    two runs can take the same ones (CasDiffMVS.forward's
    train_overrides)."""
    rng = np.random.RandomState(seed)
    out = {}
    for s in (1, 2):
        if cfg.stage_iters[s] == 0:
            continue
        f = 8 // 2 ** s
        t = rng.randint(0, cfg.timesteps[s], size=(b,)).astype(np.int64)
        noise = (cfg.scale[s] * rng.randn(b, h // f, w // f)).astype(
            np.float32)
        out[s] = (t, noise)
    return out
