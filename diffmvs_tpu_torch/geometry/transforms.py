"""Inverse-depth transforms, hypothesis sampling, relative projection.

Counterpart of diffmvs_tpu/geometry/transforms.py. All depth state inside
the network lives in normalized inverse-depth space ("disp" in [0, 1]);
metric depth only appears at stage boundaries.
"""

from __future__ import annotations

import torch


def _mm(a, b):
    """a @ b for small float32 matrices, as a chain of fused multiply-adds
    over the inner index in ascending order: the rounding of the JAX
    reference's full-precision dot on the CPU, so the projections agree
    bit for bit. Emulated in float64, where the product of two float32
    values is exact (no TF32 either way)."""
    a64, b64 = a.double(), b.double()
    acc = (a64[..., :, :1] * b64[..., :1, :]).float()
    for j in range(1, a.shape[-1]):
        acc = (a64[..., :, j:j + 1] * b64[..., j:j + 1, :]
               + acc.double()).float()
    return acc


def disp_to_depth(disp, min_depth, max_depth):
    """Normalized inverse depth in [0,1] -> (scaled_disp, metric depth).

    min_depth/max_depth broadcast against disp (typically [B,1,1,1]).
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    scaled_disp = torch.clamp(scaled_disp, min=1e-6)
    return scaled_disp, 1.0 / scaled_disp


def depth_to_disp(depth, min_depth, max_depth):
    """Metric depth -> normalized inverse depth in [0,1]."""
    scaled_disp = 1.0 / depth
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (scaled_disp - min_disp) / (max_disp - min_disp)


def depth_range_samples(cur_depth, ndepth, interval, confidence=None,
                        min_radius=0.2, max_radius=2.0,
                        use_confidence: bool = True):
    """Sample `ndepth` new inverse-depth hypotheses around `cur_depth`.

    cur_depth: [B, H, W] current normalized inverse depth.
    confidence: optional [B, H, W]; when given (and use_confidence), the
      search radius adapts as r = r_min + (1 - conf) * (r_max - r_min) with
      r_min = min_radius * r0, r_max = max_radius * r0,
      r0 = ndepth//2 * interval.
    use_confidence: False gives the fixed radius r0 even when a confidence
      is passed (the first refinement iteration has no confidence yet).
    Returns [B, ndepth, H, W] clipped to [0, 1].
    """
    radius0 = (ndepth // 2) * interval
    if confidence is None or not use_confidence:
        radius = radius0
    else:
        r_min = min_radius * radius0
        r_max = max_radius * radius0
        radius = r_min + (1.0 - confidence) * (r_max - r_min)
    lo = cur_depth - radius
    hi = cur_depth + radius

    step = (hi - lo) / (ndepth - 1)                       # [B, H, W]
    idx = torch.arange(ndepth, dtype=cur_depth.dtype,
                       device=cur_depth.device).reshape(1, ndepth, 1, 1)
    samples = lo[:, None] + idx * step[:, None]
    return torch.clamp(samples, 0.0, 1.0)


def invert_intrinsics(k):
    """Closed-form inverse of an upper-triangular 3x3 intrinsic matrix.

    k: [..., 3, 3] with rows [[fx, s, cx], [0, fy, cy], [0, 0, 1]].
    Exact (no cancellation), unlike LU in float32.
    """
    fx = k[..., 0, 0]
    s = k[..., 0, 1]
    cx = k[..., 0, 2]
    fy = k[..., 1, 1]
    cy = k[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    inv_fx = 1.0 / fx
    inv_fy = 1.0 / fy
    row0 = torch.stack([inv_fx, -s * inv_fx * inv_fy,
                        (s * cy - cx * fy) * inv_fx * inv_fy], dim=-1)
    row1 = torch.stack([zero, inv_fy, -cy * inv_fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def invert_rigid(ext):
    """Exact inverse of a rigid 4x4 [[R, t], [0, 1]]: [[R^T, -R^T t], [0, 1]]."""
    r = ext[..., :3, :3]
    t = ext[..., :3, 3:4]
    rt = r.transpose(-1, -2)
    top = torch.cat([rt, -_mm(rt, t)], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])              # no host copy
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def relative_projection(src_pair, ref_pair):
    """Relative projection src <- ref as (rot [...,3,3], trans [...,3]).

    src_pair/ref_pair: [..., 2, 4, 4] (extrinsic, intrinsic) stacks.
    Equals compose(src) @ inverse(compose(ref)), built from the exact rigid
    and analytic intrinsic inverses, avoiding the float32 cancellation of
    a generic 4x4 LU (about 0.1 px at f=1000 scales).
    """
    k_src = src_pair[..., 1, :3, :3]
    k_ref = ref_pair[..., 1, :3, :3]
    e_src = src_pair[..., 0, :, :]
    e_ref = ref_pair[..., 0, :, :]

    e_rel = _mm(e_src, invert_rigid(e_ref))               # [..., 4, 4]
    r = e_rel[..., :3, :3]
    t = e_rel[..., :3, 3:4]

    k_ref_inv = invert_intrinsics(k_ref)
    rot = _mm(_mm(k_src, r), k_ref_inv)
    trans = _mm(k_src, t)[..., 0]
    return rot, trans
