"""Plane-sweep coordinates (the geometry half of the MVS hot path).

Counterpart of diffmvs_tpu/geometry/warp.py:plane_sweep_coords: project
the reference pixel grid at D depth hypotheses into a source view.
Coordinates are in pixel units (geometry/sampling.py says why that equals
grid_sample(align_corners=True)).

Rounding: lin = r0*x + r1*y + r2 rounds after each operation, then
lin * depth + t is one fused multiply-add (one rounding), the form XLA
emits for the JAX reference. The CUDA kernel in ops/csrc/warp_corr.cu
evaluates the same operations with explicit round-to-nearest intrinsics
and fmaf, so the coordinates agree bit for bit (up to the float64
emulation's double rounding, which differs in rare halfway cases).
"""

from __future__ import annotations

import torch


def plane_sweep_coords(rot, trans, depth_values, x_off: int = 0):
    """Source-view pixel coordinates for each ref pixel x depth hypothesis.

    rot: [B, 3, 3], trans: [B, 3] -- relative projection src <- ref.
    depth_values: [B, D, H, W] metric depths of the hypotheses.
    x_off: the global column of the depths' first column (a width shard's
      offset): ref pixel (y, x) lies at column x + x_off. The float32 of
      an integer below 2^24 is exact, so a shard's coordinates equal the
      unsharded ones' columns bit for bit.
    Returns (x, y): each [B, D, H, W] float32, without gradient.
    """
    b, d, h, w = depth_values.shape
    dev = depth_values.device
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(x_off, x_off + w, dtype=torch.float32, device=dev),
        indexing="ij")
    xg = xs[None]                                          # [1, H, W]
    yg = ys[None]

    def row(i):
        r0 = rot[:, i, 0][:, None, None]
        r1 = rot[:, i, 1][:, None, None]
        r2 = rot[:, i, 2][:, None, None]
        lin = r0 * xg + r1 * yg + r2                       # [B, H, W]
        # fma(lin, depth, t): the float64 product of two float32 values
        # is exact, so one float64 add + one cast emulates the fused op
        t = trans[:, i][:, None, None, None].double()
        return (lin[:, None].double() * depth_values.double() + t).float()

    with torch.no_grad():
        z = row(2)
        z = torch.where(z == 0.0, torch.full_like(z, 1e-8), z)
        x = row(0) / z
        y = row(1) / z
    return x, y
