"""Nearest-neighbour integer upsampling.

Counterpart of diffmvs_tpu/ops/resize.py: F.interpolate(scale_factor=s,
mode='nearest') for integer s replicates each pixel s times.
"""

from __future__ import annotations


def upsample_nearest(x, scale: int, spatial_axes=(1, 2)):
    """Replicate-upsample by integer `scale` along `spatial_axes`.

    Works for [B, H, W], [B, H, W, C], [V, B, H, W] and friends.
    """
    if scale == 1:
        return x
    for ax in spatial_axes:
        x = x.repeat_interleave(scale, dim=ax)
    return x
