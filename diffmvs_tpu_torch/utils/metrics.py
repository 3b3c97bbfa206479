"""Depth metrics + scalar meters.

Counterpart of diffmvs_tpu/utils/metrics.py: per-image masked means,
averaged over the batch, written as weighted means (no boolean indexing,
so nothing waits for the host). On a width shard, `reduce` sums each
image's numerator and count over the space group first.
"""

from __future__ import annotations

from typing import Dict

import torch


def _per_image_masked_mean(value, mask, reduce=None):
    """value, mask: [B, H, W] -> mean over batch of per-image masked means.
    reduce: None, or a function summing a tensor over the other shards of
    these images (parallel/spatial.py)."""
    m = mask.to(value.dtype)
    sums = torch.stack([(value * m).sum(dim=(1, 2)), m.sum(dim=(1, 2))])
    if reduce is not None:
        sums = reduce(sums)
    return (sums[0] / sums[1].clamp_min(1.0)).mean()


def abs_depth_error(depth_est, depth_gt, mask, reduce=None):
    """Mean absolute depth error over masked pixels, per image then batch."""
    return _per_image_masked_mean((depth_est - depth_gt).abs(), mask, reduce)


def threshold_error(depth_est, depth_gt, mask, thres):
    """Fraction of masked pixels with |error| > thres."""
    err = ((depth_est - depth_gt).abs() > thres).to(torch.float32)
    return _per_image_masked_mean(err, mask)


class DictAverageMeter:
    """Running mean of scalar dicts (host-side)."""

    def __init__(self):
        self.data: Dict[str, float] = {}
        self.count = 0

    def update(self, new_input: Dict[str, float]):
        self.count += 1
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}
