"""Stage heads: plane-sweep depth initialization + local cost volumes.

Counterpart of diffmvs_tpu/models/stages.py. Feature maps for the warp
arrive per view as NHWC [B, H, W, C] contiguous tensors (the layout the
kernel reads); everything else is NCHW / NCDHW.

Dtypes, as in the JAX package: each correlation volume comes from the warp
in float32 and is rounded to the features' dtype (diffmvs_tpu/models/
stages.py:99,176), the view weights are float32 (PixelViewWeight), so the
view-weighted aggregate promotes to float32; CostRegNet and the mask head
compute in the model's dtype, and the soft-argmax runs in float32.

On a width shard (parallel/spatial.py) ref's map holds this rank's
columns, each source map the full width (gathered once per stage by the
caller), and x_off is the global column of ref's first column at the
stage's stride: the warp computes the coordinates there.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffmvs_tpu_torch.geometry.transforms import (
    depth_range_samples,
    disp_to_depth,
)
from diffmvs_tpu_torch.nn.costreg import CostRegNet, PixelViewWeight
from diffmvs_tpu_torch.nn.layers import Conv2d
from diffmvs_tpu_torch.ops.correlation import (
    aggregate_views,
    warp_and_correlate,
)
from diffmvs_tpu_torch.ops.softargmax import depth_regression_with_confidence


class UpsampleMaskHead(nn.Sequential):
    """conv3x3 -> ReLU -> conv1x1(9*r*r) mask head, scaled by 0.25."""

    def __init__(self, in_ch: int, ratio: int, dtype=torch.float32):
        super().__init__(Conv2d(in_ch, 64, 3, padding=1, dtype=dtype),
                         nn.ReLU(),
                         Conv2d(64, ratio * ratio * 9, 1, dtype=dtype))

    def forward(self, context):
        return 0.25 * super().forward(context)


class InitialStage(nn.Module):
    """Stage-0 head at 1/8 resolution: full plane sweep + 3D regularization.

    Group correlation per source view, view-weighted aggregation (weights
    from PixelViewWeight), CostRegNet regularization, soft-argmax depth and
    windowed photometric confidence, plus the convex-upsample mask.
    """

    def __init__(self, context_dim: int, group_dim: int, up_ratio: int = 2,
                 dtype=torch.float32, warp=None):
        super().__init__()
        self.group_dim = group_dim
        self.warp = warp
        self.pixel_view_weight = PixelViewWeight(group_dim)
        self.cost_regularization = CostRegNet(group_dim, base_channels=8,
                                              dtype=dtype)
        self.mask = UpsampleMaskHead(context_dim, up_ratio, dtype)

    def forward(self, features, context, proj_pairs, depth_values,
                scale_inv_depth, x_off: int = 0):
        """
        features: list of V feature maps [B, H, W, C] (NHWC, ref first).
        context: [B, Cctx, H, W] (relu'd stage-1 context).
        proj_pairs: [B, V, 2, 4, 4] (extrinsic, intrinsic) stacks.
        depth_values: [B, D, H, W] metric hypothesis depths.
        scale_inv_depth: fn(normalized inv depth) -> (scaled_disp, depth).
        x_off: ref's column offset on a width shard (0: the whole map).
        Returns (mask_logits [B, 9*r*r, H, W], inv_depth [B,H,W],
                 depth [B,H,W], view_weights [V-1,B,H,W],
                 photometric_confidence [B,H,W]).
        """
        mask_logits = self.mask(context)
        ref_fea = features[0]
        cor_list = [
            (self.warp or warp_and_correlate)(
                src_fea, ref_fea, proj_pairs[:, i + 1], proj_pairs[:, 0],
                depth_values, self.group_dim, x_off
            ).to(ref_fea.dtype)                            # [B,D,H,W,G]
            for i, src_fea in enumerate(features[1:])]
        cor_feats = torch.stack(cor_list)                  # [V-1,B,D,H,W,G]
        view_weights = self.pixel_view_weight.views(cor_feats)  # [V-1,B,H,W]
        agg = aggregate_views(cor_feats, view_weights)
        prob_logits = self.cost_regularization(agg.permute(0, 4, 1, 2, 3))
        normalized, confidence = depth_regression_with_confidence(
            prob_logits.float())
        depth = scale_inv_depth(normalized)[1]
        return mask_logits, normalized, depth, view_weights, confidence


def local_cost_volume(inv_depth, features, proj_pairs, depth_interval,
                      depth_min, depth_max, cost_num, group_dim,
                      view_weights, confidence=None, min_radius=0.2,
                      max_radius=2.0, use_confidence: bool = True,
                      x_off: int = 0, warp=None):
    """Per-iteration local cost volume around the current inverse depth.

    Sample cost_num hypotheses (confidence-adaptive radius), warp every
    source view, group-correlate, aggregate with the frozen stage-1 view
    weights, flatten depth into channels as channel = g*D + d.

    inv_depth: [B, H, W] normalized inverse depth.
    features: list of V NHWC feature maps [B, H, W, C] (ref first).
    view_weights: [V-1, B, H, W] (already upsampled to this stage's res).
    x_off: ref's column offset on a width shard (0: the whole map).
    warp: the warp + correlation; None for ops/correlation.
      warp_and_correlate (the kernels on CUDA tensors).
    Returns (cost [B, G*cost_num, H, W], samples [B, cost_num, H, W]).
    """
    if cost_num > 1:
        samples = depth_range_samples(
            inv_depth, cost_num, depth_interval, confidence,
            min_radius, max_radius, use_confidence)        # [B,D,H,W]
    else:
        samples = inv_depth[:, None]

    b = inv_depth.shape[0]
    depth_hyp = disp_to_depth(samples, depth_min.reshape(b, 1, 1, 1),
                              depth_max.reshape(b, 1, 1, 1))[1]

    ref_fea = features[0]
    cor_list = [
        (warp or warp_and_correlate)(
            src_fea, ref_fea, proj_pairs[:, i + 1], proj_pairs[:, 0],
            depth_hyp, group_dim, x_off).to(ref_fea.dtype)
        for i, src_fea in enumerate(features[1:])]
    agg = aggregate_views(torch.stack(cor_list), view_weights)  # [B,D,H,W,G]
    _, d, h, w, g = agg.shape
    cost = agg.permute(0, 4, 1, 2, 3).reshape(b, g * d, h, w)
    return cost, samples
