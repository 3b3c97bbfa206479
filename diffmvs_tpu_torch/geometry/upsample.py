"""RAFT-style learned convex upsampling of depth maps.

Counterpart of diffmvs_tpu/geometry/upsample.py: softmax over the 9
neighbours x ratio^2 sub-pixel positions; the upsampled value is a convex
combination of the zero-padded 3x3 neighbourhood of the coarse map
(F.unfold patch order: k = ky*3 + kx). On a width shard the
neighbourhood's columns beyond the shard come from the neighbours (a halo
of one column, parallel/spatial.py).
"""

from __future__ import annotations

import torch.nn.functional as F

from diffmvs_tpu_torch.parallel import spatial


def upsample_with_mask(depth, mask_logits, ratio, space=None):
    """Convex upsample.

    depth: [B, H, W] coarse map (inverse depth in the model).
    mask_logits: [B, 9*ratio*ratio, H, W] (NCHW; channel k*ratio^2 + r)
      from the mask head, already scaled by 0.25.
    space: a spatial.SpaceGroup when the maps are this rank's columns of
      a width-sharded map.
    Returns [B, H*ratio, W*ratio].
    """
    b, h, w = depth.shape
    mask = mask_logits.reshape(b, 9, ratio * ratio, h, w).softmax(dim=1)
    if space is None:
        patches = F.unfold(depth[:, None], 3, padding=1)
    else:
        patches = F.unfold(spatial.halo(depth[:, None], 1, 1, space), 3,
                           padding=(1, 0))
    patches = patches.reshape(b, 9, 1, h, w)
    up = (mask * patches).sum(dim=1)                       # [B, r*r, H, W]
    up = up.reshape(b, ratio, ratio, h, w).permute(0, 3, 1, 4, 2)
    return up.reshape(b, h * ratio, w * ratio)
