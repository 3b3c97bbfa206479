"""RAFT-style learned convex upsampling of depth maps.

Counterpart of diffmvs_tpu/geometry/upsample.py: softmax over the 9
neighbours x ratio^2 sub-pixel positions; the upsampled value is a convex
combination of the zero-padded 3x3 neighbourhood of the coarse map
(F.unfold patch order: k = ky*3 + kx).
"""

from __future__ import annotations

import torch.nn.functional as F


def upsample_with_mask(depth, mask_logits, ratio):
    """Convex upsample.

    depth: [B, H, W] coarse map (inverse depth in the model).
    mask_logits: [B, 9*ratio*ratio, H, W] (NCHW; channel k*ratio^2 + r)
      from the mask head, already scaled by 0.25.
    Returns [B, H*ratio, W*ratio].
    """
    b, h, w = depth.shape
    mask = mask_logits.reshape(b, 9, ratio * ratio, h, w).softmax(dim=1)
    patches = F.unfold(depth[:, None], 3, padding=1).reshape(b, 9, 1, h, w)
    up = (mask * patches).sum(dim=1)                       # [B, r*r, H, W]
    up = up.reshape(b, ratio, ratio, h, w).permute(0, 3, 1, 4, 2)
    return up.reshape(b, h * ratio, w * ratio)
