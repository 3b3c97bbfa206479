"""Soft-argmax depth regression + windowed photometric confidence.

Counterpart of diffmvs_tpu/ops/softargmax.py: softmax over depth ->
expectation index -> normalized inverse depth; the photometric confidence
is the probability mass of the 4 bins [floor(idx)-1, floor(idx)+2], taken
as the difference of two reads of the cumulative sum along depth.
"""

from __future__ import annotations

import torch


def depth_regression_with_confidence(prob_logits):
    """prob_logits: [B, D, H, W] regularized cost volume (pre-softmax).

    Returns (normalized_inv_depth [B,H,W] in [0,1],
             photometric_confidence [B,H,W] in [0,1], without gradient).
    """
    b, d, h, w = prob_logits.shape
    prob = prob_logits.softmax(dim=1)

    idx_values = torch.arange(d, dtype=prob.dtype,
                              device=prob.device).reshape(1, d, 1, 1)
    index = (idx_values * prob).sum(dim=1)                 # [B,H,W]
    normalized = index / (d - 1.0)

    with torch.no_grad():
        csum = prob.cumsum(dim=1)                          # inclusive
        i0 = index.to(torch.int64).clamp(0, d - 1)
        hi = (i0 + 2).clamp(0, d - 1)                      # window end
        lo = i0 - 2                                        # window start - 1
        hi_val = csum.gather(1, hi[:, None])[:, 0]
        lo_val = csum.gather(1, lo.clamp(min=0)[:, None])[:, 0]
        lo_val = torch.where(lo >= 0, lo_val, torch.zeros_like(lo_val))
        confidence = hi_val - lo_val
    return normalized, confidence
