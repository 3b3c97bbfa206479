"""Multi-stage confidence-weighted loss in normalized inverse-depth space.

Counterpart of diffmvs_tpu/models/loss.py. The prediction list interleaves
stage outputs
  DiffMVS:    [init(1/8), up(1/4), iter1..K(1/4), up(full)]
  CasDiffMVS: [init, up, iters(1/4), up(1/2), iters(1/2), up(full)]
Diffusion iterations carry an estimated confidence c and use
|e|/(1-c) + w*log(1-c); other entries use plain masked L1. Losses are
weighted exponentially, loss_rate^(len-i-1). Masks become weighted means
(masked_mean), and invalid GT (<= 1e-4) is replaced by depth_max before
the inverse transform.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from diffmvs_tpu_torch.geometry.transforms import depth_to_disp


def loss_layout(stage_iters: Sequence[int]) -> Tuple[List[int], List[bool]]:
    """(stage_id, conf_flag) sequences matching the prediction list."""
    i0, i1, i2 = stage_iters
    if i2 == 0:  # DiffMVS
        stage_id = [1] * i0 + [2] * (i1 + 1) + [4]
        conf_flag = [False] * (i0 + 1) + [True] * i1 + [False]
    else:        # CasDiffMVS
        stage_id = [1] * i0 + [2] * (i1 + 1) + [3] * (i2 + 1) + [4]
        conf_flag = ([False] * (i0 + 1) + [True] * i1 + [False]
                     + [True] * i2 + [False])
    return stage_id, conf_flag


def masked_mean(x, mask, den=None):
    """(x * mask).sum() over den, by default the mask's count (>= 1)."""
    m = mask.to(x.dtype)
    if den is None:
        den = m.sum().clamp_min(1.0)
    return (x * m).sum() / den


def compute_inverse_loss(depths, confs, depth_gt, mask, depth_values,
                         stage_iters, loss_rate=0.9, conf_weight=0.05,
                         denominators=None):
    """
    depths: list of [B, Hs, Ws] metric depth predictions (model output).
    confs: list of [B, Hs, Ws] confidences for diffusion iterations.
    depth_gt / mask: {stage1..4: [B, Hs, Ws]}.
    depth_values: [B, ND] inverse-depth linspace.
    denominators: optional {stage1..4: scalar} replacing each mask's count
      in the masked means (the data-parallel step's global counts).
    Returns (total_loss, {"l0".."lN": plain masked L1 per entry}).
    """
    stage_id, conf_flag = loss_layout(stage_iters)
    if len(depths) != len(stage_id):
        raise ValueError(f"prediction list length {len(depths)} != layout "
                         f"{len(stage_id)}")

    disp_min = depth_values[:, 0][:, None, None]
    disp_max = depth_values[:, -1][:, None, None]
    depth_max = 1.0 / disp_min
    depth_min = 1.0 / disp_max

    total = 0.0
    loss_dict: Dict[str, torch.Tensor] = {}
    conf_iter = 0
    n = len(depths)
    for i, depth_est in enumerate(depths):
        est = depth_to_disp(depth_est, depth_min, depth_max)

        gt = depth_gt[f"stage{stage_id[i]}"]
        gt = torch.where(gt > 1e-4, gt, depth_max.expand_as(gt))
        gt = depth_to_disp(gt, depth_min, depth_max)

        m = mask[f"stage{stage_id[i]}"] > 0.5
        den = (None if denominators is None
               else denominators[f"stage{stage_id[i]}"])
        abs_err = (est - gt).abs()

        if conf_flag[i]:
            confidence = confs[conf_iter]
            conf_iter += 1
            uncertainty = (1.0 - confidence).clamp_min(1e-6)
            term = abs_err / uncertainty + conf_weight * torch.log(uncertainty)
            loss_i = masked_mean(term, m, den)
        else:
            loss_i = masked_mean(abs_err, m, den)

        loss_dict[f"l{i}"] = masked_mean(abs_err.detach(), m, den)
        total = total + (loss_rate ** (n - i - 1)) * loss_i

    return total, loss_dict
