"""Diffusion-based depth refinement stage (DDIM inference branch).

Counterpart of diffmvs_tpu/models/refine.py (RefineIteration,
RefinementStage.eval_forward). The inference path only: the q_sample
training branch comes with the training part of the port.

Per stage: the residual inverse depth starts from noise (zero when no
generator is given or the stage's noise scale is 0), and a GRU-UNet
denoiser iteratively predicts delta + confidence from local cost volumes.
The hidden state resets for every DDIM time pair. The diffusion state
(delta, inverse depth, confidence) stays float32.

RefinementStage subclasses RefineIteration so that the encoder, the UNet
and the mask head sit directly under the stage, as in the reference's
state_dict (update_block_depth2.encoder.*, .unet.*, .mask.*).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from diffmvs_tpu_torch.models.schedule import DiffusionSchedule
from diffmvs_tpu_torch.models.stages import UpsampleMaskHead, local_cost_volume
from diffmvs_tpu_torch.nn.unet import ConditionEncoder, DiffusionUNet


def noise_like(generator: Optional[torch.Generator], x, scale: float):
    if generator is None or scale == 0.0:
        return torch.zeros_like(x)
    return scale * torch.randn(x.shape, generator=generator, device=x.device,
                               dtype=x.dtype)


class RefineIteration(nn.Module):
    """One GRU-UNet denoising iteration."""

    def __init__(self, unet_dim: int, dim_mults: Tuple[int, ...],
                 hidden_dim: int, context_dim: int, cost_num: int,
                 group_dim: int, depth_interval: float, min_radius: float,
                 max_radius: float):
        super().__init__()
        self.cost_num = cost_num
        self.group_dim = group_dim
        self.depth_interval = depth_interval
        self.min_radius = min_radius
        self.max_radius = max_radius
        self.encoder = ConditionEncoder(
            cost_dim=group_dim * cost_num, num_sample=cost_num,
            hidden_dim=context_dim, out_chs=context_dim)
        self.unet = DiffusionUNet(
            dim=unet_dim, hidden_dim=hidden_dim, input_dim=2 * context_dim,
            dim_mults=dim_mults)

    def iterate(self, hidden, inv_new, delta, confidence, has_conf, context,
                t, inv_depth, features, proj_pairs, depth_min, depth_max,
                view_weights):
        """Returns the next (hidden, inv_new, delta, confidence)."""
        cost, samples = local_cost_volume(
            inv_new, features, proj_pairs, self.depth_interval, depth_min,
            depth_max, self.cost_num, self.group_dim, view_weights,
            confidence=confidence, min_radius=self.min_radius,
            max_radius=self.max_radius, use_confidence=has_conf)
        input_features = self.encoder(inv_new[:, None], samples, cost)
        input_unet = torch.cat([context, input_features], dim=1)
        hidden, update, confidence = self.unet(input_unet, hidden, t)
        confidence = confidence.float()
        delta = delta + update.float()
        inv_new = torch.clamp(inv_depth + delta, 0.0, 1.0)
        delta = inv_new - inv_depth
        return hidden, inv_new, delta, confidence


class RefinementStage(RefineIteration):
    """One diffusion refinement stage (stage_idx in {1, 2})."""

    def __init__(self, unet_dim: int, dim_mults: Tuple[int, ...],
                 hidden_dim: int, context_dim: int, num_sample: int,
                 group_dim: int, depth_interval: float, iters: int,
                 up_ratio: int, schedule: DiffusionSchedule,
                 min_radius: float = 0.2, max_radius: float = 2.0):
        super().__init__(unet_dim, dim_mults, hidden_dim, context_dim,
                         num_sample, group_dim, depth_interval, min_radius,
                         max_radius)
        self.iters = iters
        self.schedule = schedule
        self.mask = UpsampleMaskHead(context_dim, up_ratio)

    def forward(self, inv_depth, hidden, context, features, proj_pairs,
                depth_min, depth_max, view_weights,
                generator: Optional[torch.Generator] = None):
        """DDIM inference. All maps [B, H, W]; hidden/context NCHW.

        Returns (mask_logits, hidden, [inv_depth per iteration],
                 [confidence per iteration]) of the last DDIM time pair.
        """
        b = inv_depth.shape[0]
        sched = self.schedule
        img = noise_like(generator, inv_depth, sched.scale)
        mask = self.mask(context)

        cur_hidden = hidden
        inv_seq, conf_seq = [], []
        for time, time_next in sched.ddim_time_pairs():
            t = torch.full((b,), time, dtype=torch.int32,
                           device=inv_depth.device)
            delta = img
            inv_new = torch.clamp(inv_depth + delta, 0.0, 1.0)
            delta = inv_new - inv_depth
            img = delta

            cur_hidden = hidden                            # reset per pair
            confidence = torch.zeros_like(inv_depth)
            inv_seq, conf_seq = [], []
            for i in range(self.iters):
                cur_hidden, inv_new, delta, confidence = self.iterate(
                    cur_hidden, inv_new, delta, confidence, i > 0, context,
                    t, inv_depth, features, proj_pairs, depth_min,
                    depth_max, view_weights)
                inv_seq.append(inv_new)
                conf_seq.append(confidence)

            if time_next < 0:
                continue
            pred_noise = sched.predict_noise_from_start(img, t, delta)
            sqrt_an, c, sigma = sched.ddim_coeffs(time, time_next)
            noise = noise_like(generator, inv_depth, sched.scale)
            img = delta * float(sqrt_an) + float(c) * pred_noise \
                + float(sigma) * noise

        return mask, cur_hidden, inv_seq, conf_seq
