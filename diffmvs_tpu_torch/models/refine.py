"""Diffusion-based depth refinement stage.

Counterpart of diffmvs_tpu/models/refine.py (RefineIteration,
RefinementStage.train_forward / eval_forward).

Per stage: the residual inverse depth is diffused (training: q_sample of
the GT residual at a random timestep; inference: DDIM over the sampling
time pairs, starting from noise that is zero when no generator is given
or the stage's noise scale is 0), and a GRU-UNet denoiser iteratively
predicts delta + confidence from local cost volumes. The hidden state
resets for every DDIM time pair. The diffusion state (delta, inverse
depth, confidence) stays float32 and is detached at the start of every
iteration, as in the reference (a no-op at inference), whatever the
conv stacks' compute dtype (`dtype`); the GRU hidden state keeps the dtype
of HiddenInit's output.

remat=True recomputes each iteration in the backward pass (the JAX
package's nn.remat(RefineIteration)): only an iteration's inputs are kept
for the backward, so the stage's activation memory no longer grows with
its iterations.

On a width shard (parallel/spatial.py) the maps hold this rank's columns
(`cols`, a spatial.Columns at the stage's resolution): every noise is
drawn at the full width and sliced to them, so it is the unsharded draw,
and the warp takes their offset.

RefinementStage subclasses RefineIteration so that the encoder, the UNet
and the mask head sit directly under the stage, as in the reference's
state_dict (update_block_depth2.encoder.*, .unet.*, .mask.*).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from diffmvs_tpu_torch.models.schedule import DiffusionSchedule
from diffmvs_tpu_torch.models.stages import UpsampleMaskHead, local_cost_volume
from diffmvs_tpu_torch.nn.unet import ConditionEncoder, DiffusionUNet
from diffmvs_tpu_torch.utils import profiling


def noise_like(generator: Optional[torch.Generator], x, scale: float,
               cols=None):
    """scale * N(0, 1) shaped like x [..., W] (zeros, and no draw, without
    a generator or at scale 0); with cols (x holds columns cols of a map
    cols.width wide), drawn at the full width and sliced."""
    if generator is None or scale == 0.0:
        return torch.zeros_like(x)
    shape = x.shape if cols is None else x.shape[:-1] + (cols.width,)
    noise = scale * torch.randn(shape, generator=generator, device=x.device,
                                dtype=x.dtype)
    return noise if cols is None else cols.take(noise)


def draw_t_noise(schedule: DiffusionSchedule, like, generator, cols=None):
    """The training branch's draw from `generator`, in its order: the
    timesteps [B], then the noise shaped like `like` [B, H, W] (zeros, and
    no draw, where the schedule's noise scale is 0; cols as noise_like's)."""
    t = torch.randint(0, schedule.timesteps, (like.shape[0],),
                      generator=generator, device=like.device)
    return t, noise_like(generator, like, schedule.scale, cols)


class RefineIteration(nn.Module):
    """One GRU-UNet denoising iteration."""

    def __init__(self, unet_dim: int, dim_mults: Tuple[int, ...],
                 hidden_dim: int, context_dim: int, cost_num: int,
                 group_dim: int, depth_interval: float, min_radius: float,
                 max_radius: float, dtype=torch.float32, warp=None):
        super().__init__()
        self.warp = warp
        self.cost_num = cost_num
        self.group_dim = group_dim
        self.depth_interval = depth_interval
        self.min_radius = min_radius
        self.max_radius = max_radius
        self.encoder = ConditionEncoder(
            cost_dim=group_dim * cost_num, num_sample=cost_num,
            hidden_dim=context_dim, out_chs=context_dim, dtype=dtype)
        self.unet = DiffusionUNet(
            dim=unet_dim, hidden_dim=hidden_dim, input_dim=2 * context_dim,
            dim_mults=dim_mults, dtype=dtype)

    def iterate(self, hidden, inv_new, delta, confidence, has_conf, context,
                t, inv_depth, features, proj_pairs, depth_min, depth_max,
                view_weights, x_off=0):
        """Returns the next (hidden, inv_new, delta, confidence); the last
        three float32 whatever the compute dtype."""
        delta = delta.detach()
        confidence = confidence.detach()
        inv_new = inv_new.detach()
        cost, samples = local_cost_volume(
            inv_new, features, proj_pairs, self.depth_interval, depth_min,
            depth_max, self.cost_num, self.group_dim, view_weights,
            confidence=confidence, min_radius=self.min_radius,
            max_radius=self.max_radius, use_confidence=has_conf,
            x_off=x_off, warp=self.warp)
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
                 min_radius: float = 0.2, max_radius: float = 2.0,
                 remat: bool = False, dtype=torch.float32, warp=None):
        super().__init__(unet_dim, dim_mults, hidden_dim, context_dim,
                         num_sample, group_dim, depth_interval, min_radius,
                         max_radius, dtype, warp)
        self.iters = iters
        self.schedule = schedule
        self.remat = remat
        self.mask = UpsampleMaskHead(context_dim, up_ratio, dtype)

    def step(self, *args):
        """iterate(*args), under remat recomputed in the backward pass.

        Recomputing is exact: an iteration draws no random numbers (the
        timesteps and noise are drawn before the loop) and holds no
        BatchNorm (its norms are GroupNorms, with no running statistics),
        so the second run neither changes the noise nor updates any
        statistic twice."""
        profiling.count("refine.iterations")
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self.iterate, *args, use_reentrant=False)
        return self.iterate(*args)

    def forward(self, inv_depth, hidden, context, features, proj_pairs,
                depth_min, depth_max, view_weights,
                generator: Optional[torch.Generator] = None,
                gt_inv_depth=None, inv_init_depth=None, train: bool = False,
                t_noise=None, cols=None):
        """All maps [B, H, W]; hidden/context NCHW. train=True runs the
        q_sample training branch, else DDIM inference. cols: the maps'
        columns on a width shard (a spatial.Columns), None for whole maps.

        Returns (mask_logits, hidden, [inv_depth per iteration],
                 [confidence per iteration]); at inference, those of the
        last DDIM time pair.
        """
        if train:
            return self.train_forward(
                inv_depth, hidden, context, features, proj_pairs, depth_min,
                depth_max, view_weights, gt_inv_depth, inv_init_depth,
                generator=generator, t_noise=t_noise, cols=cols)
        return self.eval_forward(inv_depth, hidden, context, features,
                                 proj_pairs, depth_min, depth_max,
                                 view_weights, generator=generator,
                                 cols=cols)

    def train_forward(self, inv_depth, hidden, context, features,
                      proj_pairs, depth_min, depth_max, view_weights,
                      gt_inv_depth, inv_init_depth,
                      generator: Optional[torch.Generator] = None,
                      t_noise=None, cols=None):
        """Training branch: the iterations denoise q_sample(GT residual).

        gt_inv_depth: [B, H, W] normalized inverse GT (inf where the GT is
          0, replaced by inv_init_depth, the detached initial estimate).
        t_noise: optional (t [B], noise [B, H, W]) replacing the draw from
          `generator` (the seam that lets two implementations take the same
          timesteps and noise); on a width shard, this rank's columns of
          the noise.
        """
        dev = inv_depth.device
        sched = self.schedule
        gt_inv_depth = torch.where(torch.isinf(gt_inv_depth), inv_init_depth,
                                   gt_inv_depth)
        gt_delta = (gt_inv_depth - inv_depth).detach()
        if t_noise is not None:
            t = torch.as_tensor(t_noise[0], device=dev).long()
            noise = torch.as_tensor(t_noise[1], dtype=gt_delta.dtype,
                                    device=dev)
        elif generator is not None:
            t, noise = draw_t_noise(sched, gt_delta, generator, cols)
        else:
            raise ValueError("the training branch draws its timesteps and "
                             "noise from a generator: pass one, or t_noise")

        delta = sched.q_sample(gt_delta, t, noise)
        inv_new = torch.clamp(inv_depth + delta, 0.0, 1.0)
        delta = inv_new - inv_depth
        confidence = torch.zeros_like(inv_depth)
        cur_hidden = hidden
        x_off = 0 if cols is None else cols.start
        inv_seq, conf_seq = [], []
        for i in range(self.iters):
            cur_hidden, inv_new, delta, confidence = self.step(
                cur_hidden, inv_new, delta, confidence, i > 0, context, t,
                inv_depth, features, proj_pairs, depth_min, depth_max,
                view_weights, x_off)
            inv_seq.append(inv_new)
            conf_seq.append(confidence)
        return self.mask(context), cur_hidden, inv_seq, conf_seq

    def eval_forward(self, inv_depth, hidden, context, features, proj_pairs,
                     depth_min, depth_max, view_weights,
                     generator: Optional[torch.Generator] = None,
                     cols=None):
        """DDIM inference."""
        b = inv_depth.shape[0]
        sched = self.schedule
        x_off = 0 if cols is None else cols.start
        img = noise_like(generator, inv_depth, sched.scale, cols)
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
                cur_hidden, inv_new, delta, confidence = self.step(
                    cur_hidden, inv_new, delta, confidence, i > 0, context,
                    t, inv_depth, features, proj_pairs, depth_min,
                    depth_max, view_weights, x_off)
                inv_seq.append(inv_new)
                conf_seq.append(confidence)

            if time_next < 0:
                continue
            pred_noise = sched.predict_noise_from_start(img, t, delta)
            sqrt_an, c, sigma = sched.ddim_coeffs(time, time_next)
            noise = noise_like(generator, inv_depth, sched.scale, cols)
            img = delta * float(sqrt_an) + float(c) * pred_noise \
                + float(sigma) * noise

        return mask, cur_hidden, inv_seq, conf_seq
