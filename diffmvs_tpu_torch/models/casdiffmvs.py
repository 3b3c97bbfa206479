"""Top model: DiffMVS / CasDiffMVS orchestration.

Counterpart of diffmvs_tpu/models/casdiffmvs.py. The variant is selected by
ModelConfig.stage_iters[2] (0 => DiffMVS with a single 1/4-res refinement
and x4 upsample; >0 => the 1/4 + 1/2 cascade with x2 upsamples).

Forward contract (the JAX package's):
  imgs:          [B, V, H, W, 3] float in [0, 1] or uint8 (ref view first)
  proj_matrices: {stage1..4: [B, V, 2, 4, 4]} (extrinsic, intrinsic pairs)
  depth_values:  [B, ND] inverse-depth linspace (first and last are used)
  depth_gt:      {stage1..4: [B, Hs, Ws]} metric GT (training only)
Returns {"depth": [...], "conf": [...], "photometric_confidence": [...]}
with the JAX package's list layout for train=True, export=True and
export=False.

Gradient seams (the reference's detaches): the refinement stages start
from the detached previous depth and take detached view weights; the
training branch's GT fallback (the upsampled initial depth) is detached.
BatchNorm follows the module's mode: model.train() for training.

Inside, maps are NCHW; the images enter as a channels-last view, so the
conv stacks run channels-last and the stage features reach the warp
kernel as contiguous NHWC maps without a copy (for B = 1).

Width sharding (parallel/spatial.shard_width sets `space`): the model
then takes this rank's columns of every map (imgs [B, V, H, w, 3], GT and
train_overrides' noise alike, whole projections and depth values) and
returns its columns of every output. The forward all-gathers the shards'
widths once (spatial.Shard: any 32-aligned split), gathers each source
view's features to full width once per stage (in their own dtype) for
the warp, which takes ref's column offset at each stride, and draws its
noise at full width; the convolutions, norms and the convex upsampling
exchange halos (nn/layers.py, nn/unet.py, geometry/upsample.py). The
nearest upsamplings are local.

Compute dtype (cfg.compute_dtype, the JAX package's policy): the conv
stacks compute in cfg.dtype over float32 parameters; the uint8 / 255 input
normalization, the geometry, the soft-argmax, the convex upsampling (the
mask logits go to float32 first) and the diffusion state stay float32.

Spans (utils/profiling.py): "model.features" (FeatureNet over every view,
ContextNet over the reference view) and one "model.stage<k>" a stage
(its body, the upsampling at its end included; DiffMVS has no stage3),
each taking its device time while a profiler runs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.config import ModelConfig
from diffmvs_tpu_torch.geometry.transforms import depth_to_disp, disp_to_depth
from diffmvs_tpu_torch.geometry.upsample import upsample_with_mask
from diffmvs_tpu_torch.models.refine import RefinementStage, draw_t_noise
from diffmvs_tpu_torch.models.schedule import DiffusionSchedule
from diffmvs_tpu_torch.models.stages import InitialStage
from diffmvs_tpu_torch.nn.context import ContextNet
from diffmvs_tpu_torch.nn.feature import FeatureNet
from diffmvs_tpu_torch.nn.layers import Conv2d, ConvBnAct
from diffmvs_tpu_torch.ops.resize import upsample_nearest
from diffmvs_tpu_torch.utils import profiling


class HiddenInit(nn.Sequential):
    """Strided convs bringing the context hidden state to 1/8 resolution
    (num_down stride-2 ConvBnActs, then a bias-free 3x3)."""

    def __init__(self, hidden_dim: int, num_down: int = 1,
                 dtype=torch.float32):
        layers = [ConvBnAct(hidden_dim if i == 0 else 32, 32, 3, 2, 1,
                            dtype=dtype)
                  for i in range(num_down)]
        layers.append(Conv2d(32, hidden_dim, 3, padding=1, bias=False,
                             dtype=dtype))
        super().__init__(*layers)


def views_nhwc(x, b, v):
    """[B*V, C, h, w] -> V contiguous NHWC maps [B, h, w, C]."""
    x = x.permute(0, 2, 3, 1)
    x = x.reshape((b, v) + x.shape[1:]).transpose(0, 1).contiguous()
    return list(x.unbind(0))


class CasDiffMVS(nn.Module):
    space = None        # a spatial.SpaceGroup once width-sharded

    def __init__(self, cfg: ModelConfig, warp=None):
        """warp: the plane-sweep warp + group correlation every stage
        runs; None for ops/correlation.warp_and_correlate (the kernels on
        CUDA tensors), or e.g. warp_and_correlate_plain (plain PyTorch on
        every device, autograd its backward)."""
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dt = cfg.dtype
        self.feature = FeatureNet(cfg.base_channels, cfg.feat_dim_stage, dt)
        self.context = ContextNet(cfg.ctx_out_dim, dt)
        self.depthnet = InitialStage(cfg.ctx_out_dim[0],
                                     cfg.cost_dim_stage[0], up_ratio=2,
                                     dtype=dt, warp=warp)
        hidden_inits = []
        for s in (1, 2):
            if cfg.stage_iters[s] == 0:
                continue
            hidden_inits.append(HiddenInit(cfg.hidden_dim[s], num_down=s,
                                           dtype=dt))
            setattr(self, f"update_block_depth{s + 1}", RefinementStage(
                unet_dim=cfg.unet_dim[s],
                dim_mults=cfg.unet_dim_mults[s],
                hidden_dim=cfg.hidden_dim[s],
                context_dim=cfg.context_dim[s],
                num_sample=cfg.cost_num[s],
                group_dim=cfg.cost_dim_stage[s],
                depth_interval=(1.0 / cfg.numdepth)
                * cfg.depth_intervals_ratio[s],
                iters=cfg.stage_iters[s],
                up_ratio=cfg.up_ratio,
                schedule=DiffusionSchedule(
                    timesteps=cfg.timesteps[s],
                    sampling_timesteps=cfg.sampling_timesteps[s],
                    eta=cfg.ddim_eta[s],
                    scale=cfg.scale[s]),
                min_radius=cfg.min_radius,
                max_radius=cfg.max_radius,
                remat=cfg.remat,
                dtype=dt,
                warp=warp))
        self.hidden_init = nn.ModuleList(hidden_inits)

    def draw_train_overrides(self, b: int, h: int, w: int,
                             generator: torch.Generator) -> Dict:
        """{stage_idx: (t [b], noise [b, Hs, Ws])}: what the training
        forward on b images of h x w draws from `generator`, drawn in its
        order (refinement stage 1 at 1/4 resolution, then stage 2 at 1/2),
        on the generator's device. Passed as train_overrides, they make the
        forward equal to one that draws them itself."""
        out = {}
        for s in (1, 2):
            if self.cfg.stage_iters[s] == 0:
                continue
            f = 8 // 2 ** s
            like = torch.empty((b, h // f, w // f), device=generator.device)
            block = getattr(self, f"update_block_depth{s + 1}")
            out[s] = draw_t_noise(block.schedule, like, generator)
        return out

    def forward(self, imgs, proj_matrices, depth_values, depth_gt=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, export: bool = False,
                train_overrides: Optional[Dict] = None):
        """generator: the source of the diffusion timesteps and noise; for
        inference, None gives zero noise.

        train=True: training branch (q_sample of the GT residual), every
          intermediate depth and per-iteration confidence; needs depth_gt
          and either a generator or train_overrides.
        train=False, export=False: DDIM inference with the same full lists
          (the reference's validation).
        train=False, export=True: final depth + full-res confidences only.
        train_overrides: optional {stage_idx: (t [B], noise [B, Hs, Ws])}
          replacing each refinement stage's draw.
        """
        cfg = self.cfg
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        b, v = imgs.shape[0], imgs.shape[1]
        space = self.space
        shard = None if space is None else space.shard(imgs.shape[3],
                                                       imgs.device)

        disp_min = depth_values[:, 0].float()              # [B]
        disp_max = depth_values[:, -1].float()
        depth_max = 1.0 / disp_min
        depth_min = 1.0 / disp_max

        def bshape(x, arr):
            return x.reshape((b,) + (1,) * (arr.dim() - 1))

        def scale_inv_depth(nd):
            return disp_to_depth(nd, bshape(depth_min, nd),
                                 bshape(depth_max, nd))

        def to_disp(d):
            return depth_to_disp(d, bshape(depth_min, d),
                                 bshape(depth_max, d))

        # views fold into the batch; the permuted NHWC input is a
        # channels-last NCHW view
        nchw = imgs.permute(0, 1, 4, 2, 3)
        with profiling.span("model.features", device=imgs.device):
            feats = self.feature(nchw.reshape((b * v,) + nchw.shape[2:]))
            features = {k: views_nhwc(x, b, v) for k, x in feats.items()}
            contexts = self.context(nchw[:, 0])

        depth_predictions = []
        confs = []           # per-iteration confidences (non-export)
        confidences = []     # full-res photometric confidences
        view_weights = None

        for stage_idx in range(3):
            if stage_idx > 0 and cfg.stage_iters[stage_idx] == 0:
                continue
            stage_key = f"stage{stage_idx + 1}"
            with profiling.span("model." + stage_key, device=imgs.device):
                feat_list = features[stage_key]
                cols = None
                if shard is not None:       # the warp reads whole source maps
                    stride = 2 ** (3 - stage_idx)
                    cols = shard.at(stride)
                    feat_list = [feat_list[0]] + [shard.gather(f, 2, stride)
                                                  for f in feat_list[1:]]
                proj_stage = proj_matrices[stage_key].float()
                context_stage = contexts[stage_key]
                h, w = feat_list[0].shape[1], feat_list[0].shape[2]

                if stage_idx == 0:
                    nd0 = cfg.numdepth_initial
                    samples = torch.arange(nd0, dtype=torch.float32,
                                           device=imgs.device) / (nd0 - 1.0)
                    samples = samples.reshape(1, nd0, 1, 1)
                    samples = samples.expand(b, nd0, h, w)
                    depth_hyp = scale_inv_depth(samples)[1]

                    ctx = F.relu(context_stage)
                    mask, inv_depth, init_depth, view_weights, conf = \
                        self.depthnet(feat_list, ctx, proj_stage, depth_hyp,
                                      scale_inv_depth,
                                      x_off=0 if cols is None else cols.start)
                    depth_predictions.append(init_depth)
                    confidences.append(upsample_nearest(conf, 2 ** 3))
                    inv_up = upsample_with_mask(inv_depth, mask.float(), 2,
                                                space)
                    depth_predictions.append(scale_inv_depth(inv_up)[1])
                    continue

                hd = cfg.hidden_dim[stage_idx]
                inv_cur = to_disp(depth_predictions[-1].detach())
                vw_stage = upsample_nearest(view_weights.detach(),
                                            2 ** stage_idx,
                                            spatial_axes=(2, 3))
                hidden_d = torch.tanh(
                    self.hidden_init[stage_idx - 1](context_stage[:, :hd]))
                ctx = F.relu(context_stage[:, hd:])

                inv_init = inv_gt = t_noise = None
                if train:
                    init_up = upsample_nearest(depth_predictions[0],
                                               2 ** stage_idx)
                    inv_init = to_disp(init_up).detach()
                    inv_gt = to_disp(depth_gt[stage_key])
                    if train_overrides is not None:
                        t_noise = train_overrides.get(stage_idx)

                block = getattr(self, f"update_block_depth{stage_idx + 1}")
                mask, _, inv_seq, conf_seq = block(
                    inv_cur, hidden_d, ctx, feat_list, proj_stage, depth_min,
                    depth_max, vw_stage, generator=generator,
                    gt_inv_depth=inv_gt, inv_init_depth=inv_init, train=train,
                    t_noise=t_noise, cols=cols)

                if train or not export:
                    for inv_i in inv_seq:
                        depth_predictions.append(scale_inv_depth(inv_i)[1])
                    confs.extend(conf_seq)
                else:
                    depth_predictions.append(scale_inv_depth(inv_seq[-1])[1])
                    confidences.append(
                        upsample_nearest(conf_seq[-1], 2 ** (3 - stage_idx)))

                inv_up = upsample_with_mask(inv_seq[-1], mask.float(),
                                            cfg.up_ratio, space)
                depth_predictions.append(scale_inv_depth(inv_up)[1])

        return {
            "depth": depth_predictions,
            "conf": confs,
            "photometric_confidence": confidences,
        }
