"""3D cost-volume regularization + pixel-wise view weighting (NCDHW).

Counterpart of diffmvs_tpu/nn/costreg.py (CostRegNet, PixelViewWeight;
plain branches). Volumes are [B, G, D, H, W].

CostRegNet computes in `dtype`; at inference on the card its last layer,
`prob`, is one hand-written kernel (ops/cost_prob.py), elsewhere the
module. PixelViewWeight always computes in float32, whatever the model's
dtype: the JAX module passes its convs no dtype (nn/costreg.py,
PixelViewWeight), so flax promotes them to the float32 of their
parameters. PixelViewWeight.views weighs all source views at once: at
inference on the card in one hand-written kernel (ops/view_weight.py),
elsewhere with the module, view by view.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffmvs_tpu_torch.nn.layers import (Conv3d, Conv3dBnAct, Deconv3dBnAct,
                                         frozen)
from diffmvs_tpu_torch.ops import cost_prob, view_weight


class CostRegNet(nn.Module):
    """3-level 3D U-Net with transposed-conv decoder and skip adds."""

    def __init__(self, in_channels: int, base_channels: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bc = base_channels
        chans = [(in_channels, bc, 1), (bc, bc, 1), (bc, 2 * bc, 2),
                 (2 * bc, 2 * bc, 1), (2 * bc, 4 * bc, 2),
                 (4 * bc, 4 * bc, 1)]
        for i, (ci, co, s) in enumerate(chans):
            setattr(self, f"conv{i}", Conv3dBnAct(ci, co, 3, s, 1,
                                                  dtype=dtype))
        self.conv6 = Deconv3dBnAct(4 * bc, 2 * bc, dtype=dtype)
        self.conv7 = Deconv3dBnAct(2 * bc, bc, dtype=dtype)
        self.prob = Conv3d(bc, 1, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, x):
        """x: [B, G, D, H, W]. Returns logits [B, D, H, W]. On a CUDA
        tensor where prob_fusable(x), `prob` is one launch of its kernel."""
        c1 = self.conv1(self.conv0(x))
        c3 = self.conv3(self.conv2(c1))
        c5 = self.conv5(self.conv4(c3))
        x = c3 + self.conv6(c5)
        x = c1 + self.conv7(x)
        if x.is_cuda and self.prob_fusable(x):
            return cost_prob.prob_conv(x, self.prob.weight)
        return self.prob(x)[:, 0]

    def prob_fusable(self, x) -> bool:
        """The prob kernel's conditions besides a CUDA tensor: `prob`
        frozen (autograd recording nothing; eval mode), the plain Conv3d
        (not a width shard's SpaceConv3d) and x in its compute dtype,
        float32 or bfloat16. Training, width shards and the CPU run the
        module."""
        return (frozen((self.prob,), x) and type(self.prob) is Conv3d
                and x.dtype == self.prob.compute_dtype
                and x.dtype in (torch.float32, torch.bfloat16))


class PixelViewWeight(nn.Module):
    """Per-source-view pixel weight: conv3d stack -> sigmoid -> max over D."""

    def __init__(self, groups: int):
        super().__init__()
        self.conv = nn.Sequential(Conv3dBnAct(groups, 8, 3, 1, 1),
                                  Conv3d(8, 1, 3, padding=1, bias=True))

    def forward(self, cor_feat):
        """cor_feat: [B, G, D, H, W] (any float dtype). Returns [B, H, W]
        float32."""
        x = torch.sigmoid(self.conv(cor_feat)[:, 0])       # [B, D, H, W]
        return x.amax(dim=1)

    def views(self, cor_feats):
        """The weights of all V-1 source views: [V-1, B, H, W] float32.

        cor_feats: their correlation volumes stacked, [V-1, B, D, H, W, G]
        contiguous. On a CUDA volume where fusable(cor_feats), one launch
        of the kernel; otherwise this module view by view: in training
        (BatchNorm's batch statistics between the two convs, and a
        backward), on a width shard (the convs' halo exchange) and on the
        CPU. The module gets each view in the layout the warp gave it, so
        that its convolutions and BatchNorm's batch statistics round as
        they did on the unstacked volumes: on the card a contiguous float32
        [B, G, D, H, W] copy, what its first conv made of the warp kernel's
        buffers (cuDNN takes its NCDHW convolutions for that, its
        channels-last ones for a strided view), on the CPU the plain
        warp's [B, D, H, W, G] order.
        """
        if cor_feats.is_cuda and self.fusable(cor_feats):
            return view_weight.view_weights(cor_feats,
                                            *view_weight.weights(self))
        per_view = [c.permute(0, 4, 1, 2, 3) for c in cor_feats.unbind(0)]
        if cor_feats.is_cuda:
            per_view = [c.to(torch.float32,
                             memory_format=torch.contiguous_format)
                        for c in per_view]
        return torch.stack([self(c) for c in per_view])

    def fusable(self, cor_feats) -> bool:
        """The kernel's conditions besides a CUDA volume: frozen (eval
        mode with running statistics, autograd recording nothing) and the
        plain Conv3d (not a width shard's SpaceConv3d)."""
        block, conv2 = self.conv
        return (frozen((self,), cor_feats) and type(block.conv) is Conv3d
                and type(conv2) is Conv3d)
