"""3D cost-volume regularization + pixel-wise view weighting (NCDHW).

Counterpart of diffmvs_tpu/nn/costreg.py (CostRegNet, PixelViewWeight;
plain branches). Volumes are [B, G, D, H, W].

CostRegNet computes in `dtype`. PixelViewWeight always computes in
float32, whatever the model's dtype: the JAX module passes its convs no
dtype (nn/costreg.py, PixelViewWeight), so flax promotes them to the
float32 of their parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffmvs_tpu_torch.nn.layers import Conv3d, Conv3dBnAct, Deconv3dBnAct


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
        """x: [B, G, D, H, W]. Returns logits [B, D, H, W]."""
        c1 = self.conv1(self.conv0(x))
        c3 = self.conv3(self.conv2(c1))
        c5 = self.conv5(self.conv4(c3))
        x = c3 + self.conv6(c5)
        x = c1 + self.conv7(x)
        return self.prob(x)[:, 0]


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
