"""Reference-image context encoder (NCHW).

Counterpart of diffmvs_tpu/nn/context.py:ContextNet (its plain branch).
ResidualBlock chain (8->16->32->48 ch, stride 2 between levels); per-stage
heads sized hidden_dim[s] + context_dim[s]. The stage3 head exists only
for the cascade variant (out_dim[2] > 0). Every conv computes in `dtype`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from diffmvs_tpu_torch.nn.layers import Conv2d, ConvBnReLU, ResidualBlock


class ContextNet(nn.Module):
    def __init__(self, out_dim: Tuple[int, int, int] = (64, 64, 36),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBnReLU(3, 8, 3, 1, 1, dtype=dtype)
        dims = [8, 16, 32, 48]
        for lvl in (1, 2, 3):
            setattr(self, f"layer{lvl}", nn.Sequential(
                ResidualBlock(dims[lvl - 1], dims[lvl], stride=2,
                              dtype=dtype),
                ResidualBlock(dims[lvl], dims[lvl], stride=1, dtype=dtype)))
        self.output1 = Conv2d(48, out_dim[0], 3, padding=1, dtype=dtype)
        self.output2 = Conv2d(32, out_dim[1], 3, padding=1, dtype=dtype)
        self.cascade = out_dim[2] > 0
        if self.cascade:
            self.output3 = Conv2d(16, out_dim[2], 3, padding=1, dtype=dtype)

    def forward(self, x):
        """x: [B, 3, H, W]. Returns {"stage1".."stage3": [B, C, h, w]}."""
        ctx = {}
        x = self.layer1(self.conv1(x))
        if self.cascade:
            ctx["stage3"] = self.output3(x)
        x = self.layer2(x)
        ctx["stage2"] = self.output2(x)
        x = self.layer3(x)
        ctx["stage1"] = self.output1(x)
        return ctx
