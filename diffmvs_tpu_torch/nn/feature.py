"""FPN image feature extractor (NCHW).

Counterpart of diffmvs_tpu/nn/feature.py:FeatureNet (its plain branch).
4-level pyramid: strided 5x5 convs down (8->16->32->64 ch), nearest
upsample + 1x1 lateral merge up. Heads emit stage1 (1/8 res), stage2 (1/4
res) and, for the cascade variant only, stage3 (1/2 res). Every conv
computes in `dtype`, so the features come out in it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.nn.layers import Conv2d, ConvBnAct


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8,
                 out_channels: Tuple[int, int, int] = (48, 32, 16),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bc = base_channels
        specs = {0: [(3, bc, 3, 1, 1), (bc, bc, 3, 1, 1)],
                 1: [(bc, 2 * bc, 5, 2, 2), (2 * bc, 2 * bc, 3, 1, 1),
                     (2 * bc, 2 * bc, 3, 1, 1)],
                 2: [(2 * bc, 4 * bc, 5, 2, 2), (4 * bc, 4 * bc, 3, 1, 1),
                     (4 * bc, 4 * bc, 3, 1, 1)],
                 3: [(4 * bc, 8 * bc, 5, 2, 2), (8 * bc, 8 * bc, 3, 1, 1),
                     (8 * bc, 8 * bc, 3, 1, 1)]}
        for lvl, layers in specs.items():
            setattr(self, f"conv{lvl}", nn.Sequential(
                *[ConvBnAct(ci, co, k, s, p, dtype=dtype)
                  for ci, co, k, s, p in layers]))
        self.out1 = Conv2d(8 * bc, out_channels[0], 1, bias=False,
                           dtype=dtype)
        self.inner1 = Conv2d(4 * bc, 8 * bc, 1, bias=True, dtype=dtype)
        self.out2 = Conv2d(8 * bc, out_channels[1], 3, padding=1,
                           bias=False, dtype=dtype)
        self.cascade = out_channels[2] > 0
        if self.cascade:
            self.inner2 = Conv2d(2 * bc, 8 * bc, 1, bias=True, dtype=dtype)
            self.out3 = Conv2d(8 * bc, out_channels[2], 3, padding=1,
                               bias=False, dtype=dtype)

    def forward(self, x):
        """x: [N, 3, H, W]. Returns {"stage1".."stage3": [N, C, h, w]}."""
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)

        outputs = {"stage1": self.out1(c3)}
        intra = F.interpolate(c3, scale_factor=2, mode="nearest") \
            + self.inner1(c2)
        outputs["stage2"] = self.out2(intra)
        if self.cascade:
            intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
                + self.inner2(c1)
            outputs["stage3"] = self.out3(intra)
        return outputs
