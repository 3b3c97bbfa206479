"""FPN image feature extractor (NCHW).

Counterpart of diffmvs_tpu/nn/feature.py:FeatureNet (its plain branch).
4-level pyramid: strided 5x5 convs down (8->16->32->64 ch), nearest
upsample + 1x1 lateral merge up. Heads emit stage1 (1/8 res), stage2 (1/4
res) and, for the cascade variant only, stage3 (1/2 res). Every conv
computes in `dtype`, so the features come out in it.

The stem (conv0 and conv1[0]) runs as one hand-written kernel
(ops/feature_stem.py) where stem_fusable says it applies; elsewhere, and
as its plain version, the module chain.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.nn.layers import Conv2d, ConvBnAct, frozen
from diffmvs_tpu_torch.ops import feature_stem


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
        """x: [N, 3, H, W]. Returns {"stage1".."stage3": [N, C, h, w]}.
        On a CUDA tensor where stem_fusable(x), conv0 and conv1[0] are one
        launch of the stem kernel."""
        if x.is_cuda and self.stem_fusable(x):
            c1 = self.conv1[1:](feature_stem.stem(
                x.contiguous(memory_format=torch.channels_last),
                feature_stem.params(self)))
        else:
            c1 = self.conv1(self.conv0(x))
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

    def stem_fusable(self, x) -> bool:
        """The stem kernel's conditions besides a CUDA tensor: float32
        images [N, 3, H, W]; the stem frozen (eval mode with running
        statistics, autograd recording nothing); bf16 compute (a float32
        stem would run on tensor cores in TF32, less exact than the
        module's float32); the plain Conv2d (not a width shard's
        SpaceConv2d) at the kernel's widths (base_channels 8). Training,
        width shards, float32 and the CPU keep the module chain."""
        stem = feature_stem.blocks(self)
        return (x.dtype == torch.float32 and x.dim() == 4
                and frozen(stem, x)
                and all(type(b.conv) is Conv2d
                        and b.conv.compute_dtype == torch.bfloat16 and b.relu
                        for b in stem)
                and tuple(tuple(b.conv.weight.shape) for b in stem)
                == feature_stem.SHAPES)
