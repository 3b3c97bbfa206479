"""Conditional diffusion UNet with a recurrent (GRU) bottleneck (NCHW).

Counterpart of diffmvs_tpu/nn/unet.py (plain branches). Structure per
refinement stage s (dim = unet_dim[s], mults = (1,2[,4])): init 7x7 conv
-> ResnetBlock + Downsample ladder -> SepConvGRU carrying the hidden state
at 1/8 resolution -> ResnetBlock ladder up with skip concats -> heads:
delta (1 ch) and sigmoid confidence. Time conditioning is FiLM
(scale/shift) from a sinusoidal embedding MLP.

Module attributes follow the reference's state_dict keys (init_conv,
time_mlp.{1,3}, downs.{i}.{0,1}, gru, mid, ups.{i}.{0,1},
final_res_block, final_conv, conf). The JAX package's Dense is Linear
here, and its Conv7x7RowSum (a TPU-speed decomposition) is a plain 7x7
conv: in bfloat16 both take bfloat16 operands, accumulate in float32 and
round the output once.

Compute dtype (`dtype`, the JAX modules' `dtype=`): every conv and linear
layer computes in it over float32 parameters; WSConv standardizes its
float32 kernel first; GroupNorm reduces and normalizes in float32 and
returns its input's dtype; the time embedding is float32 until the MLP
casts it.

Width sharding (parallel/spatial.py): SpaceWSConv is WSConv on a shard
of the width, SpaceGroupNorm a GroupNorm whose moments run over the whole
width (summed over the space group, in training and in eval alike).
Downsample's space-to-depth and Upsample's nearest resize are local: the
shards' columns are 32-aligned.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.nn.layers import (Conv2d, Linear, SepConvGRU,
                                         _SpaceConv)
from diffmvs_tpu_torch.parallel import spatial


def sinusoidal_pos_emb(t, dim):
    """t: [B] -> [B, dim] (sin half, then cos half)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim)


class WSConv(Conv2d):
    """Weight-standardized conv: the float32 kernel is standardized over
    (in, kh, kw) per output channel with biased variance, eps 1e-5 for a
    float32 input (1e-3 for a lower-precision one), then cast to the
    compute dtype."""

    def standardized(self, x):
        """The standardized kernel for input x, in the compute dtype."""
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        return ((w - mean) * torch.rsqrt(var + eps)).to(self.compute_dtype)

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.standardized(x), self.bias.to(dt),
                        self.stride, self.padding)


class SpaceWSConv(_SpaceConv, WSConv):
    """WSConv on a width shard."""

    def forward(self, x):
        dt = self.compute_dtype
        return self.halo_conv(x.to(dt), self.standardized(x),
                              self.bias.to(dt))


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm whose statistics and normalization run in float32
    (flax's force_float32_reductions), returning the input's dtype."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class SpaceGroupNorm(GroupNorm):
    """GroupNorm on a width shard: the moments of each (sample, group)
    over the whole width, summed over the space group in float64
    (spatial.group_norm); `space` is set by spatial.shard_width."""

    space = None

    @staticmethod
    def check(norm):
        if not norm.affine:
            raise ValueError("SpaceGroupNorm: affine GroupNorms only")

    def forward(self, x):
        return spatial.group_norm(x, self.num_groups, self.weight,
                                  self.bias, self.eps, self.space)


class Block(nn.Module):
    """WSConv -> GroupNorm -> (FiLM) -> SiLU."""

    def __init__(self, in_ch, out_ch, groups=8, dtype=torch.float32):
        super().__init__()
        self.proj = WSConv(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.norm = GroupNorm(groups, out_ch, eps=1e-5)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two Blocks + residual 1x1 (identity when the widths agree)."""

    def __init__(self, in_ch, out_ch, time_dim=None, groups=4,
                 dtype=torch.float32):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(time_dim, out_ch * 2,
                                                    dtype=dtype))
                    if time_dim else None)
        self.block1 = Block(in_ch, out_ch, groups, dtype)
        self.block2 = Block(out_ch, out_ch, groups, dtype)
        self.res_conv = (Conv2d(in_ch, out_ch, 1, dtype=dtype)
                         if in_ch != out_ch else nn.Identity())

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            t = self.mlp(time_emb)[:, :, None, None]
            scale_shift = t.chunk(2, dim=1)
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class Downsample(nn.Sequential):
    """Space-to-depth (2x2, channel c*4 + p1*2 + p2) + 1x1 conv."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32):
        super().__init__(nn.PixelUnshuffle(2),
                         Conv2d(in_ch * 4, out_ch, 1, dtype=dtype))


class Upsample(nn.Sequential):
    """Nearest x2 + 3x3 conv."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv2d(in_ch, out_ch, 3, padding=1, dtype=dtype))


class DiffusionUNet(nn.Module):
    """The per-stage denoiser."""

    def __init__(self, dim: int, hidden_dim: int, input_dim: int,
                 dim_mults: Tuple[int, ...] = (1, 2),
                 resnet_block_groups: int = 4, dtype=torch.float32):
        super().__init__()
        g, dt = resnet_block_groups, dtype
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4

        self.init_conv = Conv2d(input_dim, dim, 7, padding=3, dtype=dt)
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), Linear(dim, time_dim, dtype=dt),
            nn.GELU(), Linear(time_dim, time_dim, dtype=dt))

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            down = (Conv2d(dim_in, dim_out, 3, padding=1, dtype=dt)
                    if is_last else Downsample(dim_in, dim_out, dt))
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_in, time_dim, g, dt), down]))

        self.gru = SepConvGRU(hidden_dim, dims[-1], dtype=dt)
        # the mid block is not time-conditioned
        self.mid = ResnetBlock(hidden_dim, dims[-1], None, g, dt)

        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            up = (Conv2d(dim_out, dim_in, 3, padding=1, dtype=dt) if is_last
                  else Upsample(dim_out, dim_in, dt))
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out + dim_in, dim_out, time_dim, g, dt), up]))

        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, g, dt)
        self.final_conv = Conv2d(dim, 1, 1, dtype=dt)
        self.conf = Conv2d(dim, 1, 1, dtype=dt)

    def forward(self, x, hidden, time):
        """x: [B, Cin, H, W]; hidden: [B, hidden_dim, H/2^(L-1), W/2^(L-1)];
        time: [B] timestep. Returns (new_hidden, delta [B,H,W],
        confidence [B,H,W])."""
        t = self.time_mlp(time)
        x = self.init_conv(x)
        r = x

        skips = []
        for block, down in self.downs:
            x = block(x, t)
            skips.append(x)
            x = down(x)

        hidden = self.gru(hidden, x)
        x = self.mid(hidden)

        for block, up in self.ups:
            x = block(torch.cat([x, skips.pop()], dim=1), t)
            x = up(x)

        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return (hidden, self.final_conv(x)[:, 0],
                torch.sigmoid(self.conf(x)[:, 0]))


class ConditionEncoder(nn.Module):
    """Encode (cost volume, depth samples) -> context feature: out_chs-1
    learned channels with the raw inverse depth as the last channel."""

    def __init__(self, cost_dim: int, num_sample: int, hidden_dim: int,
                 out_chs: int, dtype=torch.float32):
        super().__init__()
        self.convc1 = Conv2d(cost_dim, hidden_dim, 3, padding=1, dtype=dtype)
        self.convc2 = Conv2d(hidden_dim, hidden_dim, 3, padding=1,
                             dtype=dtype)
        self.convd1 = Conv2d(num_sample, hidden_dim, 3, padding=1,
                             dtype=dtype)
        self.convd2 = Conv2d(hidden_dim, hidden_dim, 3, padding=1,
                             dtype=dtype)
        self.output = Conv2d(2 * hidden_dim, out_chs - 1, 3, padding=1,
                             dtype=dtype)

    def forward(self, depth, depth_values, cost_volume):
        """depth: [B,1,H,W]; depth_values: [B,CostNum,H,W];
        cost_volume: [B,G*CostNum,H,W]. Returns [B, out_chs, H, W], the
        learned channels promoted to the depth's dtype by the concat."""
        c = F.relu(self.convc1(cost_volume))
        c = F.relu(self.convc2(c))
        d = F.relu(self.convd1(depth_values))
        d = F.relu(self.convd2(d))
        out = F.relu(self.output(torch.cat([c, d], dim=1)))
        return torch.cat([out, depth], dim=1)
