"""Conv wrappers, GRU, residual blocks (NCHW / NCDHW).

Counterpart of diffmvs_tpu/nn/layers.py. Attribute names reproduce the
reference's state_dict keys (`.conv` / `.bn` inside each wrapper, the GRU's
convz1..convq2), so a released checkpoint loads with strict=True. Weights
use torch's default initialization, which the JAX package reproduces.
BatchNorm: momentum 0.1, eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBnAct(nn.Module):
    """Conv2d (no bias) + BN (+ ReLU)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 relu=True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class Conv3dBnAct(nn.Module):
    """Conv3d (no bias) + BN + ReLU over NCDHW."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Deconv3dBnAct(nn.Module):
    """ConvTranspose3d(k3, stride 2, pad 1, output_padding 1) + BN + ReLU:
    doubles each spatial dim."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = nn.BatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvBnReLU(ConvBnAct):
    """Conv2d+BN+ReLU with a bias-free conv."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding)


class ConvBn(ConvBnAct):
    """Conv2d+BN, no activation."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         relu=False)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with additive skip (strided skip through downsample)."""

    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__()
        self.conv1 = ConvBnReLU(in_ch, out_ch, 3, stride, 1)
        self.conv2 = ConvBn(out_ch, out_ch, 3, 1, 1)
        self.downsample = (ConvBn(in_ch, out_ch, 3, stride, 1)
                           if stride != 1 else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class SepConvGRU(nn.Module):
    """RAFT separable conv GRU: horizontal (1x5) gated update, then
    vertical (5x1)."""

    def __init__(self, hidden_dim, input_dim):
        super().__init__()
        for tag, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{tag}",
                        nn.Conv2d(hidden_dim + input_dim, hidden_dim, k,
                                  padding=p))

    def forward(self, h, x):
        for tag in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(
                torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h
