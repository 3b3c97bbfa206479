"""Conv wrappers, GRU, residual blocks (NCHW / NCDHW).

Counterpart of diffmvs_tpu/nn/layers.py. Attribute names reproduce the
reference's state_dict keys (`.conv` / `.bn` inside each wrapper, the GRU's
convz1..convq2), so a released checkpoint loads with strict=True. Weights
use torch's default initialization, which the JAX package reproduces.
BatchNorm: momentum 0.1, eps 1e-5.

Compute dtype: as the JAX modules' `dtype=`, each conv and linear layer
holds one (`dtype`, float32 by default) and computes in it: the input, the
weight and the bias are cast to it, so the parameters stay float32 and
their gradients come back float32 through the casts. BatchNorm takes the
conv's output as it is: torch reduces a bfloat16 input's statistics and
normalizes it in float32 against the float32 affine and running
statistics, and rounds once to bfloat16 (flax's force_float32_reductions).

Kernels: frozen() is the one rule for when a hand-written inference kernel
(ops/) may stand in for a chain of these modules; the modules that route
to one (nn/costreg.PixelViewWeight, nn/feature.FeatureNet) add only the
kernel's own conditions.

Width sharding (parallel/spatial.py): SpaceConv2d, SpaceConv3d and
SpaceConvTranspose3d are the convolutions' forms on a shard of the width
(the last dim), which spatial.shard_width swaps in, in place. Each takes
from its neighbours the columns its kernel, stride and padding reach
beyond the shard (zeros at the global edges, where the unsharded
convolution's own padding lies) and convolves without padding along W
(spatial.halo_conv), so its output is the unsharded output's columns of
this shard.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.parallel import spatial


class _ComputeDtype:
    """Mixin of the conv and linear layers: float32 parameters, computing
    in `dtype` (compute_dtype)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def operands(self, x):
        """(x, weight, bias) cast to compute_dtype; no bias stays None."""
        dt = self.compute_dtype
        return (x.to(dt), self.weight.to(dt),
                None if self.bias is None else self.bias.to(dt))


class Conv2d(_ComputeDtype, nn.Conv2d):
    """nn.Conv2d computing in `dtype` over float32 parameters."""

    def forward(self, x):
        return self._conv_forward(*self.operands(x))


class Conv3d(_ComputeDtype, nn.Conv3d):
    """nn.Conv3d computing in `dtype` over float32 parameters."""

    def forward(self, x):
        return self._conv_forward(*self.operands(x))


class ConvTranspose3d(_ComputeDtype, nn.ConvTranspose3d):
    """nn.ConvTranspose3d (no output_size argument) computing in `dtype`
    over float32 parameters."""

    def forward(self, x):
        return F.conv_transpose3d(
            *self.operands(x), self.stride, self.padding, self.output_padding,
            self.groups, self.dilation)


class _SpaceConv:
    """Mixin of the width-sharded convolutions: `space` (a
    spatial.SpaceGroup) is set by spatial.shard_width."""

    space = None

    @staticmethod
    def check(conv):
        """Raises unless conv is one these forms take: zero padding, no
        dilation along W, integer padding."""
        if (conv.padding_mode != "zeros" or conv.dilation[-1] != 1
                or isinstance(conv.padding, str)):
            raise ValueError(f"{type(conv).__name__}: width sharding takes "
                             f"zero padding without dilation along W")

    def halo_conv(self, x, weight, bias):
        """This shard's convolution: the left halo is the padding, the
        right one what the last output's window reaches past the shard;
        no padding along W; the output cropped to w / stride columns
        (spatial.halo_conv)."""
        k, s, p = self.kernel_size[-1], self.stride[-1], self.padding[-1]
        w = x.shape[-1]
        if w % s:
            raise ValueError(f"shard width {w} not divisible by stride {s}")
        conv = (self.stride, self.padding[:-1] + (0,), self.dilation, False,
                (0,) * len(self.stride), self.groups)
        return spatial.halo_conv(x, weight, bias, conv, p,
                                 max(k - p - s, 0), 0, w // s, self.space)


class SpaceConv2d(_SpaceConv, Conv2d):
    """Conv2d on a width shard."""

    def forward(self, x):
        return self.halo_conv(*self.operands(x))


class SpaceConv3d(_SpaceConv, Conv3d):
    """Conv3d on a width shard."""

    def forward(self, x):
        return self.halo_conv(*self.operands(x))


class SpaceConvTranspose3d(_SpaceConv, ConvTranspose3d):
    """ConvTranspose3d on a width shard. Output column o = i * s - p + kk
    takes input columns i with i * s - p <= o <= i * s - p + k - 1, so a
    shard of outputs [a s, b s) reads inputs from a - (k - 1 - p) // s to
    b - 1 + ((p - 1) // s + 1): for the decoder's k 3, stride 2, padding 1,
    one column of the right neighbour. Transposed without padding along W,
    the output is cropped to the shard's columns."""

    def forward(self, x):
        k, s, p = self.kernel_size[-1], self.stride[-1], self.padding[-1]
        w = x.shape[-1]
        left = (k - 1 - p) // s
        conv = (self.stride, self.padding[:-1] + (0,), self.dilation, True,
                self.output_padding[:-1] + (0,), self.groups)
        return spatial.halo_conv(*self.operands(x), conv, left,
                                 (p - 1) // s + 1, left * s + p, w * s,
                                 self.space)


class Linear(_ComputeDtype, nn.Linear):
    """nn.Linear computing in `dtype` over float32 parameters."""

    def forward(self, x):
        return F.linear(*self.operands(x))


def frozen(modules, *inputs) -> bool:
    """Whether a hand-written inference kernel may stand in for `modules`
    on `inputs`: no submodule is training, every BatchNorm among them has
    running statistics (the kernel applies BatchNorm from them), and
    autograd would record nothing for the inputs or the parameters. The
    kernel's own conditions (layer types, dtypes, shapes) are its
    caller's."""
    subs = [m for module in modules for m in module.modules()]
    records = torch.is_grad_enabled() and (
        any(x.requires_grad for x in inputs)
        or any(p.requires_grad for m in modules for p in m.parameters()))
    return (not records and not any(m.training for m in subs)
            and all(m.running_mean is not None and m.running_var is not None
                    for m in subs
                    if isinstance(m, nn.modules.batchnorm._BatchNorm)))


class ConvBnAct(nn.Module):
    """Conv2d (no bias) + BN (+ ReLU)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 relu=True, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=padding, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(out_ch)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class Conv3dBnAct(nn.Module):
    """Conv3d (no bias) + BN + ReLU over NCDHW."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=padding, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Deconv3dBnAct(nn.Module):
    """ConvTranspose3d(k3, stride 2, pad 1, output_padding 1) + BN + ReLU:
    doubles each spatial dim."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32):
        super().__init__()
        self.conv = ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                                    output_padding=1, bias=False,
                                    dtype=dtype)
        self.bn = nn.BatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvBnReLU(ConvBnAct):
    """Conv2d+BN+ReLU with a bias-free conv."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1,
                 dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         dtype=dtype)


class ConvBn(ConvBnAct):
    """Conv2d+BN, no activation."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1,
                 dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         relu=False, dtype=dtype)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with additive skip (strided skip through downsample)."""

    def __init__(self, in_ch, out_ch, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBnReLU(in_ch, out_ch, 3, stride, 1, dtype=dtype)
        self.conv2 = ConvBn(out_ch, out_ch, 3, 1, 1, dtype=dtype)
        self.downsample = (ConvBn(in_ch, out_ch, 3, stride, 1, dtype=dtype)
                           if stride != 1 else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class SepConvGRU(nn.Module):
    """RAFT separable conv GRU: horizontal (1x5) gated update, then
    vertical (5x1). The gates compute in `dtype`; the hidden state keeps
    the dtype that type promotion gives it, as in the JAX module."""

    def __init__(self, hidden_dim, input_dim, dtype=torch.float32):
        super().__init__()
        for tag, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{tag}",
                        Conv2d(hidden_dim + input_dim, hidden_dim, k,
                               padding=p, dtype=dtype))

    def forward(self, h, x):
        for tag in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(
                torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h
