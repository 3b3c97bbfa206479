"""FeatureNet's full-resolution stem as one hand-written CUDA kernel.

nn/feature.FeatureNet opens with conv0 (3 -> 8 -> 8, 3x3) and the stride-2
5x5 conv to 16 channels that opens conv1, each a ConvBnAct: conv, BatchNorm,
ReLU. The kernel (ops/csrc/feature_stem.cu, `feature_stem_conv_kernel`)
computes the three at inference, in the module's bf16 policy, in one pass:
it reads the float32 images and writes conv1[0]'s activation, and keeps
the two 8-channel full-resolution maps in shared memory; its header note
says what bounds it and how it is laid out. It replaces no TPU kernel:
the JAX package leaves these convolutions to XLA.

stem takes the images as FeatureNet gets them, the channels-last float32
view [N, 3, H, W], and the three blocks' tensors (`params`), and returns
conv1[0]'s activation [N, 16, ceil(H/2), ceil(W/2)] bf16 with the
channels-last strides the module's path gives it. Whether it runs is the
module's decision (FeatureNet.stem_fusable): the kernel where it applies,
else the module chain itself, which is also its plain version.

Build: the source is one of ops/warp_corr.SOURCES, compiled with the
warp kernels by warp_corr.build() on the first CUDA call and loaded with
ctypes; nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from diffmvs_tpu_torch.ops import warp_corr
from diffmvs_tpu_torch.utils import profiling

# launches of the kernel, in the port's registry (utils/profiling.py), also
# by (N, H, W)
COUNTER = "feature_stem.fused"
# the conv weights of conv0[0], conv0[1] and conv1[0] the kernel is built for
SHAPES = ((8, 3, 3, 3), (8, 8, 3, 3), (16, 8, 5, 5))
_lib = None


def blocks(net):
    """FeatureNet's three ConvBnAct blocks the kernel computes."""
    return (net.conv0[0], net.conv0[1], net.conv1[0])


def params(net):
    """The tensors the kernel reads from a FeatureNet: for each block,
    (conv weight, running mean, running var, gamma, beta, eps)."""
    return tuple((b.conv.weight, b.bn.running_mean, b.bn.running_var,
                  b.bn.weight, b.bn.bias, b.bn.eps) for b in blocks(net))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(warp_corr.build()["feature_stem"]))
        lib.feature_stem_forward.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.feature_stem_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def stem(x, layers):
    """The kernel: one launch for the N images (CUDA tensors only).

    x [N, 3, H, W] float32, channels-last contiguous; layers as `params`
    gives them (float32 contiguous tensors on x's device, the conv weights
    of SHAPES). Returns [N, 16, ceil(H/2), ceil(W/2)] bfloat16, channels
    last.
    """
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"feature_stem: expected images [N, 3, H, W], got "
                         f"{tuple(x.shape)}")
    tensors = [t for layer in layers for t in layer[:5]]
    dev = warp_corr._check_cuda("feature_stem", tensors)
    if x.device != dev:
        raise ValueError("feature_stem: all tensors must be on one CUDA "
                         "device")
    if x.dtype != torch.float32 or any(t.dtype != torch.float32
                                       for t in tensors):
        raise TypeError("feature_stem: images, weights and BatchNorm "
                        "buffers must be float32")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("feature_stem: the images must be channels-last "
                         "contiguous ([N, H, W, 3] in memory)")
    shapes = tuple(tuple(layer[0].shape) for layer in layers)
    bn_shapes = tuple(tuple(t.shape) for layer in layers for t in layer[1:5])
    if shapes != SHAPES or bn_shapes != tuple(
            (s[0],) for s in SHAPES for _ in range(4)):
        raise ValueError(f"feature_stem: parameter shapes {shapes} are not "
                         f"those of FeatureNet's stem {SHAPES}")
    n, _, h, w = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    if min(n, h, w) < 1 or n * ((ho + 15) // 16) * ((wo + 31) // 32) >= 2**31:
        raise ValueError(f"feature_stem: images {tuple(x.shape)} are empty "
                         f"or exceed the kernel's limits (2^31 tiles)")
    out = torch.empty((n, ho, wo, 16), dtype=torch.bfloat16,
                      device=dev).permute(0, 3, 1, 2)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.feature_stem_forward(
            x.data_ptr(), *(layer[0].data_ptr() for layer in layers),
            *(t.data_ptr() for layer in layers for t in layer[1:5]),
            *(float(layer[5]) for layer in layers), out.data_ptr(), n, h, w,
            stream)
    if err != 0:
        raise RuntimeError(f"feature_stem: kernel launch failed, cudaError "
                           f"{err}")
    profiling.count(COUNTER, key=(n, h, w))
    return out
