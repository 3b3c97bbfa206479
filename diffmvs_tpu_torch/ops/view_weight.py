"""PixelViewWeight's conv stack as one hand-written CUDA kernel.

nn/costreg.PixelViewWeight weighs each source view's correlation volume:
conv3d (G -> 8, no bias) -> BatchNorm -> ReLU -> conv3d (8 -> 1, bias) ->
sigmoid -> max over D, all in float32. The kernel (ops/csrc/
pixel_view_weight.cu, `pvw_conv3d_kernel`) computes that in one pass over
the stacked correlation volume of all source views, for BatchNorm in eval
form (its running statistics); its header note says what bounds it and
how it is laid out. It replaces no TPU kernel: the JAX package leaves the
module to XLA's convolutions.

view_weights takes the stacked volume cor_feats [V-1, B, D, H, W, G] (the
layout ops/correlation.aggregate_views takes) and the module's tensors
(`weights`), and returns the view weights [V-1, B, H, W] float32. Whether
it runs is the module's decision (PixelViewWeight.views): the kernel
where it applies, else the module itself, view by view, which is also
its plain version.

Build: native.build() finds the source in ops/csrc/ and compiles it on the
first CUDA call, and native.function() loads it; nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import torch

from diffmvs_tpu_torch.ops import native
from diffmvs_tpu_torch.utils import profiling

# launches of the kernel, in the port's registry (utils/profiling.py), also
# by (V-1, B, D, H, W, G)
COUNTER = "pixel_view_weight.fused"
GROUPS = (4, 8)
_KERNEL = ("pixel_view_weight", "pixel_view_weight_forward",
           "ii" + "p" * 6 + "f" + "p" * 3 + "iiii")


def weights(module):
    """The tensors the kernel reads from a PixelViewWeight, as
    (w1, bn_mean, bn_var, bn_gamma, bn_beta, bn_eps, w2, b2)."""
    block, conv2 = module.conv
    bn = block.bn
    return (block.conv.weight, bn.running_mean, bn.running_var, bn.weight,
            bn.bias, bn.eps, conv2.weight, conv2.bias)


def view_weights(cor_feats, w1, mean, var, gamma, beta, eps, w2, b2):
    """The kernel: one launch for all V-1 views (CUDA tensors only).

    cor_feats [V-1, B, D, H, W, G] contiguous, float32 or bfloat16, G = 4
    or 8; the parameters and buffers as `weights` gives them (float32,
    contiguous, on the same device). Returns [V-1, B, H, W] float32.
    """
    if cor_feats.dim() != 6:
        raise ValueError(f"pixel_view_weight: expected [V-1, B, D, H, W, G], "
                         f"got {tuple(cor_feats.shape)}")
    v, b, d, h, w, g = cor_feats.shape
    params = (w1, mean, var, gamma, beta, w2, b2)
    dev = native.device("pixel_view_weight", (cor_feats, *params))
    if g not in GROUPS:
        raise ValueError(f"pixel_view_weight: the kernel takes G in {GROUPS}, "
                         f"got {g}")
    if cor_feats.dtype not in native.DTYPE_CODE:
        raise TypeError(f"pixel_view_weight: the volume must be float32 or "
                        f"bfloat16, got {cor_feats.dtype}")
    if any(t.dtype != torch.float32 for t in params):
        raise TypeError("pixel_view_weight: weights and BatchNorm buffers "
                        "must be float32")
    shapes = (w1.shape, mean.shape, var.shape, gamma.shape, beta.shape,
              w2.shape, b2.shape)
    if shapes != ((8, g, 3, 3, 3), (8,), (8,), (8,), (8,), (1, 8, 3, 3, 3),
                  (1,)):
        raise ValueError(f"pixel_view_weight: parameter shapes "
                         f"{[tuple(s) for s in shapes]} are not those of "
                         f"PixelViewWeight({g})")
    if min(v, b, d, h, w) < 1 or v * b > 65535 or h * w * g >= 2 ** 31:
        raise ValueError(f"pixel_view_weight: volume {tuple(cor_feats.shape)}"
                         f" is empty or exceeds the kernel's limits (65535 "
                         f"volumes, 2^31 values a plane)")
    if cor_feats.data_ptr() % 16:
        raise ValueError("pixel_view_weight: the volume must be 16-byte "
                         "aligned")
    out = torch.empty((v, b, h, w), dtype=torch.float32, device=dev)
    native.launch(
        "pixel_view_weight", native.function(*_KERNEL), dev,
        native.DTYPE_CODE[cor_feats.dtype], g, cor_feats.data_ptr(),
        w1.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), float(eps), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), v * b, d, h, w)
    profiling.count(COUNTER, key=(v, b, d, h, w, g))
    return out

