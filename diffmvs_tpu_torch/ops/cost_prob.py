"""CostRegNet's `prob` convolution as one hand-written CUDA kernel.

nn/costreg.CostRegNet ends in `prob`, a 3x3x3 convolution from 8 channels
to 1 with zero padding 1 and no bias, in the model's compute dtype. cuDNN
has no tensor-core engine for one output channel and runs it as a generic
implicit-GEMM kernel. The kernel (ops/csrc/cost_prob.cu,
`prob_conv3d_kernel`) computes it in float32 FMAs on the CUDA cores and
rounds once to the compute dtype; its header note says what bounds it and
how it is laid out. It replaces no TPU kernel: the JAX package leaves the
layer to XLA's convolutions.

prob_conv takes the layer's input x [B, 8, D, H, W] (float32 or bfloat16,
the channels-last strides CostRegNet's convolutions give it; any other
layout is made channels-last first) and the module's float32 weight [1, 8,
3, 3, 3], and returns the logits [B, D, H, W] in x's dtype: the module's
`prob(x)[:, 0]`. Whether it runs is the module's decision
(CostRegNet.prob_fusable): the kernel where it applies, else the module
itself, which is also its plain version.

Build: native.build() finds the source in ops/csrc/ and compiles it on the
first CUDA call, and native.function() loads it; nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import torch

from diffmvs_tpu_torch.ops import native
from diffmvs_tpu_torch.utils import profiling

# launches of the kernel, in the port's registry (utils/profiling.py), also
# by (B, D, H, W)
COUNTER = "cost_prob.fused"
WEIGHT_SHAPE = (1, 8, 3, 3, 3)
_KERNEL = ("cost_prob", "cost_prob_forward", "ipppiiii")


def prob_conv(x, weight):
    """The kernel: one launch for the B volumes (CUDA tensors only).

    x [B, 8, D, H, W] float32 or bfloat16; weight [1, 8, 3, 3, 3] float32,
    contiguous, on x's device. Returns [B, D, H, W] in x's dtype.
    """
    if x.dim() != 5 or x.shape[1] != 8:
        raise ValueError(f"cost_prob: expected [B, 8, D, H, W], got "
                         f"{tuple(x.shape)}")
    if tuple(weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"cost_prob: weight shape {tuple(weight.shape)} is "
                         f"not the layer's {WEIGHT_SHAPE}")
    if weight.dtype != torch.float32:
        raise TypeError(f"cost_prob: the weight must be float32, got "
                        f"{weight.dtype}")
    if x.dtype not in native.DTYPE_CODE:
        raise TypeError(f"cost_prob: the volume must be float32 or "
                        f"bfloat16, got {x.dtype}")
    # [B, D, H, W, 8] contiguous: the layout the kernel reads
    voxels = x.contiguous(memory_format=torch.channels_last_3d).permute(
        0, 2, 3, 4, 1)
    dev = native.device("cost_prob", (voxels, weight))
    b, d, h, w, _ = voxels.shape
    if min(b, d, h, w) < 1 or b > 65535:
        raise ValueError(f"cost_prob: volume {tuple(x.shape)} is empty or "
                         f"exceeds the kernel's limit of 65535 samples")
    if voxels.data_ptr() % 16:
        raise ValueError("cost_prob: the volume must be 16-byte aligned")
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=dev)
    native.launch(
        "cost_prob", native.function(*_KERNEL), dev,
        native.DTYPE_CODE[x.dtype], voxels.data_ptr(), weight.data_ptr(),
        out.data_ptr(), b, d, h, w)
    profiling.count(COUNTER, key=(b, d, h, w))
    return out
