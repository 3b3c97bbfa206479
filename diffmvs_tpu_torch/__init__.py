"""diffmvs_tpu_torch -- the PyTorch / CUDA port of diffmvs_tpu.

Runs DiffMVS / CasDiffMVS export-mode inference on an NVIDIA H100, with
the plane-sweep warp + group correlation as a hand-written CUDA kernel
(ops/csrc/warp_corr.cu). Imports torch, numpy and the standard library
only: nothing of JAX and nothing of the JAX package, which stays beside
it as the reference.

Layout mirrors diffmvs_tpu:
  config.py  -- ModelConfig and the presets
  geometry/  -- inverse-depth transforms, plane-sweep coordinates,
                bilinear sampling, convex upsampling
  ops/       -- correlation volumes, soft-argmax, resizes, the CUDA kernel
  nn/        -- conv wrappers, FPN, context net, 3D regularization, UNet
  models/    -- stage heads, diffusion refinement, the top model
  api.py     -- DepthRunner
  tools/     -- weights carried across from the JAX package
  utils/     -- synthetic inputs
"""

__version__ = "0.1.0"

from diffmvs_tpu_torch.config import (  # noqa: F401
    CASDIFFMVS,
    DIFFMVS,
    MODEL_PRESETS,
    ModelConfig,
)
