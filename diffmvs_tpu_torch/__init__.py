"""diffmvs_tpu_torch -- the PyTorch / CUDA port of diffmvs_tpu.

Runs DiffMVS / CasDiffMVS export-mode inference and CasDiffMVS training
on an NVIDIA H100, with the plane-sweep warp + group correlation and its
backward as hand-written CUDA kernels (ops/csrc/warp_corr.cu,
ops/csrc/warp_corr_bwd.cu). Imports torch, numpy and the standard library
only: nothing of JAX and nothing of the JAX package, which stays beside
it as the reference.

Layout mirrors diffmvs_tpu:
  config.py  -- ModelConfig, the presets, TrainConfig
  geometry/  -- inverse-depth transforms, plane-sweep coordinates,
                bilinear sampling, convex upsampling
  ops/       -- correlation volumes, soft-argmax, resizes, the CUDA kernels
  nn/        -- conv wrappers, FPN, context net, 3D regularization, UNet
  models/    -- stage heads, diffusion refinement, the top model, the loss
  api.py     -- DepthRunner
  train/     -- schedules, optimizer state, train/eval steps, checkpoints,
                the epoch loop
  tools/     -- weights carried across from the JAX package, profiling
  utils/     -- synthetic inputs and batches, metrics, image summaries
"""

__version__ = "0.1.0"

from diffmvs_tpu_torch.config import (  # noqa: F401
    CASDIFFMVS,
    DIFFMVS,
    MODEL_PRESETS,
    ModelConfig,
)
