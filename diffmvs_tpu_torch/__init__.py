"""diffmvs_tpu_torch -- the PyTorch / CUDA port of diffmvs_tpu.

Runs DiffMVS / CasDiffMVS export-mode inference, the scene export CLI
with fusion and DTU evaluation, and CasDiffMVS training on an NVIDIA
H100, with the plane-sweep warp + group correlation, its backward and its
precomputed-corner mode as hand-written CUDA kernels (ops/csrc/
warp_corr.cu, warp_corr_bwd.cu, warp_corr_pre.cu). Imports torch, numpy,
PIL and the standard library (scipy for DTU's .mat masks): nothing of JAX
and nothing of the JAX package, which stays beside it as the reference.

Layout mirrors diffmvs_tpu:
  config.py  -- ModelConfig, the presets, EvalConfig, TrainConfig, the
                per-scene fusion tables
  geometry/  -- inverse-depth transforms, plane-sweep coordinates,
                bilinear sampling, convex upsampling
  ops/       -- correlation volumes, soft-argmax, resizes, the CUDA kernels
  nn/        -- conv wrappers, FPN, context net, 3D regularization, UNet
  models/    -- stage heads, diffusion refinement, the top model, the loss
  api.py     -- DepthRunner
  data/      -- PFM/cam/pair codecs, resizes, the native JPEG loader, the
                eval MVSDataset and its DataLoader
  fusion/    -- consistency fusion on the card, PLY files, point metrics
  cli/       -- test.py (depth export + fusion), eval_dtu.py
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
