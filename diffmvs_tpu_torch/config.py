"""Typed model and training configuration for DiffMVS / CasDiffMVS
(PyTorch port).

Counterpart of diffmvs_tpu/config.py without the TPU layout flags (warp
kernel selection, s2d layouts, unrolling): the port computes each
operation once, in NCHW, and the plane-sweep warp always goes through
ops.correlation.warp_and_correlate. The compute dtype and remat are the
JAX package's: bfloat16 conv stacks over float32 parameters, and each
refinement iteration recomputed in the backward pass. TrainConfig keeps
the JAX package's mesh fields: dp data ranks times sp width shards, one
process per card under torchrun (parallel/distributed.py,
parallel/spatial.py). EvalConfig and the per-scene fusion tables serve
cli/test.py.

Per-stage hyperparameters are 3-tuples indexed by stage (stage 0 = 1/8-res
initialization, stage 1 = 1/4-res refinement, stage 2 = 1/2-res
refinement; stage_iters[2] == 0 selects the DiffMVS variant).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Triple = Tuple[float, float, float]
ITriple = Tuple[int, int, int]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture + diffusion hyperparameters."""

    # depth sampling
    numdepth_initial: int = 48     # hypotheses for the 1/8-res plane sweep
    numdepth: int = 384            # 1/numdepth = minimum inverse-depth interval

    # diffusion schedule per stage
    scale: Triple = (0.0, 0.5, 0.1)            # noise scale
    timesteps: ITriple = (1000, 1000, 1000)
    sampling_timesteps: ITriple = (1, 1, 1)    # DDIM steps at inference
    ddim_eta: Triple = (0.0, 1.0, 1.0)

    # per-stage net dims
    hidden_dim: ITriple = (0, 32, 20)          # GRU hidden state dims
    context_dim: ITriple = (32, 32, 16)        # context feature dims
    unet_dim: ITriple = (0, 16, 8)             # UNet base dims
    stage_iters: ITriple = (1, 3, 3)           # GRU iterations per stage
    cost_dim_stage: ITriple = (4, 4, 4)        # correlation groups G per stage
    cost_num: ITriple = (0, 4, 4)              # depth samples per refinement iter

    # confidence-adaptive hypothesis range
    min_radius: float = 0.125
    max_radius: float = 8.0

    # depth interval ratio per stage
    depth_intervals_ratio: Triple = (4.0, 2.0, 1.0)

    # feature extractor dims
    base_channels: int = 8

    # compute dtype for the conv stacks ("float32" or "bfloat16"); the
    # parameters, geometry, soft-argmax and the diffusion state stay
    # float32 whatever this says
    compute_dtype: str = "float32"

    # recompute each refinement iteration in the backward pass instead of
    # keeping its activations (torch.utils.checkpoint per iteration)
    remat: bool = False

    @property
    def is_cascade(self) -> bool:
        """CasDiffMVS iff stage 2 runs refinement iterations."""
        return self.stage_iters[2] > 0

    @property
    def up_ratio(self) -> int:
        """Final convex-upsampling ratio."""
        return 2 if self.is_cascade else 4

    @property
    def feat_dim_stage(self) -> ITriple:
        """FPN output channels per stage."""
        return (48, 32, 16) if self.is_cascade else (48, 32, 0)

    @property
    def ctx_out_dim(self) -> ITriple:
        """ContextNet head dims = hidden + context per stage."""
        return tuple(h + c for h, c in zip(self.hidden_dim, self.context_dim))

    @property
    def unet_dim_mults(self):
        """UNet depth multiplier schedule per stage."""
        return ((1,), (1, 2), (1, 2, 4))

    @property
    def dtype(self) -> torch.dtype:
        """The conv stacks' compute dtype."""
        return COMPUTE_DTYPES[self.compute_dtype]

    def validate(self) -> "ModelConfig":
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r} is not "
                             f"one of {sorted(COMPUTE_DTYPES)}")
        if self.stage_iters[0] < 1 or self.stage_iters[1] < 1:
            raise ValueError("stages 0 and 1 need at least one iteration")
        for s in (1, 2):
            if self.stage_iters[s] > 0 and (
                    self.cost_num[s] < 1 or self.hidden_dim[s] <= 0
                    or self.unet_dim[s] <= 0):
                raise ValueError(f"stage {s} needs cost samples, a hidden "
                                 f"state and a UNet")
        return self


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Inference / benchmark-evaluation configuration (the reference's
    test.py flags)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    dataset: str = "general"       # dtu | tank | eth3d | general
    num_view: int = 5
    max_h: int = 4800
    max_w: int = 6400

    # fusion / post-processing
    geo_mask_thres: int = 2
    geo_pixel_thres: float = 1.0
    geo_depth_thres: float = 0.01
    photo_thres: Triple = (0.3, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration (the reference's train.py flags)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    dataset: str = "dtu"
    epochs: int = 16
    train_epochs: int = -1          # early-stop epoch count (-1 = epochs)
    batch_size: int = 4
    lr: float = 1e-3
    lr_sche: str = "onecycle"       # onecycle | mslr
    lrepochs: str = "10,12,14:2"    # for mslr
    weight_decay: float = 1e-3
    train_views: int = 5
    test_views: int = 5
    seed: int = 123
    loss_rate: float = 0.9          # exponential loss weighting
    conf_weight: float = 0.05       # confidence-loss weight
    grad_clip: float = 2.0
    save_freq: int = 1
    eval_freq: int = 1
    summary_freq: int = 20

    # the (dp, sp) mesh over dp * sp processes: dp data ranks (-1 = the
    # world size torchrun gives / sp), each loading batch_size // dp rows
    # of every global batch, times sp width shards of every map
    # (parallel/distributed.resolve_mesh)
    dp: int = -1
    sp: int = 1

    # gradient accumulation: the batch runs as accum_steps sequential
    # microbatches whose gradients are averaged into ONE optimizer update
    # (train/step.py)
    accum_steps: int = 1

    def validate(self) -> "TrainConfig":
        """The mesh sizes are positive, dp -1 meaning the world size / sp
        (the world size itself is checked where the processes are known,
        parallel/distributed.resolve_mesh)."""
        if self.sp < 1 or (self.dp < 1 and self.dp != -1):
            raise ValueError(f"dp={self.dp}, sp={self.sp}: mesh sizes are "
                             f"positive (dp -1: the world size / sp)")
        return self


# ---------------------------------------------------------------------------
# Canonical presets
# ---------------------------------------------------------------------------

# DiffMVS: single refinement stage at 1/4 res, upsample x4.
DIFFMVS = ModelConfig(
    scale=(0.0, 0.5, 0.0),
    ddim_eta=(0.0, 1.0, 0.0),
    hidden_dim=(0, 32, 0),
    context_dim=(32, 32, 0),
    unet_dim=(0, 16, 8),
    stage_iters=(1, 4, 0),
    cost_dim_stage=(4, 4, 0),
    cost_num=(0, 6, 0),
    min_radius=0.25,
    max_radius=4.0,
)

# CasDiffMVS: cascade refinement at 1/4 then 1/2 res, upsample x2.
CASDIFFMVS = ModelConfig(
    scale=(0.0, 0.5, 0.1),
    ddim_eta=(0.0, 1.0, 1.0),
    hidden_dim=(0, 32, 20),
    context_dim=(32, 32, 16),
    unet_dim=(0, 16, 8),
    stage_iters=(1, 3, 3),
    cost_dim_stage=(4, 4, 4),
    cost_num=(0, 4, 4),
    min_radius=0.125,
    max_radius=8.0,
)

# BlendedMVS-finetuned noise scales used for T&T / ETH3D eval
CASDIFFMVS_MVG = dataclasses.replace(CASDIFFMVS, scale=(0.0, 0.125, 0.025))
DIFFMVS_MVG = dataclasses.replace(DIFFMVS, scale=(0.0, 0.125, 0.0))

# Tanks&Temples uses 96 initial hypotheses
CASDIFFMVS_TANK = dataclasses.replace(CASDIFFMVS_MVG, numdepth_initial=96)
DIFFMVS_TANK = dataclasses.replace(DIFFMVS_MVG, numdepth_initial=96)

MODEL_PRESETS = {
    "diffmvs": DIFFMVS,
    "casdiffmvs": CASDIFFMVS,
    "diffmvs_mvg": DIFFMVS_MVG,
    "casdiffmvs_mvg": CASDIFFMVS_MVG,
    "diffmvs_tank": DIFFMVS_TANK,
    "casdiffmvs_tank": CASDIFFMVS_TANK,
}

# Benchmark eval resolutions
EVAL_RESOLUTIONS = {
    "dtu": (1600, 1152),     # (W, H)
    "tank": (1920, 1056),
    "eth3d": (1920, 1280),
}

# Per-scene fusion hyperparameters for Tanks&Temples and ETH3D (the
# reference's test.py and filter.py)
TANK_PHOTO_THRES = {
    "Family": (0.8, 0.8, 0.95), "Francis": (0.3, 0.6, 0.6),
    "Horse": (0.15, 0.4, 0.8), "Lighthouse": (0.3, 0.8, 0.9),
    "M60": (0.7, 0.8, 0.95), "Panther": (0.3, 0.3, 0.95),
    "Playground": (0.3, 0.8, 0.9), "Train": (0.3, 0.6, 0.95),
    "Auditorium": (0.0, 0.0, 0.0), "Ballroom": (0.3, 0.3, 0.5),
    "Courtroom": (0.0, 0.2, 0.2), "Museum": (0.3, 0.3, 0.7),
    "Palace": (0.3, 0.3, 0.4), "Temple": (0.3, 0.5, 0.5),
}
TANK_DYNAMIC_PARAMS = {  # (dh_view_num, dist_div, rel_diff_div)
    "Family": (2, 12, 1600), "Francis": (9, 8, 1600), "Horse": (2, 4, 1300),
    "Lighthouse": (6, 8, 1600), "M60": (4, 8, 1600), "Panther": (3, 4, 1300),
    "Playground": (6, 8, 1600), "Train": (3, 4, 1600),
    "Auditorium": (2, 4, 1300), "Ballroom": (2, 4, 1300),
    "Courtroom": (2, 4, 1300), "Museum": (2, 4, 1300),
    "Palace": (2, 4, 1300), "Temple": (1, 4, 1500),
}
ETH3D_GEO_MASK_THRES = {
    "bridge": 2,
}  # default 1 for all other ETH3D scenes
ETH3D_GEO_PIXEL_THRES = {
    "courtyard": 0.5, "delivery_area": 0.5, "electro": 1, "facade": 1,
    "kicker": 1, "meadow": 2, "office": 2, "pipes": 2, "playground": 1,
    "relief": 1, "relief_2": 1, "terrace": 0.5, "terrains": 1,
    "botanical_garden": 1, "boulders": 0.5, "bridge": 0.5, "door": 0.5,
    "exhibition_hall": 0.5, "lecture_room": 0.5, "living_room": 0.5,
    "lounge": 2, "observatory": 1, "old_computer": 2, "statue": 1,
    "terrace_2": 0.5,
}
