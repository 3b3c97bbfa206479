"""High-level inference API (PyTorch port).

    import diffmvs_tpu_torch.api as mvs

    runner = mvs.DepthRunner.from_checkpoint("casdiffmvs_dtu.ckpt",
                                             preset="casdiffmvs")
    runner = mvs.DepthRunner.from_checkpoint("logdir/model_000015")  # JAX
    depth, confidences = runner(imgs, proj_matrices, depth_values)

imgs: [B, V, H, W, 3] float32 in [0, 1] or raw uint8 (ref view first);
proj_matrices: {stage1..4: [B, V, 2, 4, 4]} (extrinsic, intrinsic);
depth_values: [B, ND] inverse-depth linspace. numpy arrays or tensors.

Counterpart of diffmvs_tpu/api.py:DepthRunner without the TPU machinery:
the warp kernel is exact everywhere, so there is no miss guard and no
fallback. The runner works on CUDA unless device="cpu" is asked for; it
never moves to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from diffmvs_tpu_torch.config import MODEL_PRESETS, ModelConfig
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.utils import profiling

# constant schedule buffers the reference registers on each refinement
# block; the port recomputes them (models/schedule.py)
SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance")


def set_f32_precision():
    """Full float32 matmuls and convolutions on CUDA (no TF32), matching
    the JAX package's `highest` precision. Set for either compute dtype:
    under bfloat16 the float32 convs that remain (PixelViewWeight's, in
    training and on width shards; at inference its hand-written kernel
    computes them in float32 whatever this sets) would otherwise run in
    TF32, which cuDNN allows by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None means CUDA; asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("diffmvs_tpu_torch: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def upload(x, device, non_blocking: bool = False) -> torch.Tensor:
    """x (a numpy array or a tensor) as a tensor on `device`, counting the
    bytes copied from host memory as upload.pinned_bytes or
    upload.pageable_bytes (a numpy array's memory counts as pageable)."""
    x = torch.as_tensor(x)
    out = x.to(device, non_blocking=non_blocking)
    if x.device.type == "cpu" and out.device.type != "cpu":
        profiling.count("upload.pinned_bytes" if x.is_pinned()
                        else "upload.pageable_bytes",
                        x.numel() * x.element_size())
    return out


def clean_reference_state_dict(state_dict: Dict) -> Dict:
    """Drop what a released reference checkpoint carries beyond the port's
    module tree: the `update_block.{i}.*` ModuleList aliases of
    `update_block_depth{i+2}.*` (checked equal first) and the refinement
    blocks' constant schedule buffers."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("update_block."):
            idx, rest = k[len("update_block."):].split(".", 1)
            twin = f"update_block_depth{int(idx) + 2}.{rest}"
            if twin not in state_dict or not torch.equal(
                    torch.as_tensor(v), torch.as_tensor(state_dict[twin])):
                raise ValueError(f"checkpoint alias {k} differs from {twin}")
            continue
        if (k.startswith("update_block_depth")
                and k.split(".", 1)[1] in SCHEDULE_BUFFERS):
            continue
        out[k] = v
    return out


class DepthRunner:
    """Export-mode inference on one device, under torch.inference_mode().

    The DDIM noise comes from a torch.Generator on the runner's device,
    seeded from `seed` on every call unless the caller passes one. warp:
    the model's warp + correlation (CasDiffMVS's argument)."""

    def __init__(self, cfg: ModelConfig, state_dict: Optional[Dict] = None,
                 device=None, seed: int = 0, warp=None):
        self.device = resolve_device(device)
        set_f32_precision()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = CasDiffMVS(cfg, warp=warp)
        if state_dict is not None:
            model.load_state_dict(clean_reference_state_dict(state_dict),
                                  strict=True)
        self.cfg = cfg
        self.seed = seed
        self.model = model.to(self.device).eval()

    @staticmethod
    def _preset(preset: str, overrides) -> ModelConfig:
        cfg = MODEL_PRESETS[preset]
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    @classmethod
    def from_random(cls, preset: str = "casdiffmvs", image_hw=(512, 640),
                    views: int = 3, device=None, seed: int = 0,
                    **overrides) -> "DepthRunner":
        """Random-weight runner (torch default init from `seed`). image_hw
        and views mirror the JAX runner's signature; the weights do not
        depend on them."""
        del image_hw, views
        return cls(cls._preset(preset, overrides), device=device, seed=seed)

    @classmethod
    def from_state_dict(cls, state_dict: Dict, preset: str = "casdiffmvs",
                        device=None, seed: int = 0,
                        **overrides) -> "DepthRunner":
        """Weights under the reference's key names (a released checkpoint's
        'model' entry, or tools.jax_import.state_dict_from_jax)."""
        return cls(cls._preset(preset, overrides), state_dict,
                   device=device, seed=seed)

    @classmethod
    def from_checkpoint(cls, path: str, preset: str = "casdiffmvs",
                        device=None, seed: int = 0,
                        **overrides) -> "DepthRunner":
        """Load a checkpoint: one of the reference's released .ckpt files
        (a pickle: load only checkpoints from a source you trust), an
        orbax checkpoint directory the JAX package wrote, or a training
        logdir of either (its newest epoch; train/checkpoint.py)."""
        from diffmvs_tpu_torch.train.checkpoint import load_variables

        cfg = cls._preset(preset, overrides)
        return cls(cfg, load_variables(path, cfg), device=device, seed=seed)

    def __call__(self, imgs, proj_matrices, depth_values,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, list]:
        """Returns (depth [B, H, W], [full-res confidences]) as tensors on
        the runner's device. One "runner.call" span, the inputs' copy to
        the device in "runner.upload" and the model in "runner.forward"
        (utils/profiling.py)."""
        dev = self.device
        with profiling.span("runner.call"), torch.inference_mode():
            with profiling.span("runner.upload"):
                imgs = upload(imgs, dev)
                projs = {k: upload(v, dev) for k, v in proj_matrices.items()}
                dv = upload(depth_values, dev)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(self.seed)
            with profiling.span("runner.forward"):
                out = self.model(imgs, projs, dv, generator=generator,
                                 export=True)
        return out["depth"][-1], out["photometric_confidence"]
