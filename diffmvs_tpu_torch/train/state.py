"""Train state: the model, AdamW behind a global-norm gradient clip, the
learning-rate schedule, and the step and epoch counters.

Counterpart of diffmvs_tpu/train/state.py. The reference's optimizer:
clip_grad_norm_(2.0), then AdamW(lr, betas (0.9, 0.999), eps 1e-8,
weight_decay), decaying every parameter (no BatchNorm exclusion), with
the learning rate set per step by the schedule (train/schedules.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from diffmvs_tpu_torch.api import resolve_device, set_f32_precision
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.train.schedules import make_lr_lambda
from diffmvs_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
    model: CasDiffMVS
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0       # optimizer updates applied so far
    epoch: int = 0      # the next epoch to run

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self, grad_clip: float) -> torch.Tensor:
        """Clip the gradients in .grad by their global norm, take one AdamW
        step and advance the schedule. Returns the norm before clipping
        (a device tensor: nothing waits for the host)."""
        with profiling.span("step.optimizer"):
            norm = torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                                  grad_clip)
            self.optimizer.step()
            self.scheduler.step()
        self.step += 1
        return norm


WARP_KERNELS = ("xla", "pallas", "pallas_full")


def data_parallel_mode(dp: int, sp: int, warp_kernel: str = "xla") -> str:
    """The data-parallel step the JAX package trains with on a (dp, sp)
    mesh whose ModelConfig.warp_kernel is `warp_kernel`
    (diffmvs_tpu/train/loop.py:74-76): "shard", its shard_map step
    (per-rank BatchNorm statistics, averaged), with more than one data
    rank, sp = 1 and a warp kernel other than "xla"; else "global", its
    GSPMD step (global-batch statistics). The port's ModelConfig has no
    warp_kernel (every value runs the same CUDA kernels), so the caller
    passes the JAX configuration's (cli/train.py --warp_kernel)."""
    if warp_kernel not in WARP_KERNELS:
        raise ValueError(f"warp_kernel {warp_kernel!r} is not one of "
                         f"{WARP_KERNELS}")
    return "shard" if dp > 1 and sp == 1 and warp_kernel != "xla" \
        else "global"


def make_optimizer(params, lr: float, weight_decay: float):
    """AdamW with the reference's constants, decay on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(cfg, steps_per_epoch: int = 1000, device=None,
                       seed: int = 0, state_dict: Optional[Dict] = None,
                       warp=None) -> TrainState:
    """Model (torch default init from `seed`, or `state_dict`), optimizer
    and schedule on `device`: CUDA unless device="cpu" is asked for;
    without a card that raises. cfg: TrainConfig. The parameters and the
    optimizer state are float32 for either compute dtype. warp: the
    model's warp + correlation (CasDiffMVS's argument)."""
    dev = resolve_device(device)
    set_f32_precision()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CasDiffMVS(cfg.model, warp=warp)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(dev).train()
    optimizer = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, make_lr_lambda(cfg, steps_per_epoch))
    return TrainState(model, optimizer, scheduler)
