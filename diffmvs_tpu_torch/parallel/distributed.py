"""Data-parallel training across processes (counterpart of
diffmvs_tpu/parallel/mesh.py and the JAX package's data-parallel step).

The JAX package shards each global batch over the "data" axis of a device
mesh. Its default training step (warp_kernel="xla") trains through GSPMD,
where BatchNorm's batch statistics come out over the GLOBAL batch
(parallel/mesh.py:7-8); only its shard_map step, which the Pallas warp
kernels need, keeps per-shard statistics and averages them with pmean
(train/step.py:124-127). The port follows the default: one process per
card under torchrun, DistributedDataParallel averaging the gradients, and
the SyncBatchNorm below, whose statistics are those of the global batch.
train/step.train_step(dp=...) draws the diffusion noise of the global
batch on every rank and normalizes each rank's loss by the global batch's
mask counts, so a step equals the single-process step on the whole batch.

Width sharding (the mesh's "space" axis, TrainConfig.sp) is not ported: it
needs convolution halo exchanges, and one H100 holds the training cell.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.api import resolve_device


def resolve_mesh(dp: int, sp: int, world_size: int) -> int:
    """The data-parallel size TrainConfig's (dp, sp) ask for in a world of
    world_size processes: dp = -1 takes the world size; any other dp must
    equal it; sp must be 1."""
    if sp != 1:
        raise ValueError(
            f"sp={sp}: width sharding is not ported (it needs convolution "
            f"halo exchanges, and one card holds the training cell); use "
            f"sp=1")
    if dp == -1:
        return world_size
    if dp != world_size:
        raise ValueError(f"dp={dp} but the world has {world_size} "
                         f"process(es): start one process per rank "
                         f"(torchrun --nproc_per_node {dp})")
    return dp


def backend_for(device) -> str:
    """NCCL for CUDA, gloo for the CPU: chosen by the device asked for."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None):
    """Joins the process group torchrun describes (env://: WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Returns (rank,
    world_size, device): the device is `device` resolved (CUDA unless
    "cpu" is asked for; without a card that raises), under torchrun on
    CUDA the card of LOCAL_RANK. A single process (no WORLD_SIZE, or 1)
    joins nothing."""
    dev = resolve_device(device)
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return 0, 1, dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://")
    return dist.get_rank(), dist.get_world_size(), dev


def _all_reduce(t):
    """t summed over the ranks of the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t)
    return t


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch.

    Forward: per channel, the sum, the sum of squares and the count of the
    input, accumulated in float64 (as torch's CPU BatchNorm accumulates)
    and summed over the ranks by one all_reduce, give the mean and the
    biased variance; the normalization runs in float32. In float32, E[x^2]
    - E[x]^2 loses the variance where the mean is large against the
    spread (the image-fed first layers of ContextNet): on one process the
    gradients then differed from nn.BatchNorm's by up to 1e-3 (DiffMVS, 64
    x 32), against 2.6e-5 with float64 sums. Backward: torch's BatchNorm
    backward, with the sums of dy and of dy * (x - mean), again in float64
    (as torch's CPU BatchNorm backward accumulates them), summed over the
    ranks by one all_reduce, so each rank's input gradient is that of
    every rank's loss through the global statistics (what
    torch.nn.SyncBatchNorm computes). It is written out, not left to
    autograd through a differentiable all_reduce, so that the backward
    keeps the input alone rather than its float64 copy."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        x64 = x.double()
        moments = _all_reduce(torch.cat([
            x64.sum(dims), (x64 * x64).sum(dims),
            x64.new_full((1,), x.numel() // c)]))
        del x64
        n = moments[2 * c]
        mean = moments[:c] / n
        var = (moments[c:2 * c] / n - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps).float()
        ctx.save_for_backward(x, weight, mean, invstd, n)
        mean, var, n = mean.float(), var.float(), n.float()
        y = (x.float() - mean.view(shape)) * invstd.view(shape)
        y = y * weight.view(shape) + bias.view(shape)
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, gy, *_):
        x, weight, mean64, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        g64 = gy.double()
        sum_dy = g64.sum(dims)
        sum_dy_xmu = (g64 * (x.double() - mean64.view(shape))).sum(dims)
        del g64
        glob = _all_reduce(torch.cat([sum_dy, sum_dy_xmu]))
        mean_dy = (glob[:c] / n).float().view(shape)
        mean_dy_xmu = (glob[c:] / n).float().view(shape)
        inv = invstd.view(shape)
        xmu = x.float() - mean64.float().view(shape)
        dx = (gy.float() - mean_dy - xmu * inv * inv * mean_dy_xmu) * inv \
            * weight.view(shape)
        return (dx.to(x.dtype), (sum_dy_xmu * invstd.double()).float(),
                sum_dy.float(), None)


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the batch of every rank of the process group, for 4-D
    and 5-D input, on any backend (torch.nn.SyncBatchNorm takes CUDA
    tensors only); affine, with running statistics, as the model's.

    Training: _SyncBatchNormFn, whose input gradients flow through the
    global statistics. The running variance takes the unbiased variance
    with n = the global count, as torch's BatchNorm (and the reference)
    does. A bfloat16 input is normalized in float32 against the float32
    affine and statistics and rounded once, as the port's BatchNorm does.
    Without a process group the statistics are the local batch's. Eval:
    the running statistics, as nn.BatchNorm."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__(num_features, eps, momentum, affine=True,
                         track_running_stats=True)

    def _check_input_dim(self, x):
        if x.dim() not in (4, 5):
            raise ValueError(f"expected 4-D or 5-D input, got {x.dim()}-D")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        y, mean, var, n = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                                 self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = self.momentum
            unbiased = var * n / (n - 1).clamp_min(1)
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * unbiased)
        return y


def convert_sync_batchnorm(module: nn.Module):
    """Swaps every BatchNorm2d / BatchNorm3d under `module` (in place) for
    a SyncBatchNorm holding the same parameter and buffer tensors, so the
    state_dict keys, an optimizer built over the parameters and the
    running statistics carry over. Returns the module."""
    for name, child in module.named_children():
        if isinstance(child, (nn.BatchNorm2d, nn.BatchNorm3d)):
            if not (child.affine and child.track_running_stats
                    and child.momentum is not None):
                raise ValueError(f"{name}: SyncBatchNorm is affine with "
                                 f"running statistics and a momentum")
            sync = SyncBatchNorm(child.num_features, child.eps,
                                 child.momentum)
            sync.weight, sync.bias = child.weight, child.bias
            for buf in ("running_mean", "running_var",
                        "num_batches_tracked"):
                setattr(sync, buf, getattr(child, buf))
            sync.train(child.training)
            setattr(module, name, sync)
        else:
            convert_sync_batchnorm(child)
    return module


class DataParallel:
    """The model's data-parallel training view in the initialized (default)
    process group: its BatchNorms converted to SyncBatchNorm (in place)
    and a DistributedDataParallel wrapper (`module`) with
    broadcast_buffers=False: every rank updates the running statistics
    alike from the global batch, so no rank's buffers overwrite another's.
    The model itself stays unwrapped, for its state_dict and for
    validation."""

    def __init__(self, model: nn.Module):
        convert_sync_batchnorm(model)
        dev = next(model.parameters()).device
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.module = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks (no gradient)."""
        return _all_reduce(t.detach().clone())

    def mean(self, scalars: Dict[str, torch.Tensor]) -> Dict[str,
                                                              torch.Tensor]:
        """Each scalar averaged over the ranks (JAX's pmean)."""
        keys = list(scalars)
        total = self.sum(torch.stack([torch.as_tensor(scalars[k]).float()
                                      for k in keys]))
        return dict(zip(keys, (total / self.world_size).unbind(0)))

    def barrier(self):
        dist.barrier()

