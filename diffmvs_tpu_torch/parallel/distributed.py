"""Data- and width-parallel training across processes (counterpart of
diffmvs_tpu/parallel/mesh.py and the JAX package's two training steps).

The JAX package shards each global batch over the "data" axis of a device
mesh and trains it in one of two ways (diffmvs_tpu/train/loop.py:71-80),
which DataParallel's `mode` names:
  * "global", its default GSPMD step (warp_kernel="xla"): BatchNorm's
    batch statistics come out over the GLOBAL batch
    (parallel/mesh.py:7-8). The port: one process per card under
    torchrun, DistributedDataParallel averaging the gradients, and the
    SyncBatchNorm below, whose statistics are those of the global batch;
    train/step.train_step(dp=...) draws the diffusion noise of the global
    batch on every rank and normalizes each rank's loss by the global
    batch's mask counts, so a step equals the single-process step on the
    whole batch.
  * "shard", its shard_map step (diffmvs_tpu/train/step.py:116-178),
    taken with more than one data rank, sp = 1 and a warp kernel other
    than "xla" (train/state.data_parallel_mode): the reference's
    nn.DataParallel semantics. Each rank's nn.BatchNorms normalize with
    its own rows' statistics, and after the step the running statistics
    are averaged over the ranks (average_statistics: JAX's pmean); DDP
    averages the gradients; each rank's loss divides by its own mask
    counts and each rank draws its own noise from a generator folded with
    its rank (generator(): JAX's fold_in of axis_index("data")).

The mesh is (dp, sp) over dp * sp processes: rank r = d * sp + s holds
rows d of each global batch and column shard s of every map (the "space"
axis, TrainConfig.sp). The sp ranks that share rows d form a space group
(parallel/spatial.py: the halo exchanges, the gathers and the GroupNorm
moments run over it). Every reduction over the data axis runs over the
whole world instead, each rank holding its block of rows and columns:
SyncBatchNorm's statistics are those of the global batch at full width,
DDP's gradient mean over the world times the world-size scaling of the
masked means (train/step.global_denominators) sums the space ranks'
gradients and averages the data ranks', and the scalars are world means.
So no data-axis group is built.
"""

from __future__ import annotations

import os
import random
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffmvs_tpu_torch.api import resolve_device
from diffmvs_tpu_torch.parallel import spatial


def resolve_mesh(dp: int, sp: int, world_size: int) -> int:
    """The data-parallel size TrainConfig's (dp, sp) ask for in a world of
    world_size processes: dp * sp must be the world size; dp = -1 takes
    world_size / sp."""
    if sp < 1 or (dp < 1 and dp != -1):
        raise ValueError(f"dp={dp}, sp={sp}: mesh sizes are positive (dp "
                         f"-1: the world size / sp)")
    if dp == -1:
        if world_size % sp:
            raise ValueError(
                f"sp={sp} but the world has {world_size} process(es): start "
                f"a multiple of {sp} processes (torchrun --nproc_per_node "
                f"{sp} * dp)")
        dp = world_size // sp
    if dp * sp != world_size:
        raise ValueError(f"dp={dp} x sp={sp} but the world has {world_size} "
                         f"process(es): start one process per rank "
                         f"(torchrun --nproc_per_node {dp * sp})")
    return dp


def space_group(sp: int):
    """This rank's spatial.SpaceGroup in the initialized world: ranks
    d * sp ... d * sp + sp - 1 share rows d. Every rank creates every
    group, as new_group asks. None for sp = 1."""
    if sp == 1:
        return None
    rank, world_size = dist.get_rank(), dist.get_world_size()
    resolve_mesh(-1, sp, world_size)
    mine = None
    for d in range(world_size // sp):
        group = dist.new_group(list(range(d * sp, (d + 1) * sp)))
        if d == rank // sp:
            mine = group
    return spatial.SpaceGroup(mine, rank % sp, sp)


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


MODES = ("global", "shard")


def fold_seed(seed: int, rank: int) -> int:
    """A seed of its own for `rank`, drawn from seed and rank (the
    counterpart of jax.random.fold_in): rank 0's differs from seed too."""
    return random.Random(f"{seed}:fold:{rank}").getrandbits(63)


class DataParallel:
    """The model's training view on the (dp, sp) mesh of the initialized
    (default) process group: with a space group (space_group(sp), sp > 1)
    its convolutions and GroupNorms converted to their width-sharded forms
    (spatial.shard_width, in place); in mode "global" its BatchNorms
    converted to SyncBatchNorm over the world (in place), in mode "shard"
    left as the rank's own nn.BatchNorms; and a DistributedDataParallel
    wrapper (`module`) with broadcast_buffers=False: in "global" every
    rank updates the running statistics alike from the global batch, in
    "shard" average_statistics() averages them after the step, so no
    rank's buffers overwrite another's. The model itself stays unwrapped,
    for its state_dict and for validation. "shard" shards the batch only,
    as JAX's shard_map step asserts: with a space group it raises."""

    def __init__(self, model: nn.Module, space=None, mode: str = "global"):
        if mode not in MODES:
            raise ValueError(f"data-parallel mode {mode!r} is not one of "
                             f"{MODES}")
        if mode == "shard" and space is not None:
            raise ValueError(
                f"data-parallel mode 'shard' shards the batch only: with "
                f"sp = {space.size} use the 'global' mode (JAX's shard_map "
                f"step asserts sp == 1 likewise)")
        self.mode = mode
        self.space = space
        if space is not None:
            spatial.shard_width(model, space)
        if mode == "global":
            convert_sync_batchnorm(model)
        dev = next(model.parameters()).device
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        sp = 1 if space is None else space.size
        self.data_size = resolve_mesh(-1, sp, self.world_size)
        self.data_rank = self.rank // sp
        self.module = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)

    def generator(self, seed: int, device) -> torch.Generator:
        """The generator the training loop draws the diffusion noise from:
        in "global" seeded with `seed` on every rank (each draws the global
        batch's noise and keeps its rows), in "shard" with fold_seed(seed,
        data rank) (each draws its own rows' noise)."""
        if self.mode == "shard":
            seed = fold_seed(seed, self.data_rank)
        return torch.Generator(device=device).manual_seed(seed)

    def average_statistics(self):
        """Mode "shard": every BatchNorm's running mean and variance set to
        their mean over the ranks (JAX's pmean of the updated
        batch_stats), in one all_reduce."""
        bufs = [b for m in self.module.module.modules()
                if isinstance(m, nn.modules.batchnorm._BatchNorm)
                for b in (m.running_mean, m.running_var)]
        if not bufs:
            return
        with torch.no_grad():
            flat = _all_reduce(torch.cat([b.flatten() for b in bufs]))
            flat /= self.world_size
            i = 0
            for b in bufs:
                b.copy_(flat[i:i + b.numel()].view_as(b))
                i += b.numel()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks (no gradient)."""
        return _all_reduce(t.detach().clone())

    def mean(self, scalars: Dict[str, torch.Tensor]) -> Dict[str,
                                                              torch.Tensor]:
        """Each scalar averaged over the ranks (JAX's pmean)."""
        return _mean(scalars, self.sum, self.world_size)

    def full_width(self, maps: Dict[str, torch.Tensor]) -> Dict[
            str, torch.Tensor]:
        """Each [..., w] map of this rank's columns (at full resolution or
        a stride of it) at full width: a collective over the space group,
        without gradient."""
        if self.space is None:
            return maps
        w = max(v.shape[-1] for v in maps.values())
        shard = self.space.shard(w, next(iter(maps.values())).device)
        with torch.no_grad():
            return {k: shard.gather(v, -1, w // v.shape[-1])
                    for k, v in maps.items()}

    def barrier(self):
        dist.barrier()


def _mean(scalars, total, parts):
    """Each scalar's sum by `total` over `parts` ranks, divided by parts."""
    keys = list(scalars)
    sums = total(torch.stack([torch.as_tensor(scalars[k]).float()
                              for k in keys]))
    return dict(zip(keys, (sums / parts).unbind(0)))


def space_mean(scalars, space):
    """Each scalar averaged over the space group (no gradient)."""
    return _mean(scalars, lambda t: spatial.all_reduce(t.detach().clone(),
                                                       space), space.size)

