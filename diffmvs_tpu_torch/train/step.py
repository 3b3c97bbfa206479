"""Train and eval steps.

Counterpart of diffmvs_tpu/train/step.py (make_train_step,
make_eval_step): the loss, its gradients, the clip and the AdamW step,
and the init/final absolute-depth-error metrics. Steps return device
tensors and never wait for the host; the loop fetches scalars when it
logs them.

Data parallelism (train_step's dp, parallel/distributed.DataParallel)
follows one of the JAX package's two steps, by dp.mode. In "global" (its
default GSPMD step, whose global batch is sharded over devices) every
rank draws the timesteps and noise of the global batch from the one
seeded generator and keeps its rows, each rank's masked means divide by
the global batch's mask counts (times the world size, which DDP's mean of
the gradients divides out), BatchNorm syncs over the global batch, and
the scalars are averaged over the ranks (pmean). A step then equals the
single-process step on the global batch. In "shard" (its shard_map step,
diffmvs_tpu/train/step.py:116-178) each rank runs the single-process step
on its rows: its own noise (its generator, DataParallel.generator, or its
rows of the given train_overrides), its own mask counts and its own
BatchNorm statistics; DDP averages the gradients, the updated running
statistics are averaged after the backward pass, and the scalars over
the ranks. With accum_steps > 1 each rank splits its own rows into
microbatches.

Width sharding (dp.space, the mesh's "space" axis): each rank holds its
rows and its columns of the global batch (parallel/spatial.column_slice)
and the model is width-sharded. The noise is drawn at full width and
sliced to the rank's columns, the counts of the masked means and the
world-size scaling span both axes, so DDP's mean over the world sums the
space ranks' gradients and averages the data ranks'; the per-image
metrics sum their numerators and counts over the space group. eval_step
takes a space group alone: its ranks evaluate the same rows together.

Spans (utils/profiling.py): train_step is one "step", holding
"step.upload", then per microbatch "step.forward", "step.loss" and
"step.backward", then "step.optimizer" (the clip, AdamW and the
schedule, in TrainState.apply_gradients). "step.backward" lends itself
to autograd's engine: what its device thread does there (remat's
recomputation, K2's launches) counts under it.
"""

from __future__ import annotations

from typing import Dict, Optional

import contextlib

import numpy as np
import torch

from diffmvs_tpu_torch.api import upload
from diffmvs_tpu_torch.models.loss import compute_inverse_loss
from diffmvs_tpu_torch.parallel import spatial
from diffmvs_tpu_torch.parallel.distributed import space_mean
from diffmvs_tpu_torch.utils import profiling
from diffmvs_tpu_torch.utils.metrics import abs_depth_error


def batch_to_device(batch, device):
    """Nested dict of numpy arrays / tensors -> tensors on `device`."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    return upload(batch, device, non_blocking=True)


def _split(tree, parts: int, i: int):
    """Slice i of `parts` along the leading dim of every leaf."""
    if isinstance(tree, dict):
        return {k: _split(v, parts, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_split(v, parts, i) for v in tree)
    n = tree.shape[0] // parts
    return tree[i * n:(i + 1) * n]


def forward_loss(model, cfg, batch, generator=None, train_overrides=None,
                 denominators=None):
    """Training-branch forward + loss. Returns (loss, loss_dict, outputs)."""
    with profiling.span("step.forward"):
        outputs = model(batch["imgs"], batch["proj_matrices"],
                        batch["depth_values"], depth_gt=batch["depth"],
                        generator=generator, train=True,
                        train_overrides=train_overrides)
    with profiling.span("step.loss"):
        loss, loss_dict = compute_inverse_loss(
            outputs["depth"], outputs["conf"], batch["depth"], batch["mask"],
            batch["depth_values"], cfg.model.stage_iters, cfg.loss_rate,
            cfg.conf_weight, denominators)
    return loss, loss_dict, outputs


def global_denominators(mask, total, parts: int):
    """{stage: the mask count over `parts` ranks (summed by `total`; >= 1)
    / parts}: each rank's masked sums over these are `parts` times its
    share of the masked means over every rank's rows and columns, so the
    ranks' mean is the global loss."""
    keys = sorted(mask)
    counts = total(torch.stack([(mask[k] > 0.5).sum().float()
                                for k in keys]))
    return {k: c.clamp_min(1.0) / parts
            for k, c in zip(keys, counts.unbind(0))}


def _space_sum(space):
    return lambda t: spatial.all_reduce(t.detach().clone(), space)


def _local_overrides(overrides, rows, shard):
    """Rows (i, parts) and, on a width shard, the columns of the global
    batch's {stage: (t [B], noise [B, Hs, Ws])}."""
    overrides = _split(overrides, rows[1], rows[0])
    if shard is None:
        return overrides
    return {s: (t, shard.at(8 // 2 ** s).take(n))
            for s, (t, n) in overrides.items()}


def compute_gradients(model, cfg, batch,
                      generator: Optional[torch.Generator] = None,
                      train_overrides: Optional[Dict] = None, dp=None):
    """Loss and gradients of one batch (on the model's device), left in
    the parameters' .grad. cfg.accum_steps > 1 splits the batch into that
    many sequential microbatches (one microbatch of activations alive at a
    time) and averages their gradients; BatchNorm statistics update per
    microbatch. train_overrides, if given, is split the same way. With
    dp (a DataParallel whose `module` is `model`), the gradients are
    averaged over the ranks once, after the last microbatch, and in mode
    "global" the masked means divide by the global counts.

    Returns (loss, loss_dict, outputs, batch): means over the microbatches
    for the first two, the last microbatch's for the others.
    """
    model.train()
    model.zero_grad(set_to_none=True)
    accum = max(int(cfg.accum_steps), 1)
    loss_sum, dict_sum = 0.0, {}
    for i in range(accum):
        mb = batch if accum == 1 else _split(batch, accum, i)
        ov = (train_overrides if accum == 1 or train_overrides is None
              else _split(train_overrides, accum, i))
        dens = (None if dp is None or dp.mode == "shard"
                else global_denominators(mb["mask"], dp.sum, dp.world_size))
        sync = (dp is None or i == accum - 1)
        with contextlib.nullcontext() if sync else model.no_sync():
            loss, loss_dict, outputs = forward_loss(model, cfg, mb,
                                                    generator, ov, dens)
            with profiling.span("step.backward", lend=True):
                (loss / accum).backward()
        loss_sum = loss_sum + loss.detach()
        for k, v in loss_dict.items():
            dict_sum[k] = dict_sum.get(k, 0.0) + v
    return (loss_sum / accum, {k: v / accum for k, v in dict_sum.items()},
            outputs, mb)


def _scalars(loss, loss_dict, outputs, batch, reduce=None):
    """reduce: None, or the sum over a space group (width shards)."""
    depth_est = outputs["depth"][-1].detach()
    return {
        "loss": loss,
        "depth_loss": loss_dict[f"l{len(outputs['depth']) - 1}"],
        "init_abs_depth_error": abs_depth_error(
            outputs["depth"][0].detach(), batch["depth"]["stage1"],
            batch["mask"]["stage1"] > 0.5, reduce),
        "final_depth_error": abs_depth_error(
            depth_est, batch["depth"]["stage4"],
            batch["mask"]["stage4"] > 0.5, reduce),
        **loss_dict,
    }


def train_step(state, cfg, batch,
               generator: Optional[torch.Generator] = None,
               train_overrides: Optional[Dict] = None, dp=None):
    """One optimizer update of `state` (in place) from `batch`.

    dp: a parallel.distributed.DataParallel over state.model; `batch` is
    then this rank's rows (and, with dp.space, its columns) of the global
    batch, and train_overrides the global batch's. Without them, in mode
    "global" each rank draws the global batch's from `generator`, in mode
    "shard" its own rows' from its own (DataParallel.generator).

    Returns (scalars, images): dicts of device tensors. scalars adds the
    gradient norm before clipping ("grad_norm") to the reference's set;
    under dp they are the means over the ranks, images this rank's.
    """
    with profiling.span("step"):
        with profiling.span("step.upload"):
            batch = batch_to_device(batch, state.device)
        model = state.model
        reduce = None
        if dp is not None and dp.mode == "shard":
            model = dp.module
            if train_overrides is not None:
                train_overrides = _split(train_overrides, dp.data_size,
                                         dp.data_rank)
        elif dp is not None:
            model = dp.module
            b, _, h, w = batch["imgs"].shape[:4]
            shard = (None if dp.space is None
                     else dp.space.shard(w, state.device))
            if shard is not None:
                w, reduce = shard.width, _space_sum(dp.space)
            if train_overrides is None:
                train_overrides = state.model.draw_train_overrides(
                    b * dp.data_size, h, w, generator)
            train_overrides = _local_overrides(
                train_overrides, (dp.data_rank, dp.data_size), shard)
        loss, loss_dict, outputs, mb = compute_gradients(
            model, cfg, batch, generator, train_overrides, dp)
        if dp is not None and dp.mode == "shard":
            dp.average_statistics()
        grad_norm = state.apply_gradients(cfg.grad_clip)
        with torch.no_grad():
            scalars = _scalars(loss, loss_dict, outputs, mb, reduce)
            scalars["grad_norm"] = grad_norm
            if dp is not None:
                scalars = dp.mean(scalars)
            depth_est = outputs["depth"][-1].detach()
            gt, mask = mb["depth"]["stage4"], mb["mask"]["stage4"]
            images = {
                "depth_est": depth_est * mask,
                "depth_est_nomask": depth_est,
                "depth_gt": gt,
                "errormap": (depth_est - gt).abs() * mask,
            }
            if outputs["conf"]:
                images["confidence"] = outputs["conf"][-1].detach()
        return scalars, images


def eval_step(state, cfg, batch,
              generator: Optional[torch.Generator] = None, space=None):
    """Validation: DDIM inference with the full intermediate lists (the
    reference's test_sample_depth), BatchNorm in eval mode. Returns the
    scalars as device tensors. space: the model's space group (a
    width-sharded model); `batch` is then this rank's columns, and the
    scalars are those of the whole images, the same on every rank of the
    group."""
    batch = batch_to_device(batch, state.device)
    model = state.model.eval()
    with torch.no_grad():
        outputs = model(batch["imgs"], batch["proj_matrices"],
                        batch["depth_values"], generator=generator,
                        train=False, export=False)
        dens = reduce = None
        if space is not None:
            reduce = _space_sum(space)
            dens = global_denominators(batch["mask"], reduce, space.size)
        loss, loss_dict = compute_inverse_loss(
            outputs["depth"], outputs["conf"], batch["depth"],
            batch["mask"], batch["depth_values"], cfg.model.stage_iters,
            cfg.loss_rate, cfg.conf_weight, dens)
        scalars = _scalars(loss, loss_dict, outputs, batch, reduce)
        return scalars if space is None else space_mean(scalars, space)
