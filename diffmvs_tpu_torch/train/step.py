"""Train and eval steps.

Counterpart of diffmvs_tpu/train/step.py (make_train_step,
make_eval_step): the loss, its gradients, the clip and the AdamW step,
and the init/final absolute-depth-error metrics. Steps return device
tensors and never wait for the host; the loop fetches scalars when it
logs them.

Data parallelism (train_step's dp, parallel/distributed.DataParallel)
follows the JAX package's default GSPMD step, whose global batch is
sharded over devices: every rank draws the timesteps and noise of the
global batch from the one seeded generator and keeps its rows, each
rank's masked means divide by the global batch's mask counts (times the
world size, which DDP's mean of the gradients divides out), BatchNorm
syncs over the global batch, and the scalars are averaged over the ranks
(pmean). A step then equals the single-process step on the global batch.
With accum_steps > 1 each rank splits its own rows into microbatches.
"""

from __future__ import annotations

from typing import Dict, Optional

import contextlib

import numpy as np
import torch

from diffmvs_tpu_torch.models.loss import compute_inverse_loss
from diffmvs_tpu_torch.utils.metrics import abs_depth_error


def batch_to_device(batch, device):
    """Nested dict of numpy arrays / tensors -> tensors on `device`."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    return batch.to(device, non_blocking=True)


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
    outputs = model(batch["imgs"], batch["proj_matrices"],
                    batch["depth_values"], depth_gt=batch["depth"],
                    generator=generator, train=True,
                    train_overrides=train_overrides)
    loss, loss_dict = compute_inverse_loss(
        outputs["depth"], outputs["conf"], batch["depth"], batch["mask"],
        batch["depth_values"], cfg.model.stage_iters, cfg.loss_rate,
        cfg.conf_weight, denominators)
    return loss, loss_dict, outputs


def global_denominators(mask, dp):
    """{stage: the global batch's mask count (>= 1) / world size}: each
    rank's masked sums over these are the world size times its share of
    the global masked means, so the ranks' mean is the global loss."""
    keys = sorted(mask)
    counts = dp.sum(torch.stack([(mask[k] > 0.5).sum().float()
                                 for k in keys]))
    return {k: c.clamp_min(1.0) / dp.world_size
            for k, c in zip(keys, counts.unbind(0))}


def compute_gradients(model, cfg, batch,
                      generator: Optional[torch.Generator] = None,
                      train_overrides: Optional[Dict] = None, dp=None):
    """Loss and gradients of one batch (on the model's device), left in
    the parameters' .grad. cfg.accum_steps > 1 splits the batch into that
    many sequential microbatches (one microbatch of activations alive at a
    time) and averages their gradients; BatchNorm statistics update per
    microbatch. train_overrides, if given, is split the same way. With
    dp (a DataParallel whose `module` is `model`), the masked means divide
    by the global counts and the gradients are averaged over the ranks
    once, after the last microbatch.

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
        dens = None if dp is None else global_denominators(mb["mask"], dp)
        sync = (dp is None or i == accum - 1)
        with contextlib.nullcontext() if sync else model.no_sync():
            loss, loss_dict, outputs = forward_loss(model, cfg, mb,
                                                    generator, ov, dens)
            (loss / accum).backward()
        loss_sum = loss_sum + loss.detach()
        for k, v in loss_dict.items():
            dict_sum[k] = dict_sum.get(k, 0.0) + v
    return (loss_sum / accum, {k: v / accum for k, v in dict_sum.items()},
            outputs, mb)


def _scalars(loss, loss_dict, outputs, batch):
    depth_est = outputs["depth"][-1].detach()
    return {
        "loss": loss,
        "depth_loss": loss_dict[f"l{len(outputs['depth']) - 1}"],
        "init_abs_depth_error": abs_depth_error(
            outputs["depth"][0].detach(), batch["depth"]["stage1"],
            batch["mask"]["stage1"] > 0.5),
        "final_depth_error": abs_depth_error(
            depth_est, batch["depth"]["stage4"],
            batch["mask"]["stage4"] > 0.5),
        **loss_dict,
    }


def train_step(state, cfg, batch,
               generator: Optional[torch.Generator] = None,
               train_overrides: Optional[Dict] = None, dp=None):
    """One optimizer update of `state` (in place) from `batch`.

    dp: a parallel.distributed.DataParallel over state.model; `batch` is
    then this rank's rows of the global batch, and train_overrides (or,
    without them, the draw from `generator`) the global batch's.

    Returns (scalars, images): dicts of device tensors. scalars adds the
    gradient norm before clipping ("grad_norm") to the reference's set;
    under dp they are the means over the ranks, images this rank's.
    """
    batch = batch_to_device(batch, state.device)
    model = state.model
    if dp is not None:
        model = dp.module
        b, _, h, w = batch["imgs"].shape[:4]
        if train_overrides is None:
            train_overrides = state.model.draw_train_overrides(
                b * dp.world_size, h, w, generator)
        train_overrides = _split(train_overrides, dp.world_size, dp.rank)
    loss, loss_dict, outputs, mb = compute_gradients(
        model, cfg, batch, generator, train_overrides, dp)
    grad_norm = state.apply_gradients(cfg.grad_clip)
    with torch.no_grad():
        scalars = _scalars(loss, loss_dict, outputs, mb)
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
              generator: Optional[torch.Generator] = None):
    """Validation: DDIM inference with the full intermediate lists (the
    reference's test_sample_depth), BatchNorm in eval mode. Returns the
    scalars as device tensors."""
    batch = batch_to_device(batch, state.device)
    model = state.model.eval()
    with torch.no_grad():
        outputs = model(batch["imgs"], batch["proj_matrices"],
                        batch["depth_values"], generator=generator,
                        train=False, export=False)
        loss, loss_dict = compute_inverse_loss(
            outputs["depth"], outputs["conf"], batch["depth"],
            batch["mask"], batch["depth_values"], cfg.model.stage_iters,
            cfg.loss_rate, cfg.conf_weight)
        return _scalars(loss, loss_dict, outputs, batch)
