"""Epoch training loop with validation, checkpointing and scalar logging.

Counterpart of diffmvs_tpu/train/loop.py. Logging: JSONL scalars
(logdir/scalars.jsonl) always; TensorBoard when torch's writer imports
(optional, as in the JAX package). The loop fetches the step's scalars
from the device only every cfg.summary_freq steps.

Loaders are any iterables of batches with a len(): dicts of numpy arrays
or tensors in the model's forward contract plus "depth" and "mask"
{stage1..4: [B, Hs, Ws]} (utils/synthetic.synthetic_train_batch makes
one). The runs go on the state's device (train/state.create_train_state:
CUDA unless device="cpu").

Under data parallelism (dp, parallel/distributed.DataParallel) every rank
runs the steps on its rows of each global batch (in dp.mode: "global"
draws the global batch's noise from the one seeded generator on every
rank, "shard" each rank's own from a generator folded with its rank,
DataParallel.generator; train/state.data_parallel_mode says which mode
the JAX package's run_training takes); rank 0 alone logs, saves
images and checkpoints and runs the validation over the whole val loader,
while the other ranks wait at a barrier. With width sharding (dp.space)
each rank holds its columns of those rows: the ranks of rank 0's space
group run the validation together (their loaders giving each its
columns), and at an image step every space group gathers its maps to
full width, which rank 0 saves, as JAX's global arrays log them.
"""

from __future__ import annotations

import json
import os
import time

import torch

from diffmvs_tpu_torch.train.checkpoint import save_checkpoint
from diffmvs_tpu_torch.train.step import eval_step, train_step
from diffmvs_tpu_torch.utils.metrics import DictAverageMeter
from diffmvs_tpu_torch.utils.summaries import save_images


class ScalarLogger:
    """JSONL + optional TensorBoard scalar sink."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "scalars.jsonl")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # optional
            self.tb = SummaryWriter(logdir)
        except Exception:
            pass

    def log(self, mode: str, scalars: dict, step: int):
        rec = {"mode": mode, "step": step,
               **{k: float(v) for k, v in scalars.items()}}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in rec.items():
                if k not in ("mode", "step"):
                    self.tb.add_scalar(f"{mode}/{k}", v, step)


def _eval_means(state, cfg, val_loader, seed: int, space=None):
    gen = torch.Generator(device=state.device).manual_seed(seed)
    meter = DictAverageMeter()
    for batch in val_loader:
        t0 = time.time()
        scalars = {k: float(v) for k, v in
                   eval_step(state, cfg, batch, gen, space).items()}
        scalars["time"] = time.time() - t0
        meter.update(scalars)
    return meter.mean()


def run_eval(state, cfg, val_loader, logdir: str = None, space=None):
    """Eval-only pass over the validation loader (the reference's
    `--mode test`). Returns the mean scalars. space: the space group of a
    width-sharded model, whose ranks all run it on their columns; its
    rank 0 prints and logs."""
    means = _eval_means(state, cfg, val_loader, cfg.seed, space)
    if space is None or space.rank == 0:
        print("final", means)
        if logdir:
            ScalarLogger(logdir).log("eval", means, 0)
    return means


def run_training(state, cfg, train_loader, val_loader, logdir: str,
                 start_epoch: int = None, on_step=None, dp=None):
    """Train from start_epoch (default state.epoch) to the last epoch,
    saving a checkpoint every cfg.save_freq epochs and validating every
    cfg.eval_freq. The train log carries each step's learning rate ("lr").
    on_step(global_step, scalars), if given, runs after every step with
    the step's device scalars. dp: a DataParallel over state.model, with
    train_loader giving this rank's rows (and columns, with dp.space) and
    val_loader, on the ranks of rank 0's space group, their columns.
    Returns the state."""
    lead = dp is None or dp.rank == 0
    space = None if dp is None else dp.space
    validates = dp is None or dp.data_rank == 0
    logger = ScalarLogger(logdir) if lead else None
    gen = (torch.Generator(device=state.device).manual_seed(cfg.seed)
           if dp is None else dp.generator(cfg.seed, state.device))
    total_epochs = cfg.epochs if cfg.train_epochs == -1 else cfg.train_epochs
    steps_per_epoch = len(train_loader)
    start = state.epoch if start_epoch is None else start_epoch

    for epoch in range(start, total_epochs):
        if lead:
            print(f"Epoch {epoch}:")
        for batch_idx, batch in enumerate(train_loader):
            global_step = epoch * steps_per_epoch + batch_idx
            t0 = time.time()
            lr = state.optimizer.param_groups[0]["lr"]
            scalars, images = train_step(state, cfg, batch, gen, dp=dp)
            if lead and global_step % cfg.summary_freq == 0:
                host = {k: float(v) for k, v in scalars.items()}
                logger.log("train", {**host, "lr": lr}, global_step)
                print(f"Epoch {epoch}/{total_epochs}, Iter {batch_idx}/"
                      f"{steps_per_epoch}, loss = {host['loss']:.3f}, "
                      f"time = {time.time() - t0:.3f}")
            if global_step % (50 * cfg.summary_freq) == 0:
                if dp is not None:
                    images = dp.full_width(images)
                if lead:
                    save_images(logdir, "train", images, global_step,
                                tb=logger.tb)
            if on_step is not None:
                on_step(global_step, scalars)
        state.epoch = epoch + 1

        if lead and (epoch + 1) % cfg.save_freq == 0:
            print(f"saved {save_checkpoint(logdir, state, epoch)}")

        if validates and (epoch % cfg.eval_freq == 0
                          or epoch == total_epochs - 1):
            means = _eval_means(state, cfg, val_loader, cfg.seed + epoch + 1,
                                space)
            if lead:
                logger.log("full_test", means, (epoch + 1) * steps_per_epoch)
                print("eval:", means)
        if dp is not None:
            dp.barrier()

    return state
