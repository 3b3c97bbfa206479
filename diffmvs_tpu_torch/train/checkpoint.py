"""Checkpoints with epoch-level resume, in the reference's format.

Counterpart of diffmvs_tpu/train/checkpoint.py. A checkpoint is what the
reference's train.py saves with torch.save: {"epoch", "model",
"optimizer"} in logdir/model_{epoch:06d}.ckpt, so the two load each
other's files. `restore_checkpoint` resumes the full state (the optimizer
too, and the schedule from the optimizer's step count);
`load_weights_only` loads the model weights alone with strict=False (the
reference's --loadckpt, e.g. DiffMVS -> CasDiffMVS finetuning).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(logdir), f"model_{epoch:06d}.ckpt")


def save_checkpoint(logdir: str, state, epoch: int) -> str:
    path = checkpoint_path(logdir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"epoch": epoch, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(logdir: str) -> Optional[int]:
    if not os.path.isdir(logdir):
        return None
    epochs = [int(m.group(1)) for m in
              (re.fullmatch(r"model_(\d{6})\.ckpt", n)
               for n in os.listdir(logdir)) if m]
    return max(epochs) if epochs else None


def restore_checkpoint(logdir: str, state, epoch: Optional[int] = None):
    """Restore model and optimizer from logdir (epoch=None: the latest).
    Returns (state, epoch) with state.epoch = epoch + 1, or (state, None)
    if there is nothing to restore."""
    if epoch is None:
        epoch = latest_epoch(logdir)
    if epoch is None:
        return state, None
    ckpt = torch.load(checkpoint_path(logdir, epoch), map_location=state.device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    steps = [int(s["step"]) for s in state.optimizer.state.values()
             if "step" in s]
    state.step = max(steps, default=0)
    state.scheduler.last_epoch = state.step
    state.epoch = int(ckpt["epoch"]) + 1
    return state, epoch


def load_weights_only(path_or_logdir: str, state):
    """Load model weights from a checkpoint file (or the latest one in a
    logdir) into state.model with strict=False, keeping the optimizer
    fresh, and print the keys that strict=False let through: the model's
    keys the file lacks and the file's keys the model lacks. The file is
    a pickle: load only checkpoints you trust."""
    path = path_or_logdir
    if os.path.isdir(path):
        epoch = latest_epoch(path)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
        path = checkpoint_path(path, epoch)
    ckpt = torch.load(path, map_location=state.device, weights_only=False)
    res = state.model.load_state_dict(ckpt.get("model", ckpt), strict=False)
    for what, keys in (("missing", res.missing_keys),
                       ("unexpected", res.unexpected_keys)):
        if keys:
            print(f"load_weights_only {path}: {len(keys)} {what} key(s): "
                  f"{', '.join(keys)}")
    return state
