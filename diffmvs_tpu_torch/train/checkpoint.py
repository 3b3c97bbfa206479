"""Checkpoints with epoch-level resume, in the reference's format, and the
JAX package's orbax checkpoints read without JAX.

Counterpart of diffmvs_tpu/train/checkpoint.py. A checkpoint the port
writes is what the reference's train.py saves with torch.save: {"epoch",
"model", "optimizer"} in logdir/model_{epoch:06d}.ckpt, so the two load
each other's files. The JAX package writes logdir/model_{epoch:06d}/, an
orbax directory of its whole train state (params, batch_stats, the optax
state, step, epoch), which train/orbax_read.py reads with numpy and the
system's libzstd.

Every function here takes either format, and a logdir of either or both:
  * `restore_checkpoint` resumes the full state: the model, the
    BatchNorm buffers, the optimizer (from an orbax state: AdamW's
    moments and step, tools/jax_import.optimizer_state_from_jax), the
    step, the learning-rate schedule's position and the epoch;
  * `load_weights_only` loads the model weights alone, non-strictly (the
    reference's --loadckpt, e.g. DiffMVS -> CasDiffMVS finetuning; JAX's
    _merge for an orbax state) and prints what it left out;
  * `load_variables` gives the port's state_dict of a checkpoint (the
    export CLI's restore path).
In a logdir the newest epoch wins whatever its format; an epoch saved in
both formats raises, naming both.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from diffmvs_tpu_torch.tools.jax_import import (optimizer_state_from_jax,
                                                partial_state_dict_from_jax,
                                                state_dict_from_jax)
from diffmvs_tpu_torch.train.orbax_read import read_orbax

_NAME = re.compile(r"model_(\d{6})(\.ckpt)?")


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


def _saved(logdir: str):
    """{epoch: [paths]} of logdir's model_NNNNNN.ckpt files and
    model_NNNNNN/ orbax directories (a .ckpt name a file, the other a
    directory)."""
    out = {}
    for name in os.listdir(logdir):
        m = _NAME.fullmatch(name)
        path = os.path.join(os.path.abspath(logdir), name)
        if m and os.path.isdir(path) != bool(m.group(2)):
            out.setdefault(int(m.group(1)), []).append(path)
    return out


def latest_epoch(logdir: str) -> Optional[int]:
    """The newest epoch saved in logdir, in either format."""
    if not os.path.isdir(logdir):
        return None
    return max(_saved(logdir), default=None)


def checkpoint_at(logdir: str, epoch: int) -> str:
    """The checkpoint of `epoch` in logdir: model_NNNNNN.ckpt or the orbax
    model_NNNNNN/. Raises if there is none, or both."""
    paths = _saved(logdir).get(epoch, []) if os.path.isdir(logdir) else []
    if not paths:
        raise FileNotFoundError(f"no checkpoint of epoch {epoch} in {logdir}")
    if len(paths) > 1:
        raise ValueError(f"{logdir}: epoch {epoch} is saved twice, as "
                         f"{' and '.join(sorted(paths))}: remove one")
    return paths[0]


def resolve(path_or_logdir: str) -> str:
    """The checkpoint the argument names: a .ckpt file, an orbax
    directory (one holding _METADATA, or named model_NNNNNN), or a logdir
    (its newest epoch, checkpoint_at)."""
    path = os.path.abspath(path_or_logdir)
    if not os.path.isdir(path) or is_orbax(path):
        return path
    epoch = latest_epoch(path)
    if epoch is None:
        raise FileNotFoundError(
            f"no checkpoints in {path} (neither model_NNNNNN.ckpt nor an "
            f"orbax model_NNNNNN/)")
    return checkpoint_at(path, epoch)


def is_orbax(path: str) -> bool:
    """An orbax checkpoint directory: it holds _METADATA, or it is a
    directory named as the JAX package names one (model_NNNNNN)."""
    return os.path.isdir(path) and (
        os.path.isfile(os.path.join(path, "_METADATA"))
        or _NAME.fullmatch(os.path.basename(os.path.abspath(path)))
        is not None)


def _orbax_state(path: str) -> dict:
    tree = read_orbax(path)
    if "state" not in tree or "params" not in tree["state"]:
        raise ValueError(f"{path}: holds no train state ({{'state': "
                         f"{{'params', ...}}}}, the JAX package's "
                         f"save_checkpoint)")
    return tree["state"]


def _variables(src: dict) -> dict:
    out = {"params": src["params"]}
    if src.get("batch_stats"):
        out["batch_stats"] = src["batch_stats"]
    return out


def load_variables(path_or_logdir: str, cfg) -> dict:
    """The port's state_dict (the reference's key names) of a checkpoint:
    an orbax one through tools/jax_import.state_dict_from_jax for
    CasDiffMVS(cfg), a .ckpt its "model" (a pickle: load only files you
    trust)."""
    path = resolve(path_or_logdir)
    if is_orbax(path):
        return state_dict_from_jax(_variables(_orbax_state(path)), cfg)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["model"] if "model" in ckpt else ckpt


def _set_schedule(state, position: int):
    """The learning-rate schedule at `position` optimizer updates."""
    sched = state.scheduler
    sched.last_epoch = position
    for group, base, fn in zip(state.optimizer.param_groups, sched.base_lrs,
                               sched.lr_lambdas):
        group["lr"] = base * fn(position)


def restore_checkpoint(logdir: str, state, epoch: Optional[int] = None):
    """Restore model and optimizer from logdir (epoch=None: the latest, in
    either format). Returns (state, epoch) with state.epoch = epoch + 1, or
    (state, None) if there is nothing to restore."""
    if epoch is None:
        epoch = latest_epoch(logdir)
    if epoch is None:
        return state, None
    path = checkpoint_at(logdir, epoch)
    if is_orbax(path):
        src = _orbax_state(path)
        model = state.model
        model.load_state_dict(state_dict_from_jax(_variables(src),
                                                  model.cfg), strict=True)
        position = optimizer_state_from_jax(src["opt_state"], model.cfg,
                                            model, state.optimizer)
        state.step = int(src["step"])
        _set_schedule(state, position)
        state.epoch = epoch + 1
    else:
        ckpt = torch.load(path, map_location=state.device, weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        steps = [int(s["step"]) for s in state.optimizer.state.values()
                 if "step" in s]
        state.step = max(steps, default=0)
        state.scheduler.last_epoch = state.step
        state.epoch = int(ckpt["epoch"]) + 1
    return state, epoch


def load_weights_only(path_or_logdir: str, state):
    """Load model weights from a checkpoint (or the latest one in a
    logdir) into state.model non-strictly, keeping the optimizer fresh,
    and print what was left out: the model's keys the checkpoint lacks and
    the checkpoint's keys (an orbax state's variables) the model lacks. A
    .ckpt is a pickle: load only checkpoints you trust."""
    path = resolve(path_or_logdir)
    if is_orbax(path):
        sd, unused = partial_state_dict_from_jax(
            _variables(_orbax_state(path)), state.model.cfg)
        sd = {k: v.to(state.device) for k, v in sd.items()}
        res = state.model.load_state_dict(sd, strict=False)
        unexpected = ["/".join(p) for p in unused]
    else:
        ckpt = torch.load(path, map_location=state.device,
                          weights_only=False)
        res = state.model.load_state_dict(ckpt.get("model", ckpt),
                                          strict=False)
        unexpected = res.unexpected_keys
    for what, keys in (("missing", res.missing_keys),
                       ("unexpected", unexpected)):
        if keys:
            print(f"load_weights_only {path}: {len(keys)} {what} key(s): "
                  f"{', '.join(keys)}")
    return state
