"""Training entry point.

    python -m diffmvs_tpu_torch.cli.train --mode train --dataset dtu \
        --trainpath DTU --trainlist lists/dtu/train.txt \
        --testlist lists/dtu/val.txt --preset casdiffmvs --logdir ckpts/cas
    torchrun --nproc_per_node N -m diffmvs_tpu_torch.cli.train --dp N ...

Counterpart of diffmvs_tpu/cli/train.py (the reference's train.py): the
same flags, presets and per-stage triplet overrides, the same datasets
(data/dtu.py, data/blend.py) and schedules; `--mode test` runs the
validation pass alone and `--resume` continues from the newest checkpoint
in --logdir (the step count, the optimizer and the schedule with it).

What differs from the JAX CLI:
  * --device (default cuda): training runs on the card unless --device
    cpu is asked for; without a card the default raises.
  * --dp N trains data-parallel over the N processes torchrun starts, one
    card each (parallel/distributed.py): --batch_size stays the global
    batch, as in JAX, and must divide by N; every rank loads its rows of
    each global batch. --sp > 1 (width sharding) is refused.
  * --loadckpt: a file ending in .ckpt (a reference checkpoint, or one
    the port wrote: the format is the same) goes through
    api.clean_reference_state_dict and loads with strict=True, raising on
    a missing or unexpected key as the JAX CLI's import raises on an
    unmapped tensor. Anything else (a port logdir, whose newest
    model_NNNNNN.ckpt is taken) loads through
    train/checkpoint.load_weights_only with strict=False, as the JAX CLI's
    weights-only path does, and prints the keys that were not loaded.
  * Python's `random` (the datasets' source-view draws) is seeded from
    --seed and the rank; with --workers > 0 each worker seeds its own
    (data/pipeline.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random

import torch.distributed as dist

from diffmvs_tpu_torch.config import MODEL_PRESETS, ModelConfig, TrainConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DiffMVS/CasDiffMVS trainer (PyTorch / CUDA)")
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--preset", default="casdiffmvs",
                   choices=sorted(MODEL_PRESETS.keys()))
    p.add_argument("--dataset", default="dtu")
    p.add_argument("--trainpath")
    p.add_argument("--testpath")
    p.add_argument("--trainlist")
    p.add_argument("--testlist")
    p.add_argument("--trainviews", type=int, default=5)
    p.add_argument("--testviews", type=int, default=5)
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--train_epochs", type=int, default=-1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_sche", default="onecycle")
    p.add_argument("--lrepochs", default="10,12,14:2")
    p.add_argument("--wd", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=4,
                   help="the global batch (split over --dp ranks)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--loadckpt", default=None,
                   help=".ckpt file (strict), or a training logdir")
    p.add_argument("--logdir", default="./checkpoints/debug")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--summary_freq", type=int, default=20)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--conf_weight", type=float, default=0.05)
    p.add_argument("--workers", type=int, default=0,
                   help="input-pipeline worker processes (reference: 8)")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel ranks (-1: torchrun's world size)")
    p.add_argument("--sp", type=int, default=1,
                   help="width sharding: not ported, must be 1")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # model triplet overrides (reference flag compatibility)
    p.add_argument("--numdepth_initial", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--scale", nargs="+", type=float)
    p.add_argument("--timesteps", nargs="+", type=int)
    p.add_argument("--sampling_timesteps", nargs="+", type=int)
    p.add_argument("--ddim_eta", nargs="+", type=float)
    p.add_argument("--hidden_dim", nargs="+", type=int)
    p.add_argument("--context_dim", nargs="+", type=int)
    p.add_argument("--stage_iters", nargs="+", type=int)
    p.add_argument("--cost_dim_stage", nargs="+", type=int)
    p.add_argument("--CostNum", nargs="+", type=int)
    p.add_argument("--unet_dim", nargs="+", type=int)
    p.add_argument("--min_radius", type=float)
    p.add_argument("--max_radius", type=float)
    return p


def model_config_from_args(args) -> ModelConfig:
    cfg = MODEL_PRESETS[args.preset]
    overrides = {}
    triplets = {
        "scale": "scale", "timesteps": "timesteps",
        "sampling_timesteps": "sampling_timesteps", "ddim_eta": "ddim_eta",
        "hidden_dim": "hidden_dim", "context_dim": "context_dim",
        "stage_iters": "stage_iters", "cost_dim_stage": "cost_dim_stage",
        "CostNum": "cost_num", "unet_dim": "unet_dim",
    }
    for flag, field in triplets.items():
        v = getattr(args, flag)
        if v is not None:
            overrides[field] = tuple(v)
    for flag in ("numdepth_initial", "numdepth", "min_radius", "max_radius"):
        v = getattr(args, flag)
        if v is not None:
            overrides[flag] = v
    return dataclasses.replace(cfg, **overrides).validate()


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        model=model_config_from_args(args),
        dataset=args.dataset, epochs=args.epochs,
        train_epochs=args.train_epochs, batch_size=args.batch_size,
        lr=args.lr, lr_sche=args.lr_sche, lrepochs=args.lrepochs,
        weight_decay=args.wd, train_views=args.trainviews,
        test_views=args.testviews, seed=args.seed,
        conf_weight=args.conf_weight, save_freq=args.save_freq,
        eval_freq=args.eval_freq, summary_freq=args.summary_freq,
        dp=args.dp, sp=args.sp, accum_steps=args.accum_steps,
    )


def load_weights(path: str, state) -> None:
    """--loadckpt: a .ckpt file strictly, anything else weights-only."""
    from diffmvs_tpu_torch.api import clean_reference_state_dict
    from diffmvs_tpu_torch.cli.test import load_state_dict
    from diffmvs_tpu_torch.train.checkpoint import load_weights_only

    if path.endswith(".ckpt"):
        state.model.load_state_dict(
            clean_reference_state_dict(load_state_dict(path)), strict=True)
    else:
        load_weights_only(path, state)


def main(argv=None) -> dict:
    """Returns {"state": the train state, "eval": the validation means of
    --mode test on rank 0, else None}."""
    from diffmvs_tpu_torch.data.pipeline import DataPipeline
    from diffmvs_tpu_torch.data.registry import find_dataset_def
    from diffmvs_tpu_torch.parallel.distributed import (
        DataParallel, init_distributed, resolve_mesh)
    from diffmvs_tpu_torch.train.checkpoint import restore_checkpoint
    from diffmvs_tpu_torch.train.loop import run_eval, run_training
    from diffmvs_tpu_torch.train.state import create_train_state

    args = build_argparser().parse_args(argv)
    cfg = train_config_from_args(args)
    rank, world_size, dev = init_distributed(args.device)
    try:
        dp_size = resolve_mesh(cfg.dp, cfg.sp, world_size)
        if cfg.batch_size % dp_size:
            raise ValueError(f"--batch_size {cfg.batch_size} does not divide "
                             f"over --dp {dp_size} ranks")
        lead = rank == 0
        if lead:
            print("config:", cfg)
        random.seed(f"{cfg.seed}:{rank}")
        if args.testpath is None:
            args.testpath = args.trainpath

        dataset_cls = find_dataset_def(cfg.dataset)
        train_ds = dataset_cls(args.trainpath, args.trainlist, "train",
                               cfg.train_views, cfg.model.numdepth)
        val_ds = dataset_cls(args.testpath, args.testlist, "test",
                             cfg.test_views, cfg.model.numdepth)
        pin = dev.type == "cuda"
        train_loader = DataPipeline(
            train_ds, cfg.batch_size, shuffle=True, drop_last=True,
            seed=cfg.seed, num_workers=args.workers, pin_memory=pin,
            rank=rank, world_size=dp_size)
        val_loader = DataPipeline(val_ds, cfg.batch_size, shuffle=False,
                                  drop_last=False, num_workers=args.workers,
                                  pin_memory=pin)

        state = create_train_state(cfg, steps_per_epoch=len(train_loader),
                                   device=dev, seed=cfg.seed)
        if args.resume:
            state, epoch = restore_checkpoint(args.logdir, state)
            if epoch is not None and lead:
                print(f"resumed from epoch {epoch}")
        elif args.loadckpt:
            load_weights(args.loadckpt, state)
            if lead:
                print(f"loaded weights from {args.loadckpt}")

        os.makedirs(args.logdir, exist_ok=True)
        if args.mode == "test":
            means = run_eval(state, cfg, val_loader, args.logdir) \
                if lead else None
            return {"state": state, "eval": means}
        dp = DataParallel(state.model) if world_size > 1 else None
        run_training(state, cfg, train_loader, val_loader, args.logdir,
                     dp=dp)
        return {"state": state, "eval": None}
    finally:
        if world_size > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
