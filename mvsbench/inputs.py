"""Everything a run feeds the program, made from --seed: the weights (a
state dict under the reference's key names), view-sets and training
batches, the noise seeds of each unit, and which answers the check
samples. The same seed gives the same values on the same device.

Large tensors are drawn on the card by a torch.Generator in one call
each; only the camera matrices (a few hundred numbers) come from numpy.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from mvsbench.reference.model import Reference

WEIGHTS, VIEWSETS, BATCHES, SAMPLE, CAMERAS = 1, 2, 3, 4, 5
MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A seed for one stream of draws of run `seed` (any whole number)."""
    x = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & MASK
    x ^= x >> 31
    return (x * 0xD6E8FEB86659FD93) & MASK


def generator(device, seed: int, stream: int, index: int = 0):
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


def unit_seed(seed: int, i: int) -> int:
    """The noise seed of unit i (forward, request or step) of run seed:
    the program and the reference each seed a generator with it."""
    return stream_seed(seed, 1000, i)


def reference_model(config: Dict, device="meta") -> Reference:
    with torch.device(device):
        return Reference(config["model"], config["assumed"]["ws_eps"])


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `config`'s model: every conv and linear weight
    and bias uniform in +-1/sqrt(fan_in) (torch's default init), norms'
    affine 1 / 0, BatchNorm statistics 0 / 1; drawn on `device` in one
    call."""
    ref = reference_model(config)
    sd = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
          for k, v in ref.state_dict().items()}
    drawn = []
    for name, mod in ref.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                            nn.Linear)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(mod.weight)
            for leaf in ("weight", "bias"):
                if getattr(mod, leaf) is not None:
                    drawn.append((f"{name}.{leaf}", 1.0 / math.sqrt(fan_in)))
        elif isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm3d, nn.GroupNorm)):
            sd[f"{name}.weight"].fill_(1.0)
            sd[f"{name}.bias"].zero_()
            if isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm3d)):
                sd[f"{name}.running_mean"].zero_()
                sd[f"{name}.running_var"].fill_(1.0)
                sd[f"{name}.num_batches_tracked"].zero_()
    total = sum(sd[k].numel() for k, _ in drawn)
    u = torch.rand(total, generator=generator(device, seed, WEIGHTS),
                   device=device) * 2.0 - 1.0
    at = 0
    for k, b in drawn:
        n = sd[k].numel()
        sd[k].copy_((u[at:at + n] * b).reshape(sd[k].shape))
        at += n
    return sd


def stage_projections(cams: np.ndarray) -> Dict[str, np.ndarray]:
    """{stage1..4: cams [n, V, 2, 4, 4] with the intrinsics scaled to
    1/8 .. 1}."""
    out = {}
    for i, s in enumerate((0.125, 0.25, 0.5, 1.0)):
        m = cams.copy()
        m[..., 1, :2, :] *= s
        out[f"stage{i + 1}"] = m
    return out


def cameras(n: int, views: int, hw, seed: int, stream_index: int):
    """[n, V, 2, 4, 4] (extrinsic, intrinsic): the reference view at the
    origin, the sources on an arc whose step (0.04 rad) and baseline
    (0.25 m) are jittered by up to 25 % per view-set, focal 1.2 W."""
    rng = np.random.default_rng(stream_seed(seed, CAMERAS, stream_index))
    h, w = hw
    k = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]])
    out = np.zeros((n, views, 2, 4, 4), np.float32)
    for b in range(n):
        step, base = 0.04 * rng.uniform(0.75, 1.25), 0.25 * rng.uniform(
            0.75, 1.25)
        for i in range(views):
            th = step * i
            e = np.eye(4)
            e[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                         [-np.sin(th), 0, np.cos(th)]]
            e[:3, 3] = [base * i, 0.02 * i, 0.0]
            out[b, i, 0] = e
            out[b, i, 1, :3, :3] = k
            out[b, i, 1, 3, 3] = 1.0
    return out


def viewsets(config: Dict, n: int, seed: int, device, index: int = 0,
             hw=None):
    """n view-sets of config's size: (imgs [n, V, H, W, 3] float32 in
    [0, 1] on device, {stage: projections [n, V, 2, 4, 4]} on device,
    depth values [n, numdepth] on device)."""
    hw = tuple(hw or config["image_hw"])
    views = config["views"]
    imgs = torch.rand((n, views) + hw + (3,), device=device,
                      generator=generator(device, seed, VIEWSETS, index))
    projs = {k: torch.from_numpy(v).to(device) for k, v in stage_projections(
        cameras(n, views, hw, seed, index)).items()}
    lo, hi = config["depth_range_m"]
    dv = torch.linspace(1.0 / hi, 1.0 / lo, config["model"]["numdepth"],
                        device=device).expand(n, -1).contiguous()
    return imgs, projs, dv


def train_batch(config: Dict, traffic: Dict, seed: int, index: int, device):
    """One training batch: view-sets at the mix's size, the GT a plane
    (depth 4.5 .. 9.5 m, its slopes from the seed) at the four scales
    (1/8 .. 1), its mask 0 over blocks of 16 x 16 pixels (~20 % of them)."""
    n, hw = traffic["batch"], tuple(traffic["image_hw"])
    imgs, projs, dv = viewsets(config, n, seed, device, index, hw)
    gen = generator(device, seed, BATCHES, index)
    p = torch.rand(n, 3, device=device, generator=gen)
    ys = torch.linspace(-0.5, 0.5, hw[0], device=device).reshape(1, -1, 1)
    xs = torch.linspace(-0.5, 0.5, hw[1], device=device).reshape(1, 1, -1)
    gt = ((5.5 + 3.0 * p[:, 0]).reshape(n, 1, 1)
          + (2.0 * p[:, 1] - 1.0).reshape(n, 1, 1) * xs
          + (2.0 * p[:, 2] - 1.0).reshape(n, 1, 1) * ys)
    blocks = torch.rand(n, 1, hw[0] // 16, hw[1] // 16, device=device,
                        generator=gen) > 0.2
    mask = nn.functional.interpolate(blocks.float(), scale_factor=16.0)[:, 0]
    scales = {"stage1": 8, "stage2": 4, "stage3": 2, "stage4": 1}
    return {"imgs": imgs, "proj_matrices": projs, "depth_values": dv,
            "depth": {k: gt[:, ::s, ::s].contiguous()
                      for k, s in scales.items()},
            "mask": {k: mask[:, ::s, ::s].contiguous()
                     for k, s in scales.items()}}


def to_pinned(tree):
    """A copy of a nested dict of tensors in host memory, pinned where
    they come from the card."""
    if isinstance(tree, dict):
        return {k: to_pinned(v) for k, v in tree.items()}
    out = torch.empty(tree.shape, dtype=tree.dtype,
                      pin_memory=tree.device.type == "cuda")
    return out.copy_(tree)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def sample(seed: int, units: int, answers: int, batch: int):
    """The answers the check compares: `answers` distinct (unit, row)
    pairs among the first `units` units of `batch` rows, from the seed.
    The rows are stratified: answer k lies in the k-th of `answers` equal
    slices of the batch, so every half of it is compared on every seed;
    the units are distinct while there are enough of them."""
    rng = np.random.default_rng(stream_seed(seed, SAMPLE))
    us = rng.choice(units, size=answers, replace=answers > units)
    picks = set()
    for k, u in enumerate(us):
        lo = k * batch // answers
        hi = max(lo + 1, (k + 1) * batch // answers)
        picks.add((int(u), int(rng.integers(lo, hi))))
    return sorted(picks)
