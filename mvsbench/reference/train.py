"""Plain reference of the published training step: the loss's gradients,
the global-norm clip, AdamW, and the one-cycle learning rate, on the
plain model of reference/model.py.

Constants are the published train.py's: AdamW betas (0.9, 0.999), eps
1e-8, decoupled weight decay on every parameter, the gradient clipped to
a global norm, OneCycleLR with linear annealing over
len(loader) * epochs + 100 steps (pct_start 0.05, div_factor 25,
final_div_factor 1e4). Imports torch, numpy and the standard library
only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mvsbench.reference.model import draw_train_noise, loss


def onecycle_lr(step: int, total: int, peak: float) -> float:
    """The learning rate of optimizer step `step` (0-based), as optax's
    linear schedules give it in float32."""
    f32 = np.float32
    init, warm = peak / 25.0, max(1, int(total * 0.05))
    final = init / 1e4

    def linear(a, b, n, k):
        k = f32(min(max(k, 0), n))
        return float(f32(a - b) * (f32(1.0) - k / f32(n)) + f32(b))

    return (linear(init, peak, warm, step) if step < warm
            else linear(peak, final, total - warm, step - warm))


class AdamW:
    """torch.optim.AdamW's update written out, with the step count and
    the moments per parameter."""

    def __init__(self, params, weight_decay, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.wd, self.betas, self.eps = weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.count += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            p.mul_(1 - lr * self.wd)
            m.lerp_(p.grad, 1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / c1)


def clip_global(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients to a global norm of at most max_norm (as
    torch.nn.utils.clip_grad_norm_ does); returns the norm before."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    for g in grads:
        g.mul_(coef)
    return norm


def train_steps(model, batches, seeds, train: Dict, total_steps: int):
    """Run len(batches) optimizer steps of `model` (train mode) from its
    weights, step i on batches[i] with the noise drawn from a generator on
    the batch's device seeded with seeds[i]. Returns (losses, the clipped
    gradients of step 1 by parameter name, the parameters after the last
    step by name)."""
    cfg = model.cfg
    model.train()
    params = dict(model.named_parameters())
    opt = AdamW(params.values(), train["weight_decay"])
    losses, first_grads = [], None
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        b, _, h, w, _ = batch["imgs"].shape
        gen = torch.Generator(device=batch["imgs"].device).manual_seed(seed)
        ts, noise = draw_train_noise(cfg, b, h, w, gen)
        model.zero_grad(set_to_none=True)
        out = model(batch["imgs"], batch["proj_matrices"],
                    batch["depth_values"], noise, t=ts, gt=batch["depth"])
        value = loss(out, batch["depth"], batch["mask"], batch["depth_values"],
                     cfg["stage_iters"], train["loss_rate"],
                     train["conf_weight"])
        value.backward()
        clip_global(list(params.values()), train["grad_clip"])
        if i == 0:
            first_grads = {k: p.grad.detach().clone()
                           for k, p in params.items() if p.grad is not None}
        opt.step(onecycle_lr(i, total_steps, train["lr"]))
        losses.append(value.item())
    return losses, first_grads, {k: p.detach().clone()
                                 for k, p in params.items()}
