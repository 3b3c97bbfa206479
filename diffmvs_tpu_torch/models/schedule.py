"""Cosine beta schedule and DDIM constants.

Counterpart of diffmvs_tpu/models/schedule.py (a copy of its numpy math:
that file imports jax.numpy). All constants are computed once in float64
numpy and used as float32 Python scalars or small tensors; nothing is
registered as module state, so the schedule is not part of the
state_dict.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Immutable schedule constants for one refinement stage."""

    timesteps: int
    sampling_timesteps: int
    eta: float
    scale: float

    @functools.cached_property
    def _tables(self):
        betas = cosine_beta_schedule(self.timesteps).astype(np.float64)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        return {
            "alphas_cumprod": alphas_cumprod.astype(np.float32),
            "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod).astype(np.float32),
            "sqrt_one_minus_alphas_cumprod":
                np.sqrt(1.0 - alphas_cumprod).astype(np.float32),
            "sqrt_recip_alphas_cumprod":
                np.sqrt(1.0 / alphas_cumprod).astype(np.float32),
            "sqrt_recipm1_alphas_cumprod":
                np.sqrt(1.0 / alphas_cumprod - 1.0).astype(np.float32),
        }

    def table(self, name: str) -> np.ndarray:
        return self._tables[name]

    def _at(self, name, t, ndim):
        """table[name][t] as a float32 tensor shaped [B, 1, ...]."""
        tab = torch.from_numpy(self.table(name)).to(t.device)
        return tab[t.long()].reshape((t.shape[0],) + (1,) * (ndim - 1))

    def q_sample(self, x_start, t, noise):
        """Forward diffusion x_t = sqrt(ab_t) x_0 + sqrt(1-ab_t) eps.

        x_start: [B, ...]; t: [B] integer timesteps; noise like x_start.
        """
        sa = self._at("sqrt_alphas_cumprod", t, x_start.dim())
        so = self._at("sqrt_one_minus_alphas_cumprod", t, x_start.dim())
        return sa * x_start + so * noise

    def predict_noise_from_start(self, x_t, t, x0):
        sr = self._at("sqrt_recip_alphas_cumprod", t, x_t.dim())
        sm = self._at("sqrt_recipm1_alphas_cumprod", t, x_t.dim())
        return (sr * x_t - x0) / sm

    def ddim_time_pairs(self):
        """[(T-1, t1), ..., (t_k, -1)]."""
        times = np.linspace(-1, self.timesteps - 1,
                            self.sampling_timesteps + 1)
        times = list(reversed(times.astype(int).tolist()))
        return list(zip(times[:-1], times[1:]))

    def ddim_coeffs(self, time: int, time_next: int):
        """(sqrt(alpha_next), c, sigma) of the DDIM step."""
        ac = self._tables["alphas_cumprod"].astype(np.float64)
        alpha, alpha_next = ac[time], ac[time_next]
        sigma = self.eta * np.sqrt(
            (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = np.sqrt(1 - alpha_next - sigma ** 2)
        return (np.float32(np.sqrt(alpha_next)), np.float32(c),
                np.float32(sigma))
