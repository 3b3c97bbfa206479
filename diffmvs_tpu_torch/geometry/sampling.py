"""Bilinear image sampling with grid_sample parity, in pixel units.

Counterpart of diffmvs_tpu/geometry/sampling.py:bilinear_sample. Matches
torch.nn.functional.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True) after the reference's [-1, 1] normalization, which
cancels against grid_sample's un-normalization.

Zero padding is corner-wise: each of the four bilinear corners contributes
0 when it falls outside the image, so a sample straddling the border is
partly attenuated. Interpolation runs x first, then y.

A coordinate that is not finite lies outside every image here and samples
zero (the CUDA kernel decides validity the same way, in float, before any
integer conversion).
"""

from __future__ import annotations

import torch


def bilinear_sample(src, x, y):
    """Batched bilinear sampling (the plain four-gather path).

    src: [B, Hs, Ws, C] feature maps (NHWC, any strides).
    x, y: [B, ...] pixel coordinates (integer coords hit pixel centers;
          (0, 0) is the first pixel).
    Returns [B, ..., C]; out-of-bounds corners contribute zeros.
    """
    b, hs, ws, c = src.shape
    batch_shape = x.shape
    xf = x.reshape(b, -1)
    yf = y.reshape(b, -1)
    # non-finite or far-outside coordinates -> -2 (both corners outside);
    # clamping the rest to [-2, size] keeps the int conversion defined
    # without changing any corner's validity
    xf = torch.where(torch.isfinite(xf), xf, torch.full_like(xf, -2.0))
    yf = torch.where(torch.isfinite(yf), yf, torch.full_like(yf, -2.0))
    xf = torch.clamp(xf, -2.0, float(ws))
    yf = torch.clamp(yf, -2.0, float(hs))

    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    wx = (xf - x0)[..., None]
    wy = (yf - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    src_flat = src.reshape(b, hs * ws, c)
    bidx = torch.arange(b, device=src.device)[:, None]

    def corner(xi, yi):
        valid = (xi >= 0) & (xi < ws) & (yi >= 0) & (yi < hs)
        xc = xi.clamp(0, ws - 1)
        yc = yi.clamp(0, hs - 1)
        vals = src_flat[bidx, yc * ws + xc]                # [B, N, C]
        return vals * valid[..., None].to(src.dtype)

    v00 = corner(x0i, y0i)
    v01 = corner(x0i + 1, y0i)
    v10 = corner(x0i, y0i + 1)
    v11 = corner(x0i + 1, y0i + 1)

    wx = wx.to(src.dtype)
    wy = wy.to(src.dtype)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy
    return out.reshape(*batch_shape, c)
