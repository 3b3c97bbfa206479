"""Group-wise correlation cost volumes.

Counterpart of diffmvs_tpu/ops/correlation.py. The public functions keep
the JAX package's layouts (NHWC features, [B, D, H, W, G] volumes), so the
tests compare like with like.

warp_and_correlate dispatches on the device of its inputs: CPU tensors go
to warp_and_correlate_plain (plane_sweep_coords -> bilinear_sample ->
group_correlation), whose autograd is the oracle for the kernels' gradient;
CUDA tensors, with or without gradient, go to the autograd Function in
ops/warp_corr.py (forward kernel K1, backward kernel K2), which launches or
raises.

corner_correlate_plain is the plain version of K3, the kernel of
ops/warp_corr.warp_corr(..., batch_rows=False): the same function from
precomputed corner operands, in the TPU kernel's interpolation order.
"""

from __future__ import annotations

import torch

from diffmvs_tpu_torch.geometry.sampling import bilinear_sample
from diffmvs_tpu_torch.geometry.transforms import relative_projection
from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
from diffmvs_tpu_torch.ops import warp_corr


def group_correlation(warped, ref, groups):
    """Mean of elementwise products within each channel group.

    warped: [B, D, H, W, C]; ref: [B, H, W, C]. Returns [B, D, H, W, G].
    """
    b, d, h, w, c = warped.shape
    assert c % groups == 0, f"channels {c} not divisible by groups {groups}"
    wg = warped.reshape(b, d, h, w, groups, c // groups)
    rg = ref.reshape(b, 1, h, w, groups, c // groups)
    return (wg * rg).mean(dim=-1)


def warp_and_correlate_plain(src_fea, ref_fea, src_pair, ref_pair,
                             depth_values, groups, x_off: int = 0):
    """Plane-sweep warp + group correlation in plain PyTorch.

    src_fea/ref_fea: [B, Hs, Ws, C] / [B, H, W, C] (NHWC), float32 or
    bfloat16: bfloat16 features are upcast as they are read and the
    interpolation and group mean run in float32, as the kernels compute
    them (the caller rounds the result once, to the features' dtype). The
    JAX package's default XLA warp interpolates and multiplies bfloat16
    features in bfloat16 instead (diffmvs_tpu/geometry/sampling.py:52-54);
    its Pallas kernels upcast, as here.
    src_pair/ref_pair: [B, 2, 4, 4] (extrinsic, intrinsic) stacks.
    depth_values: [B, D, H, W] metric hypotheses.
    x_off: the global column of ref's first column (a width shard's
      offset, geometry/warp.py); src is then the full-width source, wider
      than ref.
    Returns [B, D, H, W, G] float32.
    """
    rot, trans = relative_projection(src_pair, ref_pair)
    x, y = plane_sweep_coords(rot, trans, depth_values, x_off)
    warped = bilinear_sample(src_fea.float(), x, y)
    return group_correlation(warped, ref_fea.float(), groups)


def corner_correlate_plain(src_fea, ref_fea, xi, yi, fx, fy, valid, groups):
    """K3's plain version: warp + group correlation from corner operands.

    src_fea [B, Hs, Ws, C], ref_fea [B, H, W, C] (float32 or bfloat16,
    computed in float32); xi, yi, fx, fy, valid [B, D, H, W] as
    ops/warp_corr.corner_split gives them. Interpolates in the TPU
    kernel's order (the two y-lerps (1 - fy) * top + fy * bottom, then
    left + (right - left) * fx); each corner outside the image reads zero.
    Each group sums its channels in order, for bfloat16 features as for
    float32 ones, at any C/G (the TPU kernel's default, unpacked mode).
    Returns [B, D, H, W, G] float32.
    """
    b, hs, ws, c = src_fea.shape
    _, d, h, w = xi.shape
    src = src_fea.float().reshape(b, hs * ws, c)
    bidx = torch.arange(b, device=src.device)[:, None]

    def corner(xc, yc):
        ok = (xc >= 0) & (xc < ws) & (yc >= 0) & (yc < hs)
        idx = (yc.clamp(0, hs - 1) * ws + xc.clamp(0, ws - 1)).reshape(b, -1)
        vals = src[bidx, idx.long()].reshape(b, d, h, w, c)
        return torch.where(ok[..., None], vals, torch.zeros_like(vals))

    x0, y0 = xi - 1, yi - 1
    wx, wy = fx[..., None], fy[..., None]
    gy = 1.0 - wy
    left = corner(x0, y0) * gy + corner(x0, yi) * wy
    right = corner(xi, y0) * gy + corner(xi, yi) * wy
    warped = left + (right - left) * wx
    warped = torch.where(valid[..., None], warped, torch.zeros_like(warped))
    prod = warped * ref_fea.float()[:, None]
    cg = c // groups
    return prod.reshape(b, d, h, w, groups, cg).sum(-1) / cg


def warp_and_correlate(src_fea, ref_fea, src_pair, ref_pair, depth_values,
                       groups, x_off: int = 0):
    """Fused plane-sweep warp + group correlation for one source view.

    Same arguments and result as warp_and_correlate_plain, differentiable
    in the two feature maps (their gradients in their own dtype). On CUDA
    tensors it runs the kernels (a [B, D, H, W, G] view of a [B, G, D, H,
    W] buffer); on CPU tensors the plain version.
    """
    if src_fea.is_cuda:
        return warp_corr.warp_corr(src_fea, ref_fea, src_pair, ref_pair,
                                   depth_values, groups, x_off=x_off)
    if src_fea.device.type == "cpu":
        return warp_and_correlate_plain(src_fea, ref_fea, src_pair,
                                        ref_pair, depth_values, groups,
                                        x_off)
    raise ValueError(f"warp_and_correlate: no path for device "
                     f"{src_fea.device}")


def aggregate_views(cor_feats, view_weights):
    """View-weighted average of per-view correlation volumes.

    cor_feats: [V, B, D, H, W, G] stacked per-source-view correlations.
    view_weights: [V, B, H, W] pixel-wise weights.
    Returns [B, D, H, W, G].
    """
    w = view_weights[:, :, None, :, :, None]               # [V,B,1,H,W,1]
    num = (cor_feats * w).sum(dim=0)
    den = w.sum(dim=0) + 1e-8
    return num / den
