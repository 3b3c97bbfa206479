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
"""

from __future__ import annotations

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
                             depth_values, groups):
    """Plane-sweep warp + group correlation in plain PyTorch.

    src_fea/ref_fea: [B, Hs, Ws, C] / [B, H, W, C] (NHWC).
    src_pair/ref_pair: [B, 2, 4, 4] (extrinsic, intrinsic) stacks.
    depth_values: [B, D, H, W] metric hypotheses.
    Returns [B, D, H, W, G] in the features' dtype.
    """
    rot, trans = relative_projection(src_pair, ref_pair)
    x, y = plane_sweep_coords(rot, trans, depth_values)
    warped = bilinear_sample(src_fea, x, y)
    return group_correlation(warped, ref_fea, groups)


def warp_and_correlate(src_fea, ref_fea, src_pair, ref_pair, depth_values,
                       groups):
    """Fused plane-sweep warp + group correlation for one source view.

    Same arguments and result as warp_and_correlate_plain, differentiable
    in the two feature maps. On CUDA tensors it runs the kernels (float32
    result, a [B, D, H, W, G] view of a [B, G, D, H, W] buffer); on CPU
    tensors the plain version.
    """
    if src_fea.is_cuda:
        return warp_corr.warp_corr(src_fea, ref_fea, src_pair, ref_pair,
                                   depth_values, groups)
    if src_fea.device.type == "cpu":
        return warp_and_correlate_plain(src_fea, ref_fea, src_pair,
                                        ref_pair, depth_values, groups)
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
