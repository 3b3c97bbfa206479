"""Geometric + photometric consistency fusion, on the card.

Counterpart of diffmvs_tpu/fusion/fuse.py (the reference's filter.py:
reproject_with_depth, check_geometric_consistency, filter_depth and the
D2HC-style filter_depth_dynamic). For each reference view one batched
pass reprojects its depth into all of its source views (at most
`src_bucket`, the first ones of the pair list) and reduces the
consistency votes on the device; the host reads the PFM/cam/JPEG files,
applies the photometric mask and unprojects the kept pixels in float64
numpy, as the JAX package does. The JAX package pads the source list to
the bucket size so that one compiled program serves every view; eager
PyTorch needs no padding.

The camera products go through geometry/transforms._mm, the FMA-chain
rounding of the JAX package's full-precision matmuls, in float32 without
TF32, so a pixel's vote flips against the JAX result only when its
distance or relative depth difference lies within a few ulps of its
threshold.

The entry points take device=None, meaning CUDA; without a card they
raise unless device="cpu" is asked for.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

from diffmvs_tpu_torch.api import resolve_device, set_f32_precision
from diffmvs_tpu_torch.data.io import (
    read_camera_parameters,
    read_img,
    read_pair_file,
    read_pfm,
    save_mask,
)
from diffmvs_tpu_torch.fusion.ply import write_ply
from diffmvs_tpu_torch.geometry.sampling import bilinear_sample
from diffmvs_tpu_torch.geometry.transforms import (
    _mm,
    invert_intrinsics,
    invert_rigid,
)


def fusion_device(device=None) -> torch.device:
    """api.resolve_device (None means CUDA, which raises where there is
    none), with TF32 off on CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_f32_precision()
    return dev


def _pixel_grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return xs, ys


def _reproject(depth_ref, k_ref, e_ref, depth_srcs, k_srcs, e_srcs):
    """reproject_with_depth for S source views at once.

    depth_ref [H, W]; depth_srcs [S, H, W]; k_* [.., 3, 3]; e_* [.., 4, 4].
    Returns (depth_reproj, x_reproj, y_reproj, x_src, y_src), each
    [S, H, W].
    """
    h, w = depth_ref.shape
    s = depth_srcs.shape[0]
    dev = depth_ref.device
    xs, ys = _pixel_grid(h, w, dev)
    ones = torch.ones(h * w, dtype=torch.float32, device=dev)
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1), ones])    # [3, HW]

    # ref pixels -> ref cam -> src cam
    xyz_ref = _mm(invert_intrinsics(k_ref), grid * depth_ref.reshape(1, -1))
    rel = _mm(e_srcs, invert_rigid(e_ref)[None])                  # [S,4,4]
    xyz_src = _mm(rel[:, :3, :3], xyz_ref[None]) + rel[:, :3, 3:4]
    k_xyz = _mm(k_srcs, xyz_src)                                  # [S,3,HW]
    xy_src = k_xyz[:, :2] / k_xyz[:, 2:3]
    x_src = xy_src[:, 0].reshape(s, h, w)
    y_src = xy_src[:, 1].reshape(s, h, w)

    # sample the src depths (cv2.remap INTER_LINEAR, border 0 == the
    # zero-padded bilinear sample)
    sampled = bilinear_sample(depth_srcs[..., None], x_src, y_src)[..., 0]

    # back-project with the sampled depth -> ref
    xyz_src2 = _mm(invert_intrinsics(k_srcs),
                   torch.cat([xy_src, ones.expand(s, 1, h * w)], 1)
                   * sampled.reshape(s, 1, -1))
    rel_back = _mm(e_ref[None], invert_rigid(e_srcs))
    xyz_reproj = _mm(rel_back[:, :3, :3], xyz_src2) + rel_back[:, :3, 3:4]
    depth_reproj = xyz_reproj[:, 2].reshape(s, h, w)

    k_xyz_reproj = _mm(k_ref[None], xyz_reproj)
    k_xyz_reproj = torch.where(k_xyz_reproj == 0.0,
                               torch.full_like(k_xyz_reproj, 1e-5),
                               k_xyz_reproj)
    xy_reproj = torch.clamp(k_xyz_reproj[:, :2] / k_xyz_reproj[:, 2:3],
                            -1e8, 1e8)
    x_reproj = xy_reproj[:, 0].reshape(s, h, w)
    y_reproj = xy_reproj[:, 1].reshape(s, h, w)
    return depth_reproj, x_reproj, y_reproj, x_src, y_src


def reproject_with_depth(depth_ref, k_ref, e_ref, depth_src, k_src, e_src):
    """Project the ref depth into one source view and back.

    depth_ref, depth_src: [H, W]; k_*: [3, 3]; e_*: [4, 4] float32 tensors
    on one device. Returns (depth_reprojected, x_reprojected,
    y_reprojected, x_src, y_src), each [H, W].
    """
    out = _reproject(depth_ref, k_ref, e_ref, depth_src[None], k_src[None],
                     e_src[None])
    return tuple(o[0] for o in out)


def check_geometric_consistency(depth_ref, k_ref, e_ref, depth_src, k_src,
                                e_src, depth_max, depth_min,
                                geo_pixel_thres=1.0, geo_depth_thres=0.01):
    """Single source view consistency mask: (mask, masked reprojected
    depth, x_src, y_src)."""
    h, w = depth_ref.shape
    xs, ys = _pixel_grid(h, w, depth_ref.device)
    depth_reproj, x2d, y2d, xs_src, ys_src = reproject_with_depth(
        depth_ref, k_ref, e_ref, depth_src, k_src, e_src)
    dist = torch.sqrt((x2d - xs) ** 2 + (y2d - ys) ** 2)
    rel_diff = torch.abs(depth_reproj - depth_ref) / depth_ref
    mask = (dist < geo_pixel_thres) & (rel_diff < geo_depth_thres)
    mask &= (depth_ref > depth_min) & (depth_ref < depth_max)
    return (mask, torch.where(mask, depth_reproj,
                              torch.zeros_like(depth_reproj)),
            xs_src, ys_src)


def _f32(v, dev):
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def _consistency_batch(depth_ref, k_ref, e_ref, depth_srcs, k_srcs, e_srcs,
                       depth_max, depth_min, pix_thres, d_thres):
    """All-source-view reprojection: per-view (dist, rel_diff,
    depth_reproj) [S, H, W], the vote mask [S, H, W], and the reduction
    (geo_sum, depth_avg) [H, W].

    Tensors on one device; depth_srcs [S, H, W]. The scalars compare in
    float32.
    """
    dev = depth_ref.device
    h, w = depth_ref.shape
    xs, ys = _pixel_grid(h, w, dev)
    depth_reproj, x2d, y2d, _, _ = _reproject(
        depth_ref, k_ref, e_ref, depth_srcs, k_srcs, e_srcs)
    dist = torch.sqrt((x2d - xs) ** 2 + (y2d - ys) ** 2)
    rel = torch.abs(depth_reproj - depth_ref) / depth_ref

    in_range = (depth_ref > _f32(depth_min, dev)) & (
        depth_ref < _f32(depth_max, dev))
    mask = ((dist < _f32(pix_thres, dev)) & (rel < _f32(d_thres, dev))
            & in_range[None])
    geo_sum = mask.to(torch.int32).sum(0)
    depth_sum = torch.where(mask, depth_reproj,
                            torch.zeros_like(depth_reproj)).sum(0)
    depth_avg = (depth_sum + depth_ref) / (geo_sum + 1)
    return dist, rel, depth_reproj, mask, geo_sum, depth_avg


def _load_view(out_folder: str, view: int):
    intr, extr, dmax, dmin = read_camera_parameters(
        os.path.join(out_folder, f"cams/{view:08d}_cam.txt"))
    depth = read_pfm(
        os.path.join(out_folder, f"depth_est/{view:08d}.pfm"))[0]
    return intr, extr, dmax, dmin, np.ascontiguousarray(depth)


def load_views(out_folder: str, ref_view: int, src_views: Sequence[int],
               src_bucket: int, dev):
    """The ref view and its first `src_bucket` source views, uploaded:
    (k_ref, e_ref, depth_max, depth_min, ref_depth, k_srcs, e_srcs,
    d_srcs) with the tensors on `dev`."""
    k_ref, e_ref, depth_max, depth_min, ref_depth = _load_view(
        out_folder, ref_view)
    srcs = [_load_view(out_folder, v) for v in list(src_views)[:src_bucket]]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (up(k_ref), up(e_ref), depth_max, depth_min, up(ref_depth),
            up(np.stack([s[0] for s in srcs])),
            up(np.stack([s[1] for s in srcs])),
            up(np.stack([s[4] for s in srcs])))


def _photo_mask(out_folder: str, ref_view: int, photo_thres,
                method: str, dynamic: bool = False) -> np.ndarray:
    """AND of the per-stage confidence thresholds (host)."""
    n_conf = 3 if method == "casdiffmvs" else 2
    confs = [read_pfm(os.path.join(
        out_folder, f"conf{i}/{ref_view:08d}.pfm"))[0] for i in range(n_conf)]
    if method == "casdiffmvs":
        mask = ((confs[0] > photo_thres[0]) & (confs[1] > photo_thres[1])
                & (confs[2] > photo_thres[2]))
    elif dynamic:
        # the DiffMVS dynamic path thresholds the refinement confidence
        # with the LAST threshold (the reference's filter.py)
        mask = (confs[0] > photo_thres[0]) & (confs[1] > photo_thres[2])
    else:
        mask = (confs[0] > photo_thres[0]) & (confs[1] > photo_thres[1])
    return mask


def _unproject_masked(depth_avg, final_mask, ref_img, k_ref, e_ref):
    """Masked pixels -> world points + colors (host, float64)."""
    h, w = depth_avg.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    valid = np.asarray(final_mask)
    x = xs[valid]
    y = ys[valid]
    depth = np.asarray(depth_avg)[valid]
    color = ref_img[valid]
    xyz_ref = np.linalg.inv(k_ref) @ (
        np.vstack((x, y, np.ones_like(x))) * depth)
    xyz_world = (np.linalg.inv(e_ref) @ np.vstack(
        (xyz_ref, np.ones_like(x))))[:3]
    return xyz_world.T, color


def _save_masks(out_folder, ref_view, photo_mask, geo_mask, final_mask):
    os.makedirs(os.path.join(out_folder, "mask"), exist_ok=True)
    for name, m in (("photo", photo_mask), ("geo", geo_mask),
                    ("final", final_mask)):
        save_mask(os.path.join(out_folder, f"mask/{ref_view:08d}_{name}.png"),
                  m)


def filter_depth(pair_folder: str, out_folder: str, plyfilename: str,
                 geo_mask_thres: int = 3, geo_pixel_thres: float = 1.0,
                 geo_depth_thres: float = 0.01,
                 photo_thres=(0.3, 0.5, 0.5), method: str = "casdiffmvs",
                 dataset: str = "dtu", src_bucket: int = 10,
                 save_masks: bool = True, device=None) -> int:
    """Standard fusion (the reference's filter_depth). Returns the number
    of points written."""
    dev = fusion_device(device)
    pair_data = read_pair_file(os.path.join(pair_folder, "pair.txt"), dataset)

    vertexs, vertex_colors = [], []
    for ref_view, src_views in pair_data:
        (k_ref, e_ref, depth_max, depth_min, ref_depth, k_srcs, e_srcs,
         d_srcs) = load_views(out_folder, ref_view, src_views, src_bucket,
                              dev)
        ref_img = read_img(
            os.path.join(out_folder, f"images/{ref_view:08d}.jpg"))
        photo_mask = _photo_mask(out_folder, ref_view, photo_thres, method)

        _, _, _, _, geo_sum, depth_avg = _consistency_batch(
            ref_depth, k_ref, e_ref, d_srcs, k_srcs, e_srcs, depth_max,
            depth_min, geo_pixel_thres, geo_depth_thres)

        geo_mask = (geo_sum >= geo_mask_thres).cpu().numpy()
        final_mask = photo_mask & geo_mask
        if save_masks:
            _save_masks(out_folder, ref_view, photo_mask, geo_mask,
                        final_mask)

        print(f"processing {out_folder}, ref-view{ref_view:02d}, "
              f"photo/geo/final-mask:{photo_mask.mean():.3f}/"
              f"{geo_mask.mean():.3f}/{final_mask.mean():.3f}")

        xyz, color = _unproject_masked(depth_avg.cpu().numpy(), final_mask,
                                       ref_img, k_ref.cpu().numpy(),
                                       e_ref.cpu().numpy())
        vertexs.append(xyz)
        vertex_colors.append(color)

    xyz = np.concatenate(vertexs)
    write_ply(plyfilename, xyz, np.concatenate(vertex_colors))
    print("saving the final model to", plyfilename)
    return xyz.shape[0]


def _dynamic_mask_family(dist, rel, depth_reproj, ref_depth, dist_div,
                         rel_div, dh_view_num: int):
    """The D2HC mask family i in [dh_view_num, 10]: accept a pixel if at
    least i source views are consistent at the i-th loosest thresholds for
    some i, or at least 10 views at the strict thresholds. Also returns
    the strict-mask depth average."""
    dev = dist.device
    dist_div, rel_div = _f32(dist_div, dev), _f32(rel_div, dev)
    strict = (dist < 10.0 / dist_div) & (rel < 10.0 / rel_div)
    geo_mask_sum = strict.sum(0)
    geo_mask = geo_mask_sum >= 10
    for i in range(dh_view_num, 11):
        mi = ((dist < i / dist_div) & (rel < i / rel_div)).sum(0)
        geo_mask |= mi >= i
    depth_masked = torch.where(strict, depth_reproj,
                               torch.zeros_like(depth_reproj))
    depth_avg = (depth_masked.sum(0) + ref_depth) / (geo_mask_sum + 1)
    return geo_mask, depth_avg


def filter_depth_dynamic(scan: str, pair_folder: str, out_folder: str,
                         plyfilename: str, photo_thres=(0.3, 0.5, 0.5),
                         method: str = "casdiffmvs",
                         dynamic_params: Dict = None,
                         src_bucket: int = 10,
                         save_masks: bool = True, device=None) -> int:
    """D2HC-RMVSNet-style dynamic consistency for T&T (the reference's
    filter_depth_dynamic). dynamic_params: {scan: (dh_view_num, dist_div,
    rel_diff_div)}, by default config.TANK_DYNAMIC_PARAMS. Returns the
    number of points written."""
    from diffmvs_tpu_torch.config import TANK_DYNAMIC_PARAMS

    dev = fusion_device(device)
    params = dynamic_params or TANK_DYNAMIC_PARAMS
    dh_view_num, dist_div, rel_div = params[scan]

    pair_data = read_pair_file(os.path.join(pair_folder, "pair.txt"))
    vertexs, vertex_colors = [], []

    for ref_view, src_views in pair_data:
        (k_ref, e_ref, depth_max, depth_min, ref_depth, k_srcs, e_srcs,
         d_srcs) = load_views(out_folder, ref_view, src_views, src_bucket,
                              dev)
        ref_img = read_img(
            os.path.join(out_folder, f"images/{ref_view:08d}.jpg"))
        photo_mask = _photo_mask(out_folder, ref_view, photo_thres, method,
                                 dynamic=True)

        # the mask family uses the i=10 mask as the "strict" mask
        dist, rel, depth_reproj, _, _, _ = _consistency_batch(
            ref_depth, k_ref, e_ref, d_srcs, k_srcs, e_srcs, depth_max,
            depth_min, 10.0 / dist_div, 10.0 / rel_div)

        geo_mask, depth_avg = _dynamic_mask_family(
            dist, rel, depth_reproj, ref_depth, dist_div, rel_div,
            dh_view_num)
        geo_mask = geo_mask.cpu().numpy()
        depth_avg = depth_avg.cpu().numpy()
        mask_depth = (depth_avg >= depth_min) & (depth_avg <= depth_max)

        final_mask = photo_mask & geo_mask & mask_depth
        if save_masks:
            _save_masks(out_folder, ref_view, photo_mask, geo_mask,
                        final_mask)

        print(f"processing {out_folder}, ref-view{ref_view:02d}, "
              f"photo/geo/final-mask:{photo_mask.mean():.3f}/"
              f"{geo_mask.mean():.3f}/{final_mask.mean():.3f}")

        xyz, color = _unproject_masked(depth_avg, final_mask, ref_img,
                                       k_ref.cpu().numpy(),
                                       e_ref.cpu().numpy())
        vertexs.append(xyz)
        vertex_colors.append(color)

    xyz = np.concatenate(vertexs)
    write_ply(plyfilename, xyz, np.concatenate(vertex_colors))
    print("saving the final model to", plyfilename)
    return xyz.shape[0]
