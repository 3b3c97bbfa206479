"""PyTorch port: fusion, PLY files, point-cloud metrics and the DTU
evaluation against the JAX package, on the CPU.

The fusion inputs are a synthetic export directory (the files cli/test.py
writes): noisy depth maps of a plane seen from four translated cameras,
random confidences and images. Tolerances:
  * reprojection and consistency (dist in px, rel, depth) rtol 1e-5 /
    atol 1e-5: the same float32 operations, the camera products in the
    JAX package's FMA-chain rounding; votes may differ only for pixels
    within 1e-5 (relative) of a threshold. Pixels whose reprojection
    lands more than 10 px from where it started (ten times the loosest
    threshold) are those whose source sample straddles or leaves the
    image, where the sampled depth is near zero and the reprojection
    ill-conditioned (coordinates of 1e2-1e7 px); they are held at rtol
    2e-4 / atol 1e-5 and lie far beyond any threshold;
  * fused points rtol 1e-4 (float64 unprojection of float32 depth
    averages whose sums may round differently);
  * nearest-neighbour distances: the port measures the chosen pair's
    distance directly and matches a float64 brute force at rtol 1e-6;
    the JAX package takes it from the |a|^2 + |b|^2 - 2ab expansion,
    whose squared distances are good to a few float32 ulps of |a|^2 +
    |b|^2, so the two agree within that and the acc/comp means to 1e-4.
"""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffmvs_tpu.cli import eval_dtu as jeval
from diffmvs_tpu.data.io import save_pfm, write_cam
from diffmvs_tpu.fusion import fuse as jfuse
from diffmvs_tpu.fusion import metrics as jmetrics
from diffmvs_tpu.fusion import ply as jply

from diffmvs_tpu_torch.cli import eval_dtu as teval
from diffmvs_tpu_torch.fusion import fuse, metrics, ply

from test_eval_dtu import _grid_cloud, _make_gt_dir, _write_cloud

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)
FAR_TOL = dict(rtol=2e-4, atol=1e-5)   # ill-conditioned, > 10 px off
H, W, VIEWS = 48, 64, 4


def _assert_reprojections_close(got, want, dist):
    """got/want [..., H, W]; dist: the reference's reprojection distance
    in px, which selects the ill-conditioned pixels."""
    got, want = np.asarray(got), np.asarray(want)
    far = np.broadcast_to(np.asarray(dist) > 10.0, want.shape)
    assert far.mean() < 0.2
    np.testing.assert_allclose(got[~far], want[~far], **TOL)
    np.testing.assert_allclose(got[far], want[far], **FAR_TOL)


def _cams(i):
    k = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    e = np.eye(4, dtype=np.float32)
    e[:3, 3] = [0.3 * i, 0.05 * (i % 2), 0.0]
    return k, e


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """cli/test.py's export layout: depth_est/, conf{0,1,2}/, cams/,
    images/ and the scene's pair.txt."""
    from PIL import Image

    root = tmp_path_factory.mktemp("export")
    rng = np.random.RandomState(0)
    for sub in ("depth_est", "conf0", "conf1", "conf2", "cams", "images"):
        os.makedirs(root / sub)
    for i in range(VIEWS):
        k, e = _cams(i)
        depth = 6.0 * (1.0 + 0.004 * rng.randn(H, W))
        depth[rng.rand(H, W) < 0.05] *= 1.3                 # outliers
        save_pfm(str(root / "depth_est" / f"{i:08d}.pfm"),
                 depth.astype(np.float32))
        for c in range(3):
            save_pfm(str(root / f"conf{c}" / f"{i:08d}.pfm"),
                     rng.rand(H, W).astype(np.float32))
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0], cam[1, :3, :3] = e, k
        write_cam(str(root / "cams" / f"{i:08d}_cam.txt"), cam,
                  np.float32(10.0), np.float32(2.0))
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"{i:08d}.jpg")
    with open(root / "pair.txt", "w") as f:
        f.write(f"{VIEWS}\n")
        for i in range(VIEWS):
            others = [j for j in range(VIEWS) if j != i]
            f.write(f"{i}\n{len(others)} "
                    + " ".join(f"{j} {10.0 - j}" for j in others) + "\n")
    return root


def _views(export_dir, ref, srcs):
    return [jfuse._load_view(str(export_dir), v) for v in [ref] + srcs]


def test_reproject_with_depth_matches_jax(export_dir):
    (k0, e0, _, _, d0), (k1, e1, _, _, d1) = _views(export_dir, 0, [2])
    want = jax.jit(jfuse.reproject_with_depth)(d0, k0, e0, d1, k1, e1)
    got = fuse.reproject_with_depth(T(d0), T(k0), T(e0), T(d1), T(k1), T(e1))
    ys, xs = np.mgrid[:H, :W]
    dist = np.hypot(np.asarray(want[1]) - xs, np.asarray(want[2]) - ys)
    for g, w in zip(got, want):
        _assert_reprojections_close(g.numpy(), w, dist)


def test_check_geometric_consistency_matches_jax(export_dir):
    (k0, e0, dmax, dmin, d0), (k1, e1, _, _, d1) = _views(
        export_dir, 0, [1])
    want = jax.jit(jfuse.check_geometric_consistency)(
        d0, k0, e0, d1, k1, e1, jnp.float32(dmax), jnp.float32(dmin),
        1.0, 0.01)
    got = fuse.check_geometric_consistency(
        T(d0), T(k0), T(e0), T(d1), T(k1), T(e1), dmax, dmin, 1.0, 0.01)
    assert 0.1 < got[0].float().mean() < 0.9
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_consistency_batch_matches_jax(export_dir):
    """The port's unpadded batch against the JAX package's padded one
    (bucket 10, the padding slots masked out)."""
    views = _views(export_dir, 1, [0, 2, 3])
    (k_ref, e_ref, dmax, dmin, d_ref), srcs = views[0], views[1:]
    k, e, d = (np.stack([s[i] for s in srcs]) for i in (0, 1, 4))
    pad = lambda a: np.concatenate([a, np.repeat(a[-1:], 7, 0)])  # noqa
    valid = np.arange(10) < 3
    want = jfuse._consistency_batch(
        d_ref, k_ref, e_ref, pad(d), pad(k), pad(e), valid,
        jnp.float32(dmax), jnp.float32(dmin), jnp.float32(1.0),
        jnp.float32(0.01))
    got = fuse._consistency_batch(
        T(d_ref), T(k_ref), T(e_ref), T(d), T(k), T(e), dmax, dmin, 1.0,
        0.01)
    dist, rel = np.asarray(want[0])[:3], np.asarray(want[1])[:3]
    for g, w in zip(got[:3], want[:3]):          # dist, rel, depth_reproj
        _assert_reprojections_close(g.numpy(), np.asarray(w)[:3], dist)
    near = ((np.abs(dist - 1.0) <= 1e-5) | (np.abs(rel - 0.01) <= 1e-7))
    flips = got[3].numpy() != np.asarray(want[3])[:3]
    assert not (flips & ~near).any()
    mask = got[3].numpy()
    assert 0.1 < mask.mean() < 0.9
    if not flips.any():
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), **TOL)


def _fused(tmp_path, export_dir, tag, run):
    out = tmp_path / tag
    shutil.copytree(export_dir, out)
    run(str(out))
    xyz, rgb = ply.read_ply(str(out / "pc.ply"))
    masks = {p: open(out / "mask" / p, "rb").read()
             for p in sorted(os.listdir(out / "mask"))}
    return xyz, rgb, masks


def _assert_fusions_equal(got, want):
    xyz_t, rgb_t, masks_t = got
    xyz_j, rgb_j, masks_j = want
    assert masks_t.keys() == masks_j.keys()
    assert len(masks_t) == 3 * VIEWS
    for name in masks_t:
        assert masks_t[name] == masks_j[name], name
    assert 0 < xyz_t.shape[0] == xyz_j.shape[0]
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(rgb_t, rgb_j)


def test_filter_depth_matches_jax(tmp_path, export_dir):
    kw = dict(geo_mask_thres=2, geo_pixel_thres=1.0, geo_depth_thres=0.01,
              photo_thres=(0.1, 0.1, 0.1), method="casdiffmvs")
    want = _fused(tmp_path, export_dir, "jax", lambda out: jfuse.filter_depth(
        out, out, os.path.join(out, "pc.ply"), **kw))
    got = _fused(tmp_path, export_dir, "port", lambda out: fuse.filter_depth(
        out, out, os.path.join(out, "pc.ply"), device="cpu", **kw))
    _assert_fusions_equal(got, want)


def test_filter_depth_dynamic_matches_jax(tmp_path, export_dir):
    kw = dict(photo_thres=(0.1, 0.1, 0.1), method="casdiffmvs",
              dynamic_params={"syn": (2, 4, 1300)})
    want = _fused(tmp_path, export_dir, "jax",
                  lambda out: jfuse.filter_depth_dynamic(
                      "syn", out, out, os.path.join(out, "pc.ply"), **kw))
    got = _fused(tmp_path, export_dir, "port",
                 lambda out: fuse.filter_depth_dynamic(
                     "syn", out, out, os.path.join(out, "pc.ply"),
                     device="cpu", **kw))
    _assert_fusions_equal(got, want)


def test_ply_files_are_byte_identical(tmp_path, rng):
    xyz = rng.randn(50, 3).astype(np.float32)
    rgb = (rng.rand(50, 3) * 255).astype(np.uint8)
    jply.write_ply(str(tmp_path / "j.ply"), xyz, rgb)
    ply.write_ply(str(tmp_path / "t.ply"), xyz, rgb)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    ply.write_ply(str(tmp_path / "f.ply"), xyz, rgb / 255.0)
    jply.write_ply(str(tmp_path / "jf.ply"), xyz, rgb / 255.0)
    assert (tmp_path / "f.ply").read_bytes() == (tmp_path / "jf.ply").read_bytes()
    got_xyz, got_rgb = ply.read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(got_xyz, xyz)
    np.testing.assert_array_equal(got_rgb, rgb)


def test_nn_distances_and_accuracy_completeness_match_jax(rng):
    pred = (rng.rand(3000, 3) * [30, 30, 2]).astype(np.float32)
    gt = metrics.sample_mesh_plane(1.0, (0, 30), (0, 30), 0.5)
    np.testing.assert_array_equal(
        gt, jmetrics.sample_mesh_plane(1.0, (0, 30), (0, 30), 0.5))
    got = metrics.nn_distances(pred, gt, device="cpu")
    exact = np.sqrt(((pred[:, None].astype(np.float64) - gt[None]) ** 2)
                    .sum(-1).min(1))
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-7)
    want = np.asarray(jax.jit(jmetrics.nn_distances)(pred, gt))
    ulps = 4 * np.finfo(np.float32).eps * (
        (pred ** 2).sum(1).max() + (gt ** 2).sum(1).max())
    np.testing.assert_allclose(got ** 2, want ** 2, rtol=0, atol=ulps)
    # a small chunk budget splits the queries unevenly
    np.testing.assert_array_equal(
        metrics.nn_distances(pred, gt, chunk=700, device="cpu"), got)
    want = jmetrics.accuracy_completeness(pred, gt, max_dist=1.5, tau=0.5)
    got = metrics.accuracy_completeness(pred, gt, max_dist=1.5, tau=0.5,
                                        device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    empty = metrics.accuracy_completeness(np.zeros((0, 3)), gt, device="cpu")
    assert empty["f_score"] == 0.0 and np.isnan(empty["overall"])


@pytest.mark.parametrize("masked", [True, False])
def test_eval_dtu_matches_jax(tmp_path, masked):
    gt = _grid_cloud(900, z=10.0)
    _make_gt_dir(str(tmp_path / "gt"), 4, gt, with_masks=masked)
    pred = _grid_cloud(900, z=10.3, jitter=0.05, seed=1)
    _write_cloud(str(tmp_path / "pc" / "mvs004_l3.ply"), pred)
    args = ["--pc_dir", str(tmp_path / "pc"), "--gt_dir",
            str(tmp_path / "gt"), "--scans", "4"]
    want = jeval.main(args + ["--json", str(tmp_path / "j.json")])
    got = teval.main(args + ["--json", str(tmp_path / "t.json"),
                             "--device", "cpu"])
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert got["scans"][0]["masked"] == masked
    for k in ("acc_mean", "comp_mean", "overall"):
        assert got["mean"][k] == pytest.approx(want["mean"][k], rel=1e-4)
    np.testing.assert_array_equal(teval.reduce_pts(pred, 2.0),
                                  jeval.reduce_pts(pred, 2.0))


def test_fusion_entry_points_need_cuda_unless_cpu_asked(
        tmp_path, export_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    shutil.copytree(export_dir, out)
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse.filter_depth(out, out, os.path.join(out, "pc.ply"))
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.nn_distances(np.zeros((2, 3)), np.ones((3, 3)))
    gt = _grid_cloud(100)
    _make_gt_dir(str(tmp_path / "gt"), 1, gt, with_masks=False)
    _write_cloud(str(tmp_path / "pc" / "mvs001_l3.ply"), gt)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["--pc_dir", str(tmp_path / "pc"), "--gt_dir",
                    str(tmp_path / "gt"), "--scans", "1"])
