"""PyTorch port: the training datasets, the registry, the scene lists and
the training pipeline's seeding and rank split, against the JAX package's.

Samples are compared bit for bit, with Python's `random` seeded alike on
both sides for the source-view draws: all of it is integer or copied
data, or the same float32 numpy code.
"""

import os
import random

import numpy as np
import pytest
from PIL import Image

from diffmvs_tpu.data import scene_lists as jlists
from diffmvs_tpu.data.blend import MVSDataset as JaxBlend
from diffmvs_tpu.data.dtu import MVSDataset as JaxDTU
from diffmvs_tpu.data.pipeline import DataPipeline as JaxDataPipeline

from diffmvs_tpu_torch.data import blend, dtu, registry, scene_lists
from diffmvs_tpu_torch.data.io import save_pfm
from diffmvs_tpu_torch.data.pipeline import DataPipeline


def _k():
    return np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)


def _write_cam_txt(path, k, e, line4):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for r in range(4):
            f.write(" ".join(str(e[r, c]) for c in range(4)) + "\n")
        f.write("\nintrinsic\n")
        for r in range(3):
            f.write(" ".join(str(k[r, c]) for c in range(3)) + "\n")
        f.write("\n" + line4 + "\n")


def _make_dtu(root, scan="scan1", views=4):
    """The DTU training layout of tests/test_datasets.py: 1600x1200 raw
    depth and visibility, 640x512 images per light, 1/4-res intrinsics,
    with depths and a visibility that vary over the image."""
    rng = np.random.RandomState(0)
    os.makedirs(root / "Cameras" / "train")
    os.makedirs(root / f"Rectified/{scan}_train")
    os.makedirs(root / f"Depths_raw/{scan}")
    with open(root / "Cameras" / "pair.txt", "w") as f:
        f.write(f"{views}\n")
        for i in range(views):
            others = [j for j in range(views) if j != i]
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {10.0 - j}" for j in others) + "\n")
    for vid in range(views):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = 0.2 * vid
        _write_cam_txt(root / "Cameras" / "train" / f"{vid:08d}_cam.txt",
                       _k() * np.float32(1.0 + 0.01 * vid), e,
                       f"425.0 {2.5 + 0.1 * vid}")
        for light in range(7):
            img = (rng.rand(512, 640, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                root / f"Rectified/{scan}_train" /
                f"rect_{vid + 1:0>3}_{light}_r5000.png")
        depth = (300.0 + 700.0 * rng.rand(1200, 1600)).astype(np.float32)
        save_pfm(str(root / f"Depths_raw/{scan}" /
                     f"depth_map_{vid:0>4}.pfm"), depth)
        vis = (rng.rand(1200, 1600) * 30).astype(np.uint8)
        Image.fromarray(vis).save(
            root / f"Depths_raw/{scan}" / f"depth_visual_{vid:0>4}.png")
    (root / "list.txt").write_text(scan + "\n")


def _make_blend(root, scan, n_views=5, h=64, w=96, short_view=True):
    """The BlendedMVS layout of tests/test_train_loop.py, an invalid depth
    band, and (short_view) a view with too few sources."""
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        os.makedirs(root / scan / sub, exist_ok=True)
    k = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]],
                 np.float32)
    for i in range(n_views):
        img = (np.random.RandomState(i).rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(
            root / scan / "blended_images" / f"{i:08d}.jpg")
        th = 0.04 * i
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                     [-np.sin(th), 0, np.cos(th)]]
        e[:3, 3] = [0.25 * i, 0, 0]
        _write_cam_txt(root / scan / "cams" / f"{i:08d}_cam.txt", k, e,
                       "4.0 0.05 128 10.0")
        depth = np.random.RandomState(10 + i).uniform(
            3.0, 11.0, (h, w)).astype(np.float32)
        depth[:4] = 0.0
        save_pfm(str(root / scan / "rendered_depth_maps" / f"{i:08d}.pfm"),
                 depth)
    with open(root / scan / "cams" / "pair.txt", "w") as f:
        f.write(f"{n_views}\n")
        for i in range(n_views):
            others = [j for j in range(n_views) if j != i]
            if short_view and i == n_views - 1:
                others = others[:1]
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {10.0 - j}" for j in others) + "\n")


def _assert_equal(a, b, where=""):
    assert type(a) is type(b) or isinstance(a, np.ndarray), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def _samples(ds, idxs, seed):
    random.seed(seed)
    return [ds[i] for i in idxs]


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    _make_dtu(root)
    return root


@pytest.fixture(scope="module")
def blend_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("blend")
    _make_blend(root, "scanA")
    _make_blend(root, "scanB", n_views=4, short_view=False)
    (root / "list.txt").write_text("scanA\nscanB\n")
    return root


@pytest.mark.parametrize("mode", ["train", "test"])
def test_dtu_samples_equal_jax(dtu_root, mode):
    """Metas (7 lights in train mode, light 3 in test), and samples bit for
    bit: uint8 images, the cropped depth and mask pyramids, the
    interval-scaled linspace with its endpoint, the x{0.5, 1, 2, 4} stage
    intrinsics."""
    args = (str(dtu_root), str(dtu_root / "list.txt"), mode, 3, 384)
    port, ref = dtu.MVSDataset(*args), JaxDTU(*args)
    assert port.metas == ref.metas
    assert len(port) == (4 * 7 if mode == "train" else 4)
    idxs = [0, len(port) // 2 + 1, len(port) - 1]
    got, want = _samples(port, idxs, 5), _samples(ref, idxs, 5)
    for i, (a, b) in zip(idxs, zip(got, want)):
        _assert_equal(a, b, f"sample {i}")
    assert got[0]["imgs"].dtype == np.uint8
    assert got[0]["depth"]["stage4"].shape == (512, 640)
    assert 0.0 < got[0]["mask"]["stage4"].mean() < 1.0


@pytest.mark.parametrize("mode", ["train", "test"])
def test_blend_samples_equal_jax(blend_root, mode):
    """Per-scan pair files, the view with too few sources skipped, samples
    bit for bit (the endpoint-free linspace, masks within the range, the
    x{1/8, 1/4, 1/2, 1} stage intrinsics)."""
    args = (str(blend_root), str(blend_root / "list.txt"), mode, 4, 48)
    port, ref = blend.MVSDataset(*args), JaxBlend(*args)
    assert port.metas == ref.metas and len(port) == 4 + 4
    idxs = list(range(len(port)))
    for i, (a, b) in enumerate(zip(_samples(port, idxs, 7),
                                   _samples(ref, idxs, 7))):
        _assert_equal(a, b, f"sample {i}")


def test_registry_finds_the_port_datasets():
    assert registry.find_dataset_def("dtu") is dtu.MVSDataset
    assert registry.find_dataset_def("blend") is blend.MVSDataset
    with pytest.raises(ModuleNotFoundError):
        registry.find_dataset_def("nonexistent")


def test_scene_lists_equal_jax(tmp_path):
    assert scene_lists.ALL_LISTS == jlists.ALL_LISTS
    scene_lists.write_lists(str(tmp_path / "port"))
    jlists.write_lists(str(tmp_path / "jax"))
    for rel in jlists.ALL_LISTS:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    assert len(scene_lists.ALL_LISTS["dtu/train.txt"]) == 79


def test_in_process_pipeline_equals_jax(blend_root):
    """num_workers=0, shuffled, random.seed alike: the same batches in
    the same order as the JAX pipeline (its background thread draws from
    the calling process's `random` too)."""
    ds = blend.MVSDataset(str(blend_root), str(blend_root / "list.txt"),
                          "train", 3, 32)
    jds = JaxBlend(str(blend_root), str(blend_root / "list.txt"), "train",
                   3, 32)
    random.seed(3)
    got = [b for b in DataPipeline(ds, 3, shuffle=True, drop_last=True,
                                   seed=9)]
    random.seed(3)
    want = list(JaxDataPipeline(jds, 3, shuffle=True, drop_last=True,
                                seed=9))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _assert_equal({k: v for k, v in _numpy(a).items()}, b)


def _numpy(batch):
    if isinstance(batch, dict):
        return {k: _numpy(v) for k, v in batch.items()}
    return batch if isinstance(batch, list) else batch.numpy()


def test_worker_draws_repeat_from_the_seed(blend_root):
    """num_workers=2: the source draws depend on the seed alone (every
    sample draws 2 of its 3 sources)."""
    ds = blend.MVSDataset(str(blend_root), str(blend_root / "list.txt"),
                          "train", 3, 32)

    def draw(seed):
        pipe = DataPipeline(ds, 2, shuffle=True, drop_last=True, seed=seed,
                            num_workers=2)
        return [_numpy(b) for b in pipe]

    first, again = draw(4), draw(4)
    assert len(first) == 4
    for a, b in zip(first, again):
        _assert_equal(a, b)


def test_rank_split_covers_the_single_process_batches(blend_root):
    """Two ranks' rows of each global batch of 4, together, are the
    single-process batch (test mode: no random draws); an indivisible
    batch or a short last batch refuses to split."""
    ds = blend.MVSDataset(str(blend_root), str(blend_root / "list.txt"),
                          "test", 3, 32)
    whole = [_numpy(b) for b in DataPipeline(ds, 4, shuffle=True,
                                             drop_last=True, seed=2)]
    parts = [[_numpy(b) for b in DataPipeline(
        ds, 4, shuffle=True, drop_last=True, seed=2, rank=r, world_size=2)]
        for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for w, p0, p1 in zip(whole, parts[0], parts[1]):
        joined = {k: ({s: np.concatenate([p0[k][s], p1[k][s]])
                       for s in w[k]} if isinstance(w[k], dict)
                      else np.concatenate([p0[k], p1[k]]))
                  for k in w}
        _assert_equal(joined, w)
        assert p0["imgs"].shape[0] == 2
    with pytest.raises(ValueError, match="divide"):
        DataPipeline(ds, 3, shuffle=True, drop_last=True, world_size=2)
    with pytest.raises(ValueError, match="drop_last"):
        DataPipeline(ds, 4, world_size=2)
