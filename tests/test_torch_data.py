"""PyTorch port: the eval data layer against the JAX package's.

Codecs write byte-identical files and read back equal arrays; resizes and
the native JPEG decode are bit-exact; MVSDataset samples and DataPipeline
batches are exactly equal (general, dtu and .npy serving-cache layouts;
in-process and worker-process loading). No tolerances: all of it is
integer or copied data.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffmvs_tpu.data import io as jio
from diffmvs_tpu.data import native_io as jnative
from diffmvs_tpu.data import resize as jresize
from diffmvs_tpu.data.mvs import MVSDataset as JaxMVSDataset
from diffmvs_tpu.data.pipeline import DataPipeline as JaxDataPipeline

from diffmvs_tpu_torch.data import io as tio
from diffmvs_tpu_torch.data import native_io as tnative
from diffmvs_tpu_torch.data import resize as tresize
from diffmvs_tpu_torch.data.mvs import MVSDataset
from diffmvs_tpu_torch.data.pipeline import DataPipeline


def _same_bytes(path_a, path_b):
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        return fa.read() == fb.read()


def _cam(i):
    k = np.array([[100.0, 0, 48], [0, 100.0, 32], [0, 0, 1]], np.float32)
    e = np.eye(4, dtype=np.float32)
    e[0, 3] = 0.2 * i
    e[1, 3] = -0.03 * i
    return k, e


def _write_cam_txt(path, k, e, line4):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for r in range(4):
            f.write(" ".join(str(e[r, c]) for c in range(4)) + "\n")
        f.write("\nintrinsic\n")
        for r in range(3):
            f.write(" ".join(str(k[r, c]) for c in range(3)) + "\n")
        f.write("\n" + line4 + "\n")


def _make_scene(root, cam_dir, hw=(70, 100), npy_hw=None, views=4,
                seed=0):
    """A scene directory: JPEG (or, with npy_hw, uint8 .npy) images, cam
    files and a pair.txt whose low-score entries the dataset filters."""
    rng = np.random.RandomState(seed)
    os.makedirs(root / "images")
    os.makedirs(root / cam_dir)
    for i in range(views):
        if npy_hw is None:
            img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(root / "images" / f"{i:08d}.jpg")
        else:
            img = (rng.rand(*npy_hw, 3) * 255).astype(np.uint8)
            np.save(root / "images" / f"{i:08d}.npy", img)
        k, e = _cam(i)
        _write_cam_txt(root / cam_dir / f"{i:08d}_cam.txt", k, e,
                       "2.5 0.05 192 10.0")
    with open(root / "pair.txt", "w") as f:
        f.write(f"{views}\n")
        for i in range(views):
            others = [j for j in range(views) if j != i]
            scores = [5.0, 0.05, 3.0, 0.005][:len(others)]
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {s}" for j, s in zip(others, scores)) + "\n")


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            assert a[key].keys() == b[key].keys()
            for k in a[key]:
                x, y = np.asarray(a[key][k]), np.asarray(b[key][k])
                assert x.dtype == y.dtype, (key, k)
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[key], (str, list)):
            assert a[key] == b[key]
        else:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype, key
            np.testing.assert_array_equal(x, y)


def test_codecs_write_identical_files(tmp_path, rng):
    depth = rng.rand(7, 9).astype(np.float32)
    color = rng.rand(5, 6, 3).astype(np.float32)
    cam = np.stack([_cam(1)[1], np.eye(4, dtype=np.float32)])
    cam[1, :3, :3] = _cam(1)[0]
    mask = rng.rand(7, 9) > 0.5
    for name, mod in (("jax", jio), ("port", tio)):
        mod.save_pfm(str(tmp_path / f"{name}_d.pfm"), depth)
        mod.save_pfm(str(tmp_path / f"{name}_c.pfm"), color, scale=2.0)
        mod.write_cam(str(tmp_path / f"{name}_cam.txt"), cam,
                      np.float32(1) / np.float32(0.1),
                      np.float32(1) / np.float32(0.25))
        mod.save_mask(str(tmp_path / f"{name}_m.png"), mask)
    for f in ("_d.pfm", "_c.pfm", "_cam.txt", "_m.png"):
        assert _same_bytes(tmp_path / f"jax{f}", tmp_path / f"port{f}"), f

    for f in ("_d.pfm", "_c.pfm"):
        (a, sa), (b, sb) = (m.read_pfm(str(tmp_path / f"jax{f}"))
                            for m in (jio, tio))
        np.testing.assert_array_equal(a, b)
        assert sa == sb
    np.testing.assert_array_equal(tio.read_pfm(
        str(tmp_path / "port_d.pfm"))[0], depth)
    for reader in ("read_cam_file", "read_camera_parameters"):
        a = getattr(jio, reader)(str(tmp_path / "jax_cam.txt"))
        b = getattr(tio, reader)(str(tmp_path / "jax_cam.txt"))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_pair_and_image_readers_match(tmp_path):
    _make_scene(tmp_path, "cams")
    pair = str(tmp_path / "pair.txt")
    for ds in ("dtu", "eth3d"):
        assert tio.read_pair_file(pair, ds) == jio.read_pair_file(pair, ds)
    assert (tio.read_pair_file_scored(pair)
            == jio.read_pair_file_scored(pair))
    img = str(tmp_path / "images" / "00000001.jpg")
    np.testing.assert_array_equal(tio.read_img(img), jio.read_img(img))
    np.testing.assert_array_equal(tio.read_img_u8(img), jio.read_img_u8(img))


def test_resizes_are_bit_equal(rng):
    u8 = (rng.rand(70, 100, 3) * 255).astype(np.uint8)
    f32 = rng.rand(70, 100, 3).astype(np.float32)
    for img in (u8, f32, Image.fromarray(u8)):
        for size, dtype in (((96, 64), np.uint8), ((96, 64), np.float32),
                            ((100, 70), np.float32), ((160, 112), np.uint8)):
            a = jresize.resize_image_bilinear(img, size, dtype=dtype)
            b = tresize.resize_image_bilinear(img, size, dtype=dtype)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    arr = rng.rand(64, 80).astype(np.float32)
    np.testing.assert_array_equal(tresize.resize_nearest(arr, (30, 20)),
                                  jresize.resize_nearest(arr, (30, 20)))
    a, b = (m.multiscale_pyramid(arr) for m in (jresize, tresize))
    _assert_samples_equal(a, b)


@pytest.mark.parametrize("layout", ["general", "dtu", "npy"])
def test_mvs_dataset_samples_equal(tmp_path, layout):
    """general: adaptive resize of 70x100 JPEGs to 64x96; dtu: scanN/
    layout with cams_1 and the fixed 1152x1600 size; npy: the uint8
    serving cache (one image already at the target size, the scene's
    others resized)."""
    if layout == "dtu":
        root, scans = tmp_path / "scan3", ["scan3"]
        root.mkdir()
        _make_scene(root, "cams_1", hw=(96, 128))
        kw = dict(dataset="dtu", scan=scans)
        data_root = tmp_path
    else:
        root = tmp_path
        _make_scene(root, "cams", npy_hw=(64, 96) if layout == "npy"
                    else None)
        if layout == "npy":
            np.save(root / "images" / "00000002.npy",
                    np.zeros((70, 100, 3), np.uint8) + 7)
        kw = dict(dataset="general")
        data_root = root
    ds = MVSDataset(str(data_root), n_views=3, numdepth=32, **kw)
    jds = JaxMVSDataset(str(data_root), n_views=3, numdepth=32, **kw)
    assert len(ds) == len(jds) == 4
    assert ds.metas == jds.metas
    for i in range(len(ds)):
        _assert_samples_equal(ds[i], jds[i])
    s = ds[0]
    assert s["imgs"].dtype == np.uint8
    want_hw = (1152, 1600) if layout == "dtu" else (64, 96)
    assert s["imgs"].shape == (3,) + want_hw + (3,)


@pytest.mark.parametrize("workers", [0, 2])
def test_pipeline_batches_equal(tmp_path, workers):
    """The DataLoader's batches are the JAX pipeline's, in order, as CPU
    tensors (uint8 images), including a shuffled epoch and the tail."""
    _make_scene(tmp_path, "cams", views=5)
    ds = MVSDataset(str(tmp_path), n_views=3, numdepth=16,
                    dataset="general")
    jds = JaxMVSDataset(str(tmp_path), n_views=3, numdepth=16,
                        dataset="general")
    for shuffle in (False, True):
        got = list(DataPipeline(ds, 2, shuffle=shuffle, seed=3,
                                num_workers=workers))
        want = list(JaxDataPipeline(jds, 2, shuffle=shuffle, seed=3))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert isinstance(a["imgs"], torch.Tensor)
            assert a["imgs"].dtype == torch.uint8
            _assert_samples_equal(a, b)
    loader = DataPipeline(ds, 2, drop_last=True, num_workers=workers)
    assert len(loader) == len(list(loader)) == 2


def _jpeg(rng, h, w, quality=92):
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_native_decode_bit_equal_pil(tmp_path, rng, monkeypatch):
    """The port builds its own library from native/jpeg_loader.cpp; its
    decode + resize equals PIL's (and the JAX package's loader) bit for
    bit, and the dataset gives the same samples with it and without."""
    if not tnative.available():
        pytest.skip(f"native decoder not built: {tnative.build_error}")
    assert tnative.decoder() == "native"
    lib_dir = tnative.BUILD_ROOT
    assert any(lib_dir.rglob("libdiffmvs_io.so"))
    data = _jpeg(rng, 300, 400)
    assert tnative.jpeg_dims(data) == (400, 300)
    sizes = ((400, 300), (400, 288), (200, 152), (416, 320))
    for size in sizes:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")
                          .resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(tnative.decode_resize(data, size),
                                      want)
        if jnative.available():
            np.testing.assert_array_equal(jnative.decode_resize(data, size),
                                          want)
    outs = tnative.decode_resize_batch([data] * len(sizes), sizes)
    for o, size in zip(outs, sizes):
        np.testing.assert_array_equal(o, tnative.decode_resize(data, size))

    _make_scene(tmp_path, "cams", hw=(75, 101))
    ds = MVSDataset(str(tmp_path), n_views=3, numdepth=8, dataset="general")
    native = ds[1]
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    assert tnative.decoder() == "pil"
    _assert_samples_equal(ds[1], native)
