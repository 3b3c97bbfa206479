"""PyTorch port: the retrieval ViT, the COLMAP converter and the profiling
hooks against the JAX package's.

Tolerances: the ViT's descriptors 1e-5 (the same float32 matmuls,
convolution and softmax in another order); the converter's cams/ and
triangulation-mode pair.txt byte for byte (the same numpy code); VGGT-mode
pair scores 1e-4, one unit of the 4 printed decimals, with the same view
order (the descriptors differ by float32 rounding).
"""

import os
import struct

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from diffmvs_tpu.tools import colmap as jcolmap
from diffmvs_tpu.tools.retrieval import DistilledViT as JaxViT
from diffmvs_tpu.tools.retrieval import ViTConfig as JaxViTConfig
from diffmvs_tpu.tools.retrieval import import_timm_state_dict

from diffmvs_tpu_torch.tools import colmap
from diffmvs_tpu_torch.tools.retrieval import (DistilledViT, ViTConfig,
                                               compute_descriptors)
from diffmvs_tpu_torch.utils import profiling

SMALL_VIT = dict(image_size=32, patch_size=16, embed_dim=64, depth=2,
                 num_heads=4, num_classes=16)
TINY_VIT = dict(image_size=32, patch_size=16, embed_dim=32, depth=1,
                num_heads=2, num_classes=16)


def _write_sparse(root, n_views=3, n_points=50):
    """The text sparse model of tests/test_colmap.py."""
    os.makedirs(root / "sparse", exist_ok=True)
    os.makedirs(root / "images", exist_ok=True)

    with open(root / "sparse" / "cameras.txt", "w") as f:
        f.write("# cameras\n")
        for i in range(1, n_views + 1):
            f.write(f"{i} PINHOLE 64 48 70.0 70.0 32.0 24.0\n")

    rng = np.random.RandomState(0)
    pts = rng.rand(n_points, 3) * 2 - 1
    pts[:, 2] += 6.0

    with open(root / "sparse" / "images.txt", "w") as f:
        f.write("# images\n")
        for i in range(1, n_views + 1):
            tx = 0.3 * (i - 1)
            f.write(f"{i} 1 0 0 0 {tx} 0 0 {i} view{i}.png\n")
            obs = []
            for pid in range(n_points):
                x = 70 * (pts[pid, 0] - tx) / pts[pid, 2] + 32
                y = 70 * pts[pid, 1] / pts[pid, 2] + 24
                obs.append(f"{x:.2f} {y:.2f} {pid + 1}")
            f.write(" ".join(obs) + "\n")
            img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(root / "images" / f"view{i}.png")

    with open(root / "sparse" / "points3D.txt", "w") as f:
        f.write("# points\n")
        for pid in range(n_points):
            track = " ".join(f"{i} {pid}" for i in range(1, n_views + 1))
            f.write(f"{pid + 1} {pts[pid, 0]:.4f} {pts[pid, 1]:.4f} "
                    f"{pts[pid, 2]:.4f} 128 128 128 0.5 {track}\n")


def _write_binary(model, out):
    """The COLMAP binary format of a (cameras, images, points) model."""
    cameras, images, points = model
    os.makedirs(out, exist_ok=True)
    ids = {m.model_name: m.model_id for m in colmap.CAMERA_MODELS}
    with open(out / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            f.write(struct.pack("<iiQQ", c.id, ids[c.model], c.width,
                                c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
    with open(out / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))
    with open(out / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *p.rgb, p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for i, j in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", i, j))


def _read_tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _read_pairs(path):
    with open(path) as f:
        n = int(f.readline())
        out = {}
        for _ in range(n):
            ref = int(f.readline())
            toks = f.readline().split()
            out[ref] = [(int(toks[1 + 2 * i]), float(toks[2 + 2 * i]))
                        for i in range(int(toks[0]))]
    return out


# ---------------------------------------------------------------------------
# the retrieval ViT
# ---------------------------------------------------------------------------

def test_vit_descriptors_match_jax(rng):
    """The port's random weights through JAX's timm importer: the same
    descriptors, unit norm, and timm's key names."""
    torch.manual_seed(0)
    model = DistilledViT(ViTConfig(**SMALL_VIT)).eval()
    sd = model.state_dict()
    assert {"patch_embed.proj.weight", "cls_token", "dist_token",
            "pos_embed", "blocks.1.attn.qkv.weight", "blocks.0.mlp.fc2.bias",
            "norm.weight", "head.weight", "head_dist.bias"} <= set(sd)
    x = rng.rand(5, 32, 32, 3).astype(np.float32)
    got = compute_descriptors(model, x, batch=2)

    jcfg = JaxViTConfig(**SMALL_VIT)
    variables = import_timm_state_dict(sd, jcfg)
    want = np.asarray(jax.jit(lambda v, a: JaxViT(jcfg).apply(v, a))(
        variables, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def test_vit_random_init_follows_jax_initializers():
    """Zero tokens and a position embedding within two deviations (0.04),
    as the JAX module's initializers; the parameter shapes of JAX's after
    the timm import."""
    cfg = ViTConfig(**TINY_VIT)
    a, b = DistilledViT(cfg), DistilledViT(cfg)
    assert not torch.equal(a.pos_embed, b.pos_embed)
    assert float(a.cls_token.detach().abs().max()) == 0.0
    assert float(a.pos_embed.detach().abs().max()) <= 0.04
    jvars = JaxViT(JaxViTConfig(**TINY_VIT)).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    imported = import_timm_state_dict(a.state_dict(),
                                      JaxViTConfig(**TINY_VIT))
    shapes = jax.tree_util.tree_map(np.shape, imported["params"])
    assert shapes == jax.tree_util.tree_map(np.shape, jvars["params"])


# ---------------------------------------------------------------------------
# the COLMAP converter
# ---------------------------------------------------------------------------

def test_read_model_text_and_binary_match_jax(tmp_path):
    _write_sparse(tmp_path)
    text = colmap.read_model(str(tmp_path / "sparse"), ".txt")
    _write_binary(text, tmp_path / "bin")
    for ext, path in ((".txt", tmp_path / "sparse"),
                      (".bin", tmp_path / "bin")):
        got = colmap.read_model(str(path), ext)
        want = jcolmap.read_model(str(path), ext)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                for a, b in zip(g[k], w[k]):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
    np.testing.assert_array_equal(colmap.qvec2rotmat([0.5, 0.5, 0.5, 0.5]),
                                  jcolmap.qvec2rotmat([0.5, 0.5, 0.5, 0.5]))


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_convert_triangulation_is_byte_equal_to_jax(tmp_path, ext):
    _write_sparse(tmp_path)
    if ext == ".bin":
        _write_binary(colmap.read_model(str(tmp_path / "sparse"), ".txt"),
                      tmp_path / "sparse")
    colmap.convert(str(tmp_path), str(tmp_path / "port"), model_ext=ext,
                   num_src=2)
    jcolmap.convert(str(tmp_path), str(tmp_path / "jax"), model_ext=ext,
                    num_src=2)
    got, want = _read_tree(tmp_path / "port"), _read_tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert any(k.startswith("cams") for k in got) and "pair.txt" in got
    for k in want:
        assert got[k] == want[k], k


def test_convert_vggt_matches_jax_with_the_same_weights(tmp_path):
    """The port's random weights saved as an R2Former-style .pth (a
    state_dict under "state_dict", keys prefixed "module.") and given to
    both converters: the same cams/, the same view order, scores 1e-4."""
    _write_sparse(tmp_path)
    cfg = ViTConfig(**TINY_VIT)
    torch.manual_seed(3)
    sd = DistilledViT(cfg).state_dict()
    ckpt = tmp_path / "r2former.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               ckpt)
    colmap.convert(str(tmp_path), str(tmp_path / "port"), model_ext=".txt",
                   num_src=2, vggt=True, retrieval_ckpt=str(ckpt),
                   vit_cfg=cfg, device="cpu")
    jcolmap.convert(str(tmp_path), str(tmp_path / "jax"), model_ext=".txt",
                    num_src=2, vggt=True, retrieval_ckpt=str(ckpt),
                    vit_cfg=JaxViTConfig(**TINY_VIT))
    got = _read_pairs(tmp_path / "port" / "pair.txt")
    want = _read_pairs(tmp_path / "jax" / "pair.txt")
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for ref, lst in want.items():
        assert [j for j, _ in got[ref]] == [j for j, _ in lst]
        np.testing.assert_allclose([s for _, s in got[ref]],
                                   [s for _, s in lst], atol=1e-4)
    cams_p = {k: v for k, v in _read_tree(tmp_path / "port").items()
              if k.startswith("cams")}
    cams_j = {k: v for k, v in _read_tree(tmp_path / "jax").items()
              if k.startswith("cams")}
    assert cams_p == cams_j and len(cams_p) == 3


def test_cli_device_flag(tmp_path, monkeypatch):
    """main's --device cpu runs --vggt on the CPU; without a card the
    default raises before any file is written."""
    _write_sparse(tmp_path)
    orig = colmap.compute_image_descriptors
    monkeypatch.setattr(
        colmap, "compute_image_descriptors",
        lambda folder, images, checkpoint=None, vit_cfg=None, device=None:
        orig(folder, images, checkpoint=checkpoint,
             vit_cfg=ViTConfig(**TINY_VIT), device=device))
    base = ["--dense_folder", str(tmp_path), "--model_ext", ".txt",
            "--num_src", "2", "--vggt"]
    colmap.main(base + ["--save_folder", str(tmp_path / "cpu"),
                        "--device", "cpu"])
    assert len(_read_pairs(tmp_path / "cpu" / "pair.txt")) == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        colmap.main(base + ["--save_folder", str(tmp_path / "gpu")])
    assert not (tmp_path / "gpu").exists()


# ---------------------------------------------------------------------------
# profiling hooks
# ---------------------------------------------------------------------------

def test_profiling_hooks_on_the_cpu(tmp_path):
    lines = []
    with profiling.wallclock("matmul", sink=lines.append) as holder:
        with profiling.trace("matmul"):
            holder["result"] = {"y": torch.ones(8, 8) @ torch.ones(8, 8)}
    assert holder["elapsed"] > 0.0
    assert lines == [f"matmul: {holder['elapsed'] * 1000:.2f} ms"]

    def fn(a):
        with profiling.trace("double"):
            return a * 2
    out = profiling.capture(str(tmp_path / "trace"), fn, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "double" in f.read()
