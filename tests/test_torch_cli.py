"""PyTorch port: the export CLI (cli/test.py) against the JAX package's.

Both packages' save_scene_depth export the 32x64 three-view scene of
tests/test_cli_e2e.py with the same reference-format .ckpt (the JAX side
loads it with tools.torch_import.load_torch_checkpoint) and zero
diffusion noise. Depth and confidence PFMs agree at rtol/atol 5e-3 (the
full-model tolerance of tests/test_torch_model.py: soft-argmax and convex
upsampling over random weights amplify ulp-level differences); cam files
and reference JPEGs are byte-identical. run_fusion of both packages over
the JAX export gives identical masks and points within rtol 1e-4.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from diffmvs_tpu.cli import test as jcli
from diffmvs_tpu.config import CASDIFFMVS
from diffmvs_tpu.data.io import read_pfm

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch.cli import test as tcli
from diffmvs_tpu_torch.fusion.ply import read_ply
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS

from test_cli_e2e import _make_scene

SMALL = dict(numdepth_initial=4, numdepth=16)
ZERO_NOISE = dict(scale=(0.0, 0.0, 0.0), **SMALL)
TOL = dict(rtol=5e-3, atol=5e-3)
FUSE_ARGS = ["--geo_mask_thres", "1", "--geo_pixel_thres", "8",
             "--geo_depth_thres", "0.5", "--photo_thres", "0", "0", "0"]


def _state_dict(seed):
    """Port weights under the reference's key names, with randomized
    BatchNorm statistics."""
    torch.manual_seed(seed)
    sd = CasDiffMVS(dataclasses.replace(tconfig.CASDIFFMVS,
                                        **SMALL)).state_dict()
    rng = np.random.RandomState(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(
                rng.normal(0, 0.3, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _make_scene(root / "scene", h=32, w=64)
    ckpt = root / "casdiffmvs.ckpt"
    torch.save({"model": _state_dict(0), "epoch": 0}, ckpt)
    return root, ckpt


def _cli_args(root, ckpt, outdir, extra=()):
    return ["--dataset", "general", "--method", "casdiffmvs",
            "--save_depth", "--testpath", str(root / "scene"),
            "--outdir", str(outdir), "--loadckpt", str(ckpt),
            "--max_h", "32", "--max_w", "64", "--workers", "0",
            "--numdepth_initial", "4", "--numdepth", "16", *FUSE_ARGS,
            *extra]


@pytest.fixture(scope="module")
def exports(scene):
    """(JAX export dir, port export dir) of the same weights and scene."""
    root, ckpt = scene
    jout, tout = root / "jax_out", root / "port_out"
    jcli.save_scene_depth(jcli.build_argparser().parse_args(
        _cli_args(root, ckpt, jout)),
        dataclasses.replace(CASDIFFMVS, **ZERO_NOISE), [""])
    stats = tcli.save_scene_depth(tcli.parse_args(
        _cli_args(root, ckpt, tout, ["--device", "cpu"])),
        dataclasses.replace(tconfig.CASDIFFMVS, **ZERO_NOISE), [""])
    assert stats["views"] == 3
    return jout, tout


def test_save_scene_depth_matches_jax(exports):
    jout, tout = exports
    for i in range(3):
        for sub in ("depth_est", "conf0", "conf1", "conf2"):
            want, _ = read_pfm(str(jout / sub / f"{i:08d}.pfm"))
            got, _ = read_pfm(str(tout / sub / f"{i:08d}.pfm"))
            assert got.shape == want.shape == (32, 64)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, **TOL, err_msg=sub)
        for sub, name in (("cams", f"{i:08d}_cam.txt"),
                          ("images", f"{i:08d}.jpg")):
            assert ((tout / sub / name).read_bytes()
                    == (jout / sub / name).read_bytes()), (sub, name)


def test_run_fusion_matches_jax(tmp_path, scene, exports):
    root, ckpt = scene
    jexport, _ = exports
    results = {}
    for tag, cli, extra in (("jax", jcli, []), ("port", tcli,
                                                ["--device", "cpu"])):
        out = tmp_path / tag
        shutil.copytree(jexport, out)
        args = cli.build_argparser().parse_args(
            _cli_args(root, ckpt, out, extra))
        cli.run_fusion(args, [""])
        xyz, rgb = read_ply(str(out / "pc.ply"))
        masks = {p: (out / "mask" / p).read_bytes()
                 for p in sorted(os.listdir(out / "mask"))}
        results[tag] = (xyz, rgb, masks)
    (xyz_j, rgb_j, masks_j), (xyz_t, rgb_t, masks_t) = (
        results["jax"], results["port"])
    assert masks_t == masks_j and len(masks_t) == 9
    assert 0 < xyz_t.shape[0] == xyz_j.shape[0]
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(rgb_t, rgb_j)


def test_main_on_cpu_from_a_training_logdir(tmp_path, scene):
    """The whole CLI on the CPU (--device cpu): export + fusion, with
    --loadckpt naming a port training logdir (its newest checkpoint)."""
    root, _ = scene
    logdir = tmp_path / "logs"
    logdir.mkdir()
    torch.save({"model": _state_dict(1), "epoch": 0},
               logdir / "model_000000.ckpt")
    newest = _state_dict(2)
    torch.save({"model": newest, "epoch": 3}, logdir / "model_000003.ckpt")
    loaded = tcli.load_state_dict(str(logdir))
    assert all(torch.equal(loaded[k], v) for k, v in newest.items())

    out = tmp_path / "out"
    res = tcli.main(_cli_args(root, logdir, out, ["--device", "cpu"]))
    assert res["export"]["views"] == 3
    assert res["points"][str(out / "pc.ply")] > 0
    for i in range(3):
        depth, _ = read_pfm(str(out / "depth_est" / f"{i:08d}.pfm"))
        assert depth.shape == (32, 64) and np.isfinite(depth).all()
    xyz, _ = read_ply(str(out / "pc.ply"))
    assert xyz.shape[0] == res["points"][str(out / "pc.ply")]


def test_loadckpt_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "model_000000").mkdir()          # the JAX package's layout
    with pytest.raises(ValueError, match="orbax"):
        tcli.load_state_dict(str(tmp_path))


def test_device_defaults_to_cuda_and_raises_without_it(tmp_path, scene,
                                                       monkeypatch):
    root, ckpt = scene
    args = _cli_args(root, ckpt, tmp_path / "out")
    assert tcli.parse_args(args).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(args)
    assert not (tmp_path / "out").exists()
    without_export = [a for a in args if a != "--save_depth"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(without_export)


def test_warp_kernel_choices_are_kept():
    parser_j, parser_t = jcli.build_argparser(), tcli.build_argparser()
    for kernel in ("auto", "xla", "pallas", "pallas_full"):
        assert tcli.parse_args(["--warp_kernel", kernel]).warp_kernel == kernel
    opts_j = {a.dest for a in parser_j._actions}
    opts_t = {a.dest for a in parser_t._actions}
    assert opts_t - opts_j == {"device"} and opts_j <= opts_t
