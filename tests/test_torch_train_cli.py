"""PyTorch port: the training entry point (cli/train.py) on the CPU.

The configuration from a command line equals the JAX CLI's field for
field; main trains an epoch on a synthetic BlendedMVS scene through the
data layer, checkpoints, resumes with the step count and the learning-rate
schedule, and evaluates; --loadckpt's two paths (strict .ckpt, weights-only
logdir) report what they could not load.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffmvs_tpu.cli import train as jtrain

from diffmvs_tpu_torch.cli import train
from diffmvs_tpu_torch.data.io import save_pfm
from diffmvs_tpu_torch.train import checkpoint
from diffmvs_tpu_torch.train.schedules import make_lr_lambda


def _make_blend_scene(root, scan, n_views=4, h=64, w=96):
    """The synthetic BlendedMVS scene of tests/test_train_loop.py."""
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
        with open(root / scan / "cams" / f"{i:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(str(e[r, c]) for c in range(4)) + "\n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(str(k[r, c]) for c in range(3)) + "\n")
            f.write("\n4.0 0.05 128 10.0\n")
        save_pfm(str(root / scan / "rendered_depth_maps" / f"{i:08d}.pfm"),
                 np.full((h, w), 6.0, np.float32))
    with open(root / scan / "cams" / "pair.txt", "w") as f:
        f.write(f"{n_views}\n")
        for i in range(n_views):
            others = [j for j in range(n_views) if j != i]
            f.write(f"{i}\n{len(others)} " + " ".join(
                f"{j} {10.0 - j}" for j in others) + "\n")


ARGVS = {
    "casdiffmvs": ["--preset", "casdiffmvs"],
    "diffmvs_overrides": [
        "--preset", "diffmvs", "--numdepth_initial", "16", "--numdepth",
        "64", "--scale", "0", "0.25", "0", "--timesteps", "500", "500", "500",
        "--sampling_timesteps", "1", "2", "1", "--ddim_eta", "0", "0.5", "0",
        "--hidden_dim", "0", "24", "0", "--context_dim", "16", "24", "0",
        "--stage_iters", "1", "2", "0", "--cost_dim_stage", "4", "8", "0",
        "--CostNum", "0", "4", "0", "--unet_dim", "0", "8", "8",
        "--min_radius", "0.5", "--max_radius", "2", "--lr", "5e-4",
        "--lr_sche", "mslr", "--lrepochs", "2,4:3", "--wd", "0.01",
        "--batch_size", "6", "--accum_steps", "2", "--epochs", "3",
        "--train_epochs", "2", "--seed", "7", "--trainviews", "4",
        "--testviews", "3", "--summary_freq", "5", "--save_freq", "2",
        "--eval_freq", "3", "--conf_weight", "0.1", "--dataset", "blend",
        "--dp", "1"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_train_config_from_args_equals_jax(name):
    """Every TrainConfig field, dp and sp included, and every ModelConfig
    field the port has, from the same command line."""
    got = train.train_config_from_args(
        train.build_argparser().parse_args(ARGVS[name]))
    want = jtrain.train_config_from_args(
        jtrain.build_argparser().parse_args(ARGVS[name]))
    for f in dataclasses.fields(got):
        if f.name != "model":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(got.model):
        assert getattr(got.model, f.name) == getattr(want.model, f.name), \
            f.name


@pytest.fixture
def scene(tmp_path):
    _make_blend_scene(tmp_path, "synth")
    (tmp_path / "list.txt").write_text("synth\n")
    return tmp_path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A scene and its log after one epoch: (root, epoch 0's .ckpt)."""
    root = tmp_path_factory.mktemp("trained")
    _make_blend_scene(root, "synth")
    (root / "list.txt").write_text("synth\n")
    train.main(_argv(root, "--train_epochs", "1"))
    return root, checkpoint.checkpoint_path(str(root / "log"), 0)


def _argv(root, *extra):
    return ["--dataset", "blend", "--trainpath", str(root),
            "--trainlist", str(root / "list.txt"),
            "--testlist", str(root / "list.txt"), "--trainviews", "3",
            "--testviews", "3", "--numdepth_initial", "8", "--numdepth",
            "32", "--batch_size", "2", "--epochs", "2", "--summary_freq",
            "1", "--logdir", str(root / "log"), "--device", "cpu", *extra]


def test_main_trains_resumes_and_evaluates(scene):
    """One epoch (2 steps of B = 2) and its validation; --resume runs the
    second from step 2 with the schedule's rate there; --mode test logs
    the validation means."""
    res = train.main(_argv(scene, "--train_epochs", "1"))
    assert (res["state"].step, res["state"].epoch) == (2, 1)
    assert checkpoint.latest_epoch(str(scene / "log")) == 0

    res = train.main(_argv(scene, "--resume"))
    assert (res["state"].step, res["state"].epoch) == (4, 2)
    assert checkpoint.latest_epoch(str(scene / "log")) == 1

    res = train.main(_argv(scene, "--mode", "test", "--loadckpt",
                           str(scene / "log")))
    recs = [json.loads(line) for line in open(scene / "log" /
                                               "scalars.jsonl")]
    steps = [r["step"] for r in recs if r["mode"] == "train"]
    assert steps == [0, 1, 2, 3]
    assert [r["step"] for r in recs if r["mode"] == "full_test"] == [2, 4]
    assert recs[-1]["mode"] == "eval"
    assert recs[-1]["loss"] == pytest.approx(res["eval"]["loss"])
    assert all(np.isfinite(r["loss"]) for r in recs)

    lam = make_lr_lambda(train.train_config_from_args(
        train.build_argparser().parse_args(_argv(scene))), 2)
    for r in recs:
        if r["mode"] == "train":
            assert r["lr"] == pytest.approx(1e-3 * lam(r["step"]),
                                            rel=1e-12), r["step"]
    assert res["state"].model.training is False   # run_eval's eval mode


def test_loadckpt_ckpt_is_strict(trained, tmp_path):
    """A .ckpt file loads strictly: a port checkpoint and a reference
    state_dict load; an unexpected key raises, naming it."""
    scene, path = trained
    res = train.main(_argv(scene, "--mode", "test", "--loadckpt", path))
    saved = torch.load(path, weights_only=True)["model"]
    for k, v in res["state"].model.state_dict().items():
        assert torch.equal(v, saved[k]), k

    # the reference's extras: ModuleList aliases and schedule buffers
    ref = dict(saved)
    for k, v in saved.items():
        if k.startswith("update_block_depth2."):
            ref["update_block.0." + k[len("update_block_depth2."):]] = v
    ref["update_block_depth3.betas"] = torch.zeros(1000)
    torch.save({"model": ref, "epoch": 15}, tmp_path / "reference.ckpt")
    res = train.main(_argv(scene, "--mode", "test", "--loadckpt",
                           str(tmp_path / "reference.ckpt")))
    for k, v in res["state"].model.state_dict().items():
        assert torch.equal(v, saved[k]), k

    bad = dict(saved, **{"feature.extra.weight": torch.zeros(1)})
    torch.save({"model": bad}, tmp_path / "bad.ckpt")
    with pytest.raises(RuntimeError, match="feature.extra.weight"):
        train.main(_argv(scene, "--mode", "test", "--loadckpt",
                         str(tmp_path / "bad.ckpt")))


def test_loadckpt_logdir_reports_dropped_keys(trained, tmp_path, capsys):
    """A logdir loads weights-only (strict=False) and prints the missing
    and unexpected keys."""
    scene, path = trained
    ckpt = torch.load(path, weights_only=True)
    ckpt["model"].pop("context.output1.bias")
    ckpt["model"]["context.renamed.bias"] = torch.zeros(1)
    logdir = tmp_path / "other"
    logdir.mkdir()
    torch.save(ckpt, checkpoint.checkpoint_path(str(logdir), 3))
    capsys.readouterr()
    train.main(_argv(scene, "--mode", "test", "--loadckpt", str(logdir)))
    out = capsys.readouterr().out
    assert "1 missing key(s): context.output1.bias" in out
    assert "1 unexpected key(s): context.renamed.bias" in out


def test_main_refuses_what_it_cannot_run(scene, monkeypatch):
    """--sp > 1 and a --dp other than the world size raise; so does the
    default device without a card (no fall-back to the CPU)."""
    with pytest.raises(ValueError, match="width sharding"):
        train.main(_argv(scene, "--sp", "2"))
    with pytest.raises(ValueError, match="torchrun"):
        train.main(_argv(scene, "--dp", "2"))
    argv = [a for a in _argv(scene) if a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv)
    assert not (scene / "log").exists()
