"""The frozen plain reference against the port at toy shapes, in float32
on the CPU: the export forward, and the training branch's loss and
gradients, from the same weights and noise."""

import dataclasses

import numpy as np
import pytest
import torch

from diffmvs_tpu_torch.config import MODEL_PRESETS
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.models.loss import compute_inverse_loss
from mvsbench.reference import model as R
from mvsbench.reference import train as RT

H, W = 64, 96


def pair(preset, seed):
    cfg = dataclasses.replace(MODEL_PRESETS[preset], numdepth_initial=8,
                              numdepth=32)
    torch.manual_seed(seed)
    port = CasDiffMVS(cfg)
    rcfg = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    sd = port.state_dict()
    for k, v in sd.items():       # eval-mode BatchNorm does some work
        if k.endswith("running_mean"):
            v.normal_(0, 0.1)
        if k.endswith("running_var"):
            v.uniform_(0.5, 1.5)
    port.load_state_dict(sd)
    ref = R.Reference(rcfg, 1e-5)
    ref.load_state_dict(sd, strict=True)
    return cfg, rcfg, port, ref


def inputs(b, seed):
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    batch = synthetic_train_batch(b, 3, H, W, 32, seed=seed)
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                {kk: torch.from_numpy(vv) for kk, vv in v.items()})
            for k, v in batch.items()}


@pytest.mark.parametrize("preset", ["casdiffmvs", "diffmvs"])
def test_export_forward(preset):
    cfg, rcfg, port, ref = pair(preset, 0)
    bt = inputs(2, 1)
    args = (bt["imgs"], bt["proj_matrices"], bt["depth_values"])
    with torch.no_grad():
        got = port.eval()(*args, generator=torch.Generator().manual_seed(5),
                          export=True)
        noise = R.draw_eval_noise(rcfg, 2, H, W,
                                  torch.Generator().manual_seed(5))
        want = ref.eval()(*args, noise)
    d, dr = got["depth"][-1], want["depth"][-1]
    assert d.shape == dr.shape == (2, H, W)
    assert ((d - dr).abs() / dr).max() < 1e-4
    assert len(got["photometric_confidence"]) == len(
        want["photometric_confidence"])
    for a, b in zip(got["photometric_confidence"],
                    want["photometric_confidence"]):
        assert a.shape == b.shape and (a - b).abs().max() < 1e-4


@pytest.mark.parametrize("preset", ["casdiffmvs", "diffmvs"])
def test_training_loss_and_gradients(preset):
    cfg, rcfg, port, ref = pair(preset, 2)
    bt = inputs(2, 3)
    out = port.train()(bt["imgs"], bt["proj_matrices"], bt["depth_values"],
                       depth_gt=bt["depth"],
                       generator=torch.Generator().manual_seed(7), train=True)
    lp, _ = compute_inverse_loss(out["depth"], out["conf"], bt["depth"],
                                 bt["mask"], bt["depth_values"],
                                 cfg.stage_iters)
    ts, noise = R.draw_train_noise(rcfg, 2, H, W,
                                   torch.Generator().manual_seed(7))
    outr = ref.train()(bt["imgs"], bt["proj_matrices"], bt["depth_values"],
                       noise, t=ts, gt=bt["depth"])
    lr = R.loss(outr, bt["depth"], bt["mask"], bt["depth_values"],
                cfg.stage_iters)
    assert abs(lp.item() - lr.item()) <= 1e-5 * abs(lr.item())
    lp.backward()
    lr.backward()
    gp = dict(port.named_parameters())
    for k, p in ref.named_parameters():
        g = p.grad
        assert (gp[k].grad - g).norm() <= 1e-4 * g.norm() + 1e-9, k


def test_optimizer_step_matches_torch():
    """The written-out AdamW and clip against torch's, at the one-cycle
    learning rate of the program's schedule."""
    from diffmvs_tpu_torch.config import TrainConfig
    from diffmvs_tpu_torch.train.schedules import make_lr_schedule

    torch.manual_seed(0)
    a = [torch.nn.Parameter(torch.randn(5, 3)), torch.nn.Parameter(
        torch.randn(4))]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    opt = torch.optim.AdamW(a, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-3)
    mine = RT.AdamW(b, 1e-3)
    sched = make_lr_schedule(TrainConfig(), 10)
    for step in range(3):
        for x, y in zip(a, b):
            x.grad = torch.randn_like(x) * 3
            y.grad = x.grad.clone()
        torch.nn.utils.clip_grad_norm_(a, 2.0)
        RT.clip_global(b, 2.0)
        lr = sched(step)
        assert RT.onecycle_lr(step, 10 * 16 + 100, 1e-3) == pytest.approx(
            lr, rel=1e-6)
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        mine.step(lr)
    for x, y in zip(a, b):
        assert torch.allclose(x, y, atol=1e-7)


def test_reference_runs_without_tf32_whatever_the_program_set(monkeypatch):
    """The check's reference switches TF32 off itself: a program that
    leaves it on does not move the yardstick."""
    from mvsbench import check
    from mvsbench.tests import toy

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    config = toy.toy_config("casdiffmvs-dtu")
    ref = check.reference(config, 5, "cpu", "float32").eval()
    seen = []

    def hook(mod, args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    for mod in ref.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d,
                            torch.nn.ConvTranspose3d)):
            mod.register_forward_pre_hook(hook)
    h, w = config["image_hw"]
    imgs, projs, dv = check.I.viewsets(config, 1, 5, "cpu")
    noise = R.draw_eval_noise(config["model"], 1, h, w,
                              torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref(imgs, projs, dv, noise)
    assert seen and set(seen) == {(False, False)}
