"""PyTorch port: the training path against the JAX package.

Same numpy inputs through the JAX function and its port counterpart on
the CPU (the port's plain paths). Tolerances, with their reasons:
  * loss, metrics, q_sample: rtol 1e-5 (the same float32 ops);
  * learning-rate schedules: rtol 1e-6 (both evaluate the rate in
    float32; LambdaLR's factor and product round in float64);
  * clip + AdamW: rtol 1e-5 (torch's AdamW divides by the bias
    corrections in another order than optax, and clip_grad_norm_ adds
    1e-6 to the norm);
  * warp + correlation gradients: rtol 1e-4 / atol 1e-5, as the forward
    (tests/test_torch_ops.py);
  * the whole training step: the JAX package's own gradient-parity
    tolerances (tests/test_gradients.py): loss rtol 2e-4, global gradient
    cosine > 0.9999, per-leaf cosine > 0.999;
  * BatchNorm running statistics: rtol 1e-4 / atol 1e-6 (batch moments of
    activations that went through the whole feature stack). torch updates
    running_var with the unbiased batch variance, as the reference does;
    flax uses the biased one, so the JAX side is rescaled by n/(n-1).
"""

import copy
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from diffmvs_tpu.config import CASDIFFMVS, DIFFMVS
from diffmvs_tpu.config import TrainConfig as JaxTrainConfig
from diffmvs_tpu.models import loss as jloss
from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
from diffmvs_tpu.models.schedule import DiffusionSchedule as JaxSchedule
from diffmvs_tpu.ops import correlation as jcorr
from diffmvs_tpu.train import schedules as jschedules
from diffmvs_tpu.train.state import make_optimizer as jax_make_optimizer
from diffmvs_tpu.utils import metrics as jmetrics

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch.models import loss as tloss
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.models.schedule import DiffusionSchedule
from diffmvs_tpu_torch.ops import correlation, warp_corr
from diffmvs_tpu_torch.tools.jax_import import state_dict_from_jax
from diffmvs_tpu_torch.train import checkpoint, schedules
from diffmvs_tpu_torch.train.loop import run_eval, run_training
from diffmvs_tpu_torch.train.state import (TrainState, create_train_state,
                                           make_optimizer)
from diffmvs_tpu_torch.train.step import (batch_to_device,
                                          compute_gradients, train_step)
from diffmvs_tpu_torch.utils import metrics as tmetrics
from diffmvs_tpu_torch.utils import profiling, summaries
from diffmvs_tpu_torch.utils.synthetic import (synthetic_train_batch,
                                               synthetic_train_overrides)

from helpers import make_batch
from test_torch_ops import _corr_case

T = torch.from_numpy
SMALL = dict(numdepth_initial=8, numdepth=32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cosine(a, b):
    return float(np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b),
                                    1e-30))


def _small_train_cfg(**kw):
    return tconfig.TrainConfig(
        model=dataclasses.replace(tconfig.CASDIFFMVS, **SMALL), **kw)


# ---------------------------------------------------------------------------
# configuration, schedule, loss, metrics
# ---------------------------------------------------------------------------

def test_train_config_matches_jax():
    """Every TrainConfig field of the JAX package, the device mesh (dp/sp)
    included, with the same defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)
          if f.name != "model"}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.TrainConfig)
          if f.name != "model"}
    assert tf == jf


def test_q_sample_matches_jax(rng):
    kw = dict(timesteps=1000, sampling_timesteps=1, eta=1.0, scale=0.5)
    x0 = rng.randn(3, 5, 7).astype(np.float32)
    noise = rng.randn(3, 5, 7).astype(np.float32)
    t = np.array([0, 517, 999], np.int64)
    want = JaxSchedule(**kw).q_sample(x0, t.astype(np.int32), noise)
    got = DiffusionSchedule(**kw).q_sample(T(x0), T(t), T(noise))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("preset", ["diffmvs", "casdiffmvs"])
def test_inverse_loss_matches_jax(rng, preset):
    """Both list layouts, invalid GT (0) and partial masks, the
    confidence-weighted terms."""
    iters = (DIFFMVS if preset == "diffmvs" else CASDIFFMVS).stage_iters
    stage_id, conf_flag = jloss.loss_layout(iters)
    assert tloss.loss_layout(iters) == (stage_id, conf_flag)
    b, hw = 2, {1: (8, 12), 2: (16, 24), 3: (32, 48), 4: (64, 96)}
    depth_gt, mask = {}, {}
    for s, (h, w) in hw.items():
        gt = rng.uniform(4.0, 10.0, (b, h, w)).astype(np.float32)
        gt[:, :2, :3] = 0.0
        depth_gt[f"stage{s}"] = gt
        mask[f"stage{s}"] = (rng.rand(b, h, w) > 0.25).astype(np.float32)
    depths = [rng.uniform(3.0, 11.0, (b,) + hw[s]).astype(np.float32)
              for s in stage_id]
    confs = [rng.uniform(0.0, 1.0, (b,) + hw[s]).astype(np.float32)
             for s, c in zip(stage_id, conf_flag) if c]
    confs[0][0, 0, 0] = 1.0                       # the 1e-6 clamp
    dv = np.broadcast_to(np.linspace(0.1, 0.25, 32, dtype=np.float32),
                         (b, 32)).copy()
    want, want_d = jloss.compute_inverse_loss(
        depths, confs, depth_gt, mask, dv, iters, 0.9, 0.05)
    got, got_d = tloss.compute_inverse_loss(
        [T(d) for d in depths], [T(c) for c in confs],
        {k: T(v) for k, v in depth_gt.items()},
        {k: T(v) for k, v in mask.items()}, T(dv), iters, 0.9, 0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert sorted(got_d) == sorted(want_d)
    for k in want_d:
        np.testing.assert_allclose(float(got_d[k]), float(want_d[k]),
                                   rtol=1e-5, err_msg=k)


def test_metrics_match_jax(rng):
    est = rng.uniform(4.0, 10.0, (2, 16, 24)).astype(np.float32)
    gt = rng.uniform(4.0, 10.0, (2, 16, 24)).astype(np.float32)
    mask = rng.rand(2, 16, 24) > 0.3
    mask[1] = False                               # an image with no pixel
    np.testing.assert_allclose(
        float(tmetrics.abs_depth_error(T(est), T(gt), T(mask))),
        float(jmetrics.abs_depth_error(est, gt, mask)), rtol=1e-5)
    for thres in (1.0, 2.5):
        np.testing.assert_allclose(
            float(tmetrics.threshold_error(T(est), T(gt), T(mask), thres)),
            float(jmetrics.threshold_error(est, gt, mask, thres)), rtol=1e-5)
    tm, jm = tmetrics.DictAverageMeter(), jmetrics.DictAverageMeter()
    for i in range(3):
        rec = {"loss": 0.5 * i, "err": torch.tensor(float(i * i))}
        tm.update(rec)
        jm.update({k: float(v) for k, v in rec.items()})
    assert tm.mean() == jm.mean()
    assert tmetrics.DictAverageMeter().mean() == {}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sche", ["onecycle", "mslr"])
def test_lr_schedule_matches_optax(sche):
    """200 steps: onecycle's warm-up, anneal and end; mslr's milestones.
    The port's LambdaLR sets the same rates on a torch optimizer."""
    cfg = tconfig.TrainConfig(lr=2e-3, lr_sche=sche, lrepochs="2,4,6:2",
                              epochs=1)
    steps_per_epoch = 25 if sche == "mslr" else 80
    want = jschedules.make_lr_schedule(cfg, steps_per_epoch)
    got = schedules.make_lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=cfg.lr)
    lam = torch.optim.lr_scheduler.LambdaLR(
        opt, schedules.make_lr_lambda(cfg, steps_per_epoch))
    for step in range(200):
        w = float(want(step))
        np.testing.assert_allclose(got(step), w, rtol=1e-6, err_msg=step)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], w, rtol=1e-6,
                                   err_msg=step)
        opt.step()
        lam.step()


def test_clip_adamw_matches_optax(rng):
    """Global-norm clip at 2.0, then AdamW, three steps on given gradients
    (two above the clip norm, one below), against make_optimizer's optax
    chain."""
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.05, 1.0)]
    lr, wd = 1e-2, 1e-3

    tx = jax_make_optimizer(optax.constant_schedule(lr), wd, 2.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(T(v.copy())) for k, v in params.items()})
    optimizer = make_optimizer(model.parameters(), lr, wd)
    state = TrainState(model, optimizer, torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 1.0))
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in model.items():
            p.grad = T(g[k].copy())
        norm = state.apply_gradients(2.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(_np(model[k]), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert state.step == 3


# ---------------------------------------------------------------------------
# warp + correlation gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["refine", "sweep"])
def test_warp_correlate_gradients_match_jax(rng, case):
    """d_src and d_ref of the plain path (autograd: the oracle of the
    backward kernel) against jax.vjp of the XLA warp_and_correlate; the
    projections and the depths get no gradient on either side."""
    src, ref, sp, rp, depths, _ = _corr_case(rng, case)
    g = rng.randn(*np.shape(jax.eval_shape(
        lambda *a: jcorr.warp_and_correlate(*a, 4),
        src, ref, sp, rp, depths))).astype(np.float32)
    # jitted, as the forward parity test: XLA then fuses the coordinates'
    # last multiply-add, as the port does
    want = jax.jit(lambda *a: jax.vjp(
        lambda *x: jcorr.warp_and_correlate(*x, 4).astype(jnp.float32),
        *a)[1](jnp.asarray(g)))(src, ref, sp, rp, depths)

    args = [T(a.copy()).requires_grad_() for a in (src, ref, sp, rp, depths)]
    out = correlation.warp_and_correlate(*args, 4)
    got = torch.autograd.grad(out, args, T(g), allow_unused=True)
    for k, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(k), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert got[2:] == (None, None, None)
    for w in want[2:]:
        assert float(jnp.abs(w).max()) == 0.0


def test_backward_kernel_wrapper_refuses_cpu_tensors(rng):
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine")
    rt = warp_corr.projection_scalars(T(sp), T(rp))
    g = torch.zeros((1, 4) + depths.shape[1:])
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr.warp_corr_backward(T(src), T(ref), rt, T(depths), g, 4)
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr.warp_corr(T(src).requires_grad_(), T(ref), T(sp), T(rp),
                            T(depths), 4)
    assert profiling.counter("warp_corr.k2") == 0


# ---------------------------------------------------------------------------
# the training step against JAX
# ---------------------------------------------------------------------------

def train_parity_case(preset, **overrides):
    """One training-branch forward + backward on each side: B=2, 3 views,
    64x96, 8/32 hypotheses, invalid-GT pixels and partial masks, the same
    injected timesteps and noise, the JAX weights carried into the port.
    preset: "casdiffmvs" or "diffmvs"; overrides: ModelConfig fields set
    on both sides (e.g. compute_dtype, remat).

    Returns (JAX loss, JAX grads as a port state_dict, JAX batch_stats as
    a port state_dict, port loss, port model after the step, BatchNorm
    calls and elements per channel by module name)."""
    jax_presets = {"casdiffmvs": CASDIFFMVS, "diffmvs": DIFFMVS}
    cfg_j = dataclasses.replace(jax_presets[preset], **SMALL, **overrides)
    cfg_t = dataclasses.replace(tconfig.MODEL_PRESETS[preset], **SMALL,
                                **overrides)
    b, v, h, w = 2, 3, 64, 96
    rng = np.random.RandomState(0)
    batch = make_batch(rng, b, v, h, w, numdepth=32, with_gt=True)
    for s, arr in batch["depth"].items():
        arr[:, :2, :3] = 0.0
        batch["mask"][s] = (rng.rand(*arr.shape) > 0.25).astype(np.float32)
    overrides = synthetic_train_overrides(cfg_t, b, h, w, seed=3)

    model = JaxCasDiffMVS(cfg_j)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), batch["imgs"], batch["proj_matrices"],
        batch["depth_values"], rng=None, train=False, export=True))

    @jax.jit
    def loss_and_grads(params):
        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                batch["imgs"], batch["proj_matrices"],
                batch["depth_values"], depth_gt=batch["depth"], rng=None,
                train=True, mutable=["batch_stats"],
                train_overrides={s: (jnp.asarray(t), jnp.asarray(n))
                                 for s, (t, n) in overrides.items()})
            loss, _ = jloss.compute_inverse_loss(
                out["depth"], out["conf"], batch["depth"], batch["mask"],
                batch["depth_values"], cfg_j.stage_iters, 0.9, 0.05)
            return loss, mutated["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss_j, stats_j), grads_j = jax.device_get(
        loss_and_grads(variables["params"]))
    grads_sd = state_dict_from_jax(
        {"params": grads_j, "batch_stats": stats_j}, cfg_t)
    stats_sd = state_dict_from_jax(
        {"params": variables["params"], "batch_stats": stats_j}, cfg_t)

    port = CasDiffMVS(cfg_t)
    port.load_state_dict(state_dict_from_jax(variables, cfg_t), strict=True)
    bn_calls = {}

    def hook(name):
        def fn(mod, inputs):
            x = inputs[0]
            calls, _ = bn_calls.get(name, (0, 0))
            bn_calls[name] = (calls + 1, x.numel() // x.shape[1])
        return fn

    for name, mod in port.named_modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            mod.register_forward_pre_hook(hook(name))
    loss_t, _, _, _ = compute_gradients(
        port, tconfig.TrainConfig(model=cfg_t, batch_size=b),
        batch_to_device(batch, "cpu"), train_overrides=overrides)
    return float(loss_j), grads_sd, stats_sd, float(loss_t), port, bn_calls


@pytest.fixture(scope="module", params=["casdiffmvs", "diffmvs"])
def train_parity(request):
    """train_parity_case of each variant, float32."""
    return train_parity_case(request.param)


def test_train_step_gradients_match_jax(train_parity):
    """Loss and every parameter gradient of the training branch, with the
    stop-gradient seams (per-iteration detach, detached GT residual and
    initial depth, frozen view weights, stop-gradient coordinates)."""
    loss_j, grads_sd, _, loss_t, port, _ = train_parity
    np.testing.assert_allclose(loss_t, loss_j, rtol=2e-4)
    ours = {k: _np(p.grad).ravel() for k, p in port.named_parameters()}
    ref = {k: np.asarray(grads_sd[k]).ravel() for k in ours}
    keys = sorted(ours)
    global_cos = _cosine(np.concatenate([ours[k] for k in keys]),
                         np.concatenate([ref[k] for k in keys]))
    assert global_cos > 0.9999, global_cos
    scale = max(float(np.abs(r).max()) for r in ref.values())
    for k in keys:
        a, r = ours[k], ref[k]
        nr = np.linalg.norm(r)
        if nr < 1e-7 * scale:        # numerically dead leaf: no cosine
            assert np.linalg.norm(a) < 1e-5 * scale + 1e-12, k
            continue
        assert _cosine(a, r) > 0.999, (k, _cosine(a, r))
        assert abs(np.linalg.norm(a) - nr) < 0.02 * nr + 1e-5 * scale, k


def test_batchnorm_statistics_match_jax(train_parity):
    """Running statistics after the step: the means as JAX's; the
    variances as JAX's with each batch variance rescaled by n/(n-1) (n =
    elements per channel), since torch keeps the unbiased one."""
    _, _, stats_sd, _, port, bn_calls = train_parity
    assert bn_calls, "no BatchNorm ran"
    for name, (calls, n) in sorted(bn_calls.items()):
        mod = port.get_submodule(name)
        assert mod.momentum == 0.1 and mod.eps == 1e-5
        decay = 0.9 ** calls               # initial stats: mean 0, var 1
        np.testing.assert_allclose(
            _np(mod.running_mean), _np(stats_sd[f"{name}.running_mean"]),
            rtol=1e-4, atol=1e-6, err_msg=name)
        var_j = _np(stats_sd[f"{name}.running_var"])
        want = decay + (var_j - decay) * n / (n - 1)
        np.testing.assert_allclose(_np(mod.running_var), want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        assert int(mod.num_batches_tracked) == calls


# ---------------------------------------------------------------------------
# the port's training pieces
# ---------------------------------------------------------------------------

def test_train_branch_draws_from_generator_or_overrides():
    cfg = _small_train_cfg(batch_size=1)
    batch = batch_to_device(synthetic_train_batch(1, 3, 32, 64, 32), "cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = CasDiffMVS(cfg.model).train()
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    with torch.no_grad():
        with pytest.raises(ValueError, match="generator"):
            model(*args, depth_gt=batch["depth"], train=True)
        outs = [model(*args, depth_gt=batch["depth"], train=True,
                      generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
    assert len(outs[0]["depth"]) == 10 and len(outs[0]["conf"]) == 6
    assert torch.equal(outs[0]["depth"][-1], outs[1]["depth"][-1])
    assert not torch.equal(outs[0]["depth"][-1], outs[2]["depth"][-1])


def test_accum_steps_two_averages_microbatch_gradients():
    """accum_steps=2 == the mean of the two half batches' gradients, with
    BatchNorm statistics updated per microbatch in order."""
    cfg1 = _small_train_cfg(batch_size=1)
    cfg2 = dataclasses.replace(cfg1, batch_size=2, accum_steps=2)
    batch = batch_to_device(synthetic_train_batch(2, 3, 32, 64, 32, seed=4),
                            "cpu")
    ov = synthetic_train_overrides(cfg1.model, 2, 32, 64, seed=5)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = CasDiffMVS(cfg1.model)
    twin = copy.deepcopy(model)

    loss2, _, _, _ = compute_gradients(model, cfg2, batch,
                                       train_overrides=ov)
    halves = []
    for i in range(2):
        half = {k: ({s: x[i:i + 1] for s, x in v.items()}
                    if isinstance(v, dict) else v[i:i + 1])
                for k, v in batch.items()}
        ov_i = {s: (t[i:i + 1], n[i:i + 1]) for s, (t, n) in ov.items()}
        loss_i, _, _, _ = compute_gradients(twin, cfg1, half,
                                            train_overrides=ov_i)
        halves.append((float(loss_i),
                       {k: p.grad.clone() for k, p in
                        twin.named_parameters()}))
    np.testing.assert_allclose(float(loss2),
                               0.5 * (halves[0][0] + halves[1][0]),
                               rtol=1e-6)
    for k, p in model.named_parameters():
        torch.testing.assert_close(
            p.grad, 0.5 * (halves[0][1][k] + halves[1][1][k]),
            rtol=1e-5, atol=1e-8, msg=k)
    for (k, a), b in zip(model.named_buffers(), twin.buffers()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)


def test_run_training_checkpoint_resume_and_eval(tmp_path):
    """run_training writes scalars, images and one checkpoint per epoch
    in the reference's format; restore_checkpoint resumes at the next
    epoch with the optimizer and the schedule; run_eval logs its means;
    load_weights_only carries the weights alone."""
    cfg = _small_train_cfg(batch_size=1, epochs=2, train_epochs=1,
                           summary_freq=1)
    train = [synthetic_train_batch(1, 3, 32, 64, 32, seed=i)
             for i in range(2)]
    logdir = str(tmp_path)
    state = create_train_state(cfg, steps_per_epoch=2, device="cpu", seed=0)
    run_training(state, cfg, train, train[:1], logdir)
    assert (state.epoch, state.step) == (1, 2)
    assert checkpoint.latest_epoch(logdir) == 0
    ckpt = torch.load(checkpoint.checkpoint_path(logdir, 0),
                      weights_only=True)
    assert sorted(ckpt) == ["epoch", "model", "optimizer"]
    assert ckpt["epoch"] == 0
    assert any(n.startswith("train_depth_est_")
               for n in os.listdir(tmp_path / "images"))

    resumed = create_train_state(cfg, steps_per_epoch=2, device="cpu",
                                 seed=9)
    resumed, epoch = checkpoint.restore_checkpoint(logdir, resumed)
    assert epoch == 0 and (resumed.epoch, resumed.step) == (1, 2)
    assert resumed.optimizer.param_groups[0]["lr"] == \
        state.optimizer.param_groups[0]["lr"]
    for (k, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k

    full = dataclasses.replace(cfg, train_epochs=-1)
    run_training(resumed, full, train, train[:1], logdir)
    assert checkpoint.latest_epoch(logdir) == 1 and resumed.step == 4
    means = run_eval(resumed, full, train[:1], logdir)
    recs = [json.loads(line) for line in open(tmp_path / "scalars.jsonl")]
    assert [r["step"] for r in recs if r["mode"] == "train"] == [0, 1, 2, 3]
    assert [r["step"] for r in recs if r["mode"] == "full_test"] == [2, 4]
    assert recs[-1]["mode"] == "eval"
    assert recs[-1]["loss"] == pytest.approx(means["loss"])
    assert all(np.isfinite(r["loss"]) for r in recs)

    fresh = create_train_state(cfg, steps_per_epoch=2, device="cpu", seed=9)
    checkpoint.load_weights_only(logdir, fresh)
    for (k, a), b in zip(resumed.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert not fresh.optimizer.state


def test_train_step_runs_on_the_state_device_and_needs_cuda(monkeypatch):
    cfg = _small_train_cfg(batch_size=1)
    state = create_train_state(cfg, steps_per_epoch=1, device="cpu")
    scalars, images = train_step(
        state, cfg, synthetic_train_batch(1, 3, 32, 64, 32),
        generator=torch.Generator().manual_seed(0))
    assert state.step == 1
    assert all(torch.isfinite(v) for v in scalars.values())
    assert images["depth_est"].shape == (1, 32, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, steps_per_epoch=1)


def test_save_images_writes_readable_pngs(tmp_path, rng):
    from PIL import Image
    grey = rng.rand(2, 5, 7).astype(np.float32)
    rgb = rng.rand(1, 4, 6, 3).astype(np.float32)
    summaries.save_images(str(tmp_path), "train",
                          {"grey": T(grey), "rgb": rgb}, 3)
    got = np.asarray(Image.open(tmp_path / "images" /
                                "train_grey_00000003.png"))
    np.testing.assert_array_equal(got, summaries._normalize(grey[0]))
    got = np.asarray(Image.open(tmp_path / "images" /
                                "train_rgb_00000003.png"))
    np.testing.assert_array_equal(got, summaries._normalize(rgb[0]))


def test_synthetic_train_batch_shapes():
    batch = synthetic_train_batch(2, 3, 64, 96, 32, seed=1)
    for i, s in enumerate((8, 4, 2, 1)):
        assert batch["depth"][f"stage{i + 1}"].shape == (2, 64 // s, 96 // s)
        assert batch["mask"][f"stage{i + 1}"].min() == 1.0
    assert batch["imgs"].shape == (2, 3, 64, 96, 3)
    ov = synthetic_train_overrides(tconfig.CASDIFFMVS, 2, 64, 96)
    assert sorted(ov) == [1, 2]
    assert ov[1][1].shape == (2, 16, 24) and ov[2][1].shape == (2, 32, 48)
    assert ov[1][0].dtype == np.int64 and ov[1][0].max() < 1000
