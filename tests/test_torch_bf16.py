"""PyTorch port: the bfloat16 compute policy and per-iteration remat.

The JAX package's policy (ModelConfig.compute_dtype = "bfloat16"): the
conv stacks compute in bfloat16 over float32 parameters; norms reduce in
float32; geometry, the soft-argmax and the diffusion state stay float32.
The same numpy inputs go through the JAX module built with
dtype=jnp.bfloat16 and the port's module built with dtype=torch.bfloat16
on the CPU, the JAX weights carried across with tools/jax_import.py, at
the 64x96 scale of tests/test_bf16.py. Tolerances, with their reasons:

  * each conv stack: max |diff| <= 2^-5 * max|JAX output| and mean |diff|
    <= 2^-7 * max|JAX output|. XLA:CPU and torch's CPU kernels both round
    the operands and each output to bfloat16 (a bfloat16 ulp is 2^-8
    relative) but sum in other orders, so outputs differ by an ulp where a
    sum lands near a rounding boundary, and the stacks carry it on
    (measured: at most 1.6e-2 against a largest magnitude of 0.96, in the
    UNet's delta head; the means stay below 2^-8 of it);
  * the whole export forward: the depths before refinement to 0.01 (in a
    [4, 10] depth range; measured 3.3e-3); every depth map's mean
    |diff| < 0.3 and the confidences' < 0.02 (measured 0.149 and 7.7e-3).
    Two things compound there. Random weights amplify the bfloat16
    roundings through the soft-argmax and the diffusion updates: the
    port's own bfloat16 depths move by the same 0.156 from its float32
    ones. And the JAX package's default XLA warp interpolates and
    multiplies bfloat16 features in bfloat16
    (diffmvs_tpu/geometry/sampling.py:52-54), while the port's warp (its
    plain path and its kernels, like the JAX package's Pallas kernels)
    reads them into float32 and rounds the correlation once;
  * the port's bfloat16 depths against its float32 depths: the JAX
    package's own bound (tests/test_bf16.py), mean |diff| < 1.0;
  * one bfloat16 training step (remat on, both sides): loss rtol 2e-3,
    global gradient cosine > 0.99 (measured: 2.3e-4 and 0.9936; the
    float32 step's gates, tests/test_torch_train.py, are 2e-4 and
    0.9999);
  * remat on against off, on the CPU: bit-equal gradients, losses and
    BatchNorm statistics (the recomputation runs the same ops on the same
    inputs).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffmvs_tpu.config import CASDIFFMVS, DIFFMVS
from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
from diffmvs_tpu.nn import context as jcontext
from diffmvs_tpu.nn import costreg as jcostreg
from diffmvs_tpu.nn import feature as jfeature
from diffmvs_tpu.nn import unet as junet
from diffmvs_tpu.ops import correlation as jcorr
from diffmvs_tpu.ops.pallas.warp_corr import warp_corr_pallas

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.nn import context, costreg, feature, unet
from diffmvs_tpu_torch.ops import correlation, warp_corr
from diffmvs_tpu_torch.tools import jax_import as ji
from diffmvs_tpu_torch.tools.jax_import import state_dict_from_jax
from diffmvs_tpu_torch.train.step import batch_to_device, compute_gradients
from diffmvs_tpu_torch.utils.synthetic import (synthetic_train_batch,
                                               synthetic_train_overrides)

from helpers import make_batch
from test_torch_model import _randomize_bn, _torch_batch
from test_torch_nn import _carry, _nchw, _ncdhw
from test_torch_ops import CORR_TOL, _corr_case
from test_torch_train import _cosine, _np, train_parity_case

JBF, TBF = jnp.bfloat16, torch.bfloat16
SMALL = dict(numdepth_initial=8, numdepth=32)
PRESETS = {"casdiffmvs": CASDIFFMVS, "diffmvs": DIFFMVS}


def _bf16_round(x):
    """x rounded to bfloat16, as float32 numpy."""
    return np.array(jnp.asarray(x, JBF).astype(jnp.float32))


def _close_bf16(got, want, what=""):
    """The conv-stack tolerance: both in bfloat16 (or both in float32,
    where the module's output is float32 in JAX), max |diff| <= 2^-5 and
    mean |diff| <= 2^-7 of the largest magnitude."""
    assert got.dtype == {jnp.dtype(JBF): TBF, jnp.dtype(jnp.float32):
                         torch.float32}[jnp.dtype(want.dtype)], (
        what, got.dtype, want.dtype)
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    scale = float(np.abs(w).max())
    err = np.abs(g - w)
    assert err.max() <= 2 ** -5 * scale, (what, err.max(), scale)
    assert err.mean() <= 2 ** -7 * scale, (what, err.mean(), scale)


# ---------------------------------------------------------------------------
# the warp on bf16 features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["refine", "sweep"])
def test_plain_warp_reads_bf16_as_jax_pallas(rng, case):
    """bf16 features through the port's plain warp (what K1 and K2 are
    held against on the card): read into f32, interpolated and
    group-averaged in f32, an f32 result, as the TPU kernel K1 replaces
    computes it (warp_corr_pallas in interpret mode, the CPU tests'
    tolerance CORR_TOL). JAX's default XLA warp interpolates and
    multiplies in bf16 instead and returns bf16: it lands within bf16
    rounding of both (|diff| <= 2^-6 of the largest correlation)."""
    src, ref, sp, rp, depths, wg = _corr_case(rng, case)
    jsrc, jref = (jnp.asarray(a, JBF) for a in (src, ref))
    got = correlation.warp_and_correlate(
        torch.from_numpy(src).to(TBF), torch.from_numpy(ref).to(TBF),
        torch.from_numpy(sp), torch.from_numpy(rp),
        torch.from_numpy(depths), 4)
    assert got.dtype == torch.float32
    want = np.asarray(jax.jit(lambda *a: warp_corr_pallas(
        *a, 4, window_group=wg, interpret=True))(jsrc, jref, sp, rp, depths))
    np.testing.assert_allclose(_np(got), want, **CORR_TOL)
    xla = jax.jit(lambda *a: jcorr.warp_and_correlate(*a, 4))(
        jsrc, jref, sp, rp, depths)
    assert xla.dtype == JBF
    err = np.abs(np.asarray(xla, np.float32) - want).max()
    assert err <= 2 ** -6 * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# the conv stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cascade", [True, False], ids=["cascade", "diffmvs"])
def test_feature_net_bf16(rng, cascade):
    x = rng.rand(2, 32, 48, 3).astype(np.float32)
    dims = (48, 32, 16) if cascade else (48, 32, 0)
    jm = jfeature.FeatureNet(8, dims, dtype=JBF)
    v, port = _carry(jm, feature.FeatureNet(8, dims, TBF),
                     lambda e: ji.featurenet(e, cascade, "", ()), rng, x)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = port(_nchw(x))
    assert sorted(got) == sorted(want)
    for k in want:
        _close_bf16(got[k].permute(0, 2, 3, 1), want[k], k)


def test_context_net_bf16(rng):
    x = rng.rand(1, 32, 48, 3).astype(np.float32)
    dims = (64, 64, 36)
    jm = jcontext.ContextNet(dims, dtype=JBF)
    v, port = _carry(jm, context.ContextNet(dims, TBF),
                     lambda e: ji.contextnet(e, True, "", ()), rng, x)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = port(_nchw(x))
    for k in want:
        _close_bf16(got[k].permute(0, 2, 3, 1), want[k], k)


def test_cost_reg_net_bf16(rng):
    """Its input is the float32 view-weighted aggregate."""
    x = rng.randn(1, 8, 8, 12, 4).astype(np.float32)
    jm = jcostreg.CostRegNet(8, dtype=JBF)
    v, port = _carry(jm, costreg.CostRegNet(4, 8, TBF),
                     lambda e: ji.costreg(e, ""), rng, x)
    with torch.no_grad():
        got = port(_ncdhw(x))
    _close_bf16(got, jm.apply(v, x))


def test_pixel_view_weight_bf16(rng):
    """A bfloat16 correlation volume in, float32 convs (the JAX module
    passes them no dtype), float32 weights out, in either model dtype."""
    x = _bf16_round(rng.randn(2, 8, 8, 12, 4))
    jm = jcostreg.PixelViewWeight(dtype=JBF)
    v, port = _carry(jm, costreg.PixelViewWeight(4),
                     lambda e: ji.pixel_view_weight(e, ""), rng,
                     jnp.asarray(x, JBF))
    want = jm.apply(v, jnp.asarray(x, JBF))
    with torch.no_grad():
        got = port(_ncdhw(x).to(TBF))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_condition_encoder_bf16(rng):
    """float32 cost and samples in; the bfloat16 learned channels are
    promoted to float32 by the concat with the float32 depth."""
    h, w, n, g, hd = 12, 16, 4, 4, 16
    depth = rng.rand(1, h, w, 1).astype(np.float32)
    samples = rng.rand(1, h, w, n).astype(np.float32)
    cost = rng.randn(1, h, w, g * n).astype(np.float32)
    jm = junet.ConditionEncoder(hidden_dim=hd, out_chs=hd, dtype=JBF)
    v, port = _carry(jm, unet.ConditionEncoder(g * n, n, hd, hd, TBF),
                     lambda e: ji.condition_encoder(e, ""), rng,
                     depth, samples, cost)
    with torch.no_grad():
        got = port(_nchw(depth), _nchw(samples), _nchw(cost))
    _close_bf16(got.permute(0, 2, 3, 1), jm.apply(v, depth, samples, cost))


@pytest.mark.parametrize("dim,hidden,mults", [(16, 32, (1, 2)),
                                              (8, 20, (1, 2, 4))],
                         ids=["stage1", "stage2"])
def test_diffusion_unet_bf16(rng, dim, hidden, mults):
    """float32 input (the encoder's output beside the bfloat16 context),
    a bfloat16 hidden state (HiddenInit's tanh); WSConv's eps follows its
    input's dtype, GroupNorm reduces in float32."""
    h, w, cin = 16, 24, 2 * dim
    down = 2 ** (len(mults) - 1)
    x = rng.randn(1, h, w, cin).astype(np.float32)
    hid = _bf16_round(np.tanh(rng.randn(1, h // down, w // down, hidden)))
    t = np.full((1,), 999, np.int32)
    jm = junet.DiffusionUNet(dim=dim, hidden_dim=hidden, dim_mults=mults,
                             dtype=JBF)
    v, port = _carry(jm, unet.DiffusionUNet(dim, hidden, cin, mults,
                                            dtype=TBF),
                     lambda e: ji.unet(e, "", (), dim, hidden, mults),
                     rng, x, jnp.asarray(hid, JBF), t)
    want = jm.apply(v, x, jnp.asarray(hid, JBF), t)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(hid).to(TBF), torch.from_numpy(t))
    _close_bf16(got[0].permute(0, 2, 3, 1), want[0], "hidden")
    _close_bf16(got[1], want[1], "delta")
    _close_bf16(got[2], want[2], "confidence")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def export_case():
    """Per preset: (port model in bfloat16, port model in float32, batch,
    JAX bfloat16 export outputs), the same randomised weights, zero
    diffusion noise. Built lazily."""
    built = {}

    def get(name):
        if name not in built:
            cfg = dataclasses.replace(PRESETS[name], **SMALL,
                                      compute_dtype="bfloat16")
            batch = make_batch(np.random.RandomState(0), 1, 3, 64, 96,
                               numdepth=32)
            model = JaxCasDiffMVS(cfg)
            variables = jax.device_get(model.init(
                jax.random.PRNGKey(0), batch["imgs"], batch["proj_matrices"],
                batch["depth_values"], rng=None, train=False, export=True))
            variables = {"params": variables["params"],
                         "batch_stats": _randomize_bn(
                             variables["batch_stats"],
                             np.random.RandomState(1))}
            want = jax.jit(lambda v, b: model.apply(
                v, b["imgs"], b["proj_matrices"], b["depth_values"],
                rng=None, train=False, export=True))(variables, batch)
            ports = []
            for dt in ("bfloat16", "float32"):
                tcfg = dataclasses.replace(tconfig.MODEL_PRESETS[name],
                                           **SMALL, compute_dtype=dt)
                port = CasDiffMVS(tcfg)
                port.load_state_dict(state_dict_from_jax(variables, tcfg),
                                     strict=True)
                ports.append(port.eval())
            built[name] = (*ports, batch, want)
        return built[name]

    return get


@pytest.mark.parametrize("name", ["casdiffmvs", "diffmvs"])
def test_export_forward_bf16_matches_jax(export_case, name):
    port, _, batch, want = export_case(name)
    with torch.no_grad():
        got = port(*_torch_batch(batch), export=True)
    assert len(got["depth"]) == len(want["depth"])
    for i, (g, w) in enumerate(zip(got["depth"], want["depth"])):
        assert g.dtype == torch.float32
        diff = np.abs(g.numpy() - np.asarray(w))
        if i < 2:                       # the initial stage, before diffusion
            assert diff.max() <= 0.01, (i, diff.max())
        assert diff.mean() < 0.3, (i, diff.mean())
    for g, w in zip(got["photometric_confidence"],
                    want["photometric_confidence"]):
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).mean() < 0.02


@pytest.mark.parametrize("name", ["casdiffmvs", "diffmvs"])
def test_bf16_depth_close_to_f32(export_case, name):
    """tests/test_bf16.py's bound on the port: finite, in the depth range,
    mean drift < 1.0 from the float32 model with the same weights."""
    port16, port32, batch, _ = export_case(name)
    with torch.no_grad():
        d16 = port16(*_torch_batch(batch), export=True)["depth"]
        d32 = port32(*_torch_batch(batch), export=True)["depth"]
    for a, b in zip(d32, d16):
        assert bool(torch.isfinite(b).all())
        assert b.min() >= 4.0 - 1e-2 and b.max() <= 10.0 + 1e-1
        assert (a - b).abs().mean() < 1.0


def test_bf16_model_keeps_float32_parameters():
    """Parameters and BatchNorm statistics stay float32 under bfloat16;
    anything but the two compute dtypes is refused."""
    cfg = dataclasses.replace(tconfig.CASDIFFMVS, **SMALL,
                              compute_dtype="bfloat16")
    assert cfg.dtype == torch.bfloat16
    model = CasDiffMVS(cfg)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for n, b in model.named_buffers()
            if "running" in n} == {torch.float32}
    with pytest.raises(ValueError, match="compute_dtype"):
        CasDiffMVS(dataclasses.replace(cfg, compute_dtype="float16"))


# ---------------------------------------------------------------------------
# training: one bfloat16 step against JAX, remat on against off
# ---------------------------------------------------------------------------

def test_bf16_train_step_matches_jax():
    """One training-branch forward + backward of CasDiffMVS in bfloat16
    with remat on, on each side (tests/test_torch_train.py's case): the
    loss, and the gradients of the float32 parameters by their global
    cosine."""
    loss_j, grads_sd, _, loss_t, port, _ = train_parity_case(
        "casdiffmvs", compute_dtype="bfloat16", remat=True)
    np.testing.assert_allclose(loss_t, loss_j, rtol=2e-3)
    assert {p.grad.dtype for p in port.parameters()} == {torch.float32}
    keys = sorted(k for k, _ in port.named_parameters())
    params = dict(port.named_parameters())
    cos = _cosine(np.concatenate([_np(params[k].grad).ravel() for k in keys]),
                  np.concatenate([np.asarray(grads_sd[k]).ravel()
                                  for k in keys]))
    assert cos > 0.99, cos


@pytest.fixture(scope="module")
def remat_runs():
    """Per compute dtype: one training step's (loss, model) with remat off
    and on, the same weights (seed 0), batch and timesteps / noise: B=2,
    3 views, 32x64, 8/32 hypotheses."""
    runs = {}
    batch = batch_to_device(synthetic_train_batch(2, 3, 32, 64, 32, seed=4),
                            "cpu")
    for dt in ("float32", "bfloat16"):
        out = []
        for remat in (False, True):
            cfg = tconfig.TrainConfig(model=dataclasses.replace(
                tconfig.CASDIFFMVS, **SMALL, compute_dtype=dt, remat=remat),
                batch_size=2)
            ov = synthetic_train_overrides(cfg.model, 2, 32, 64, seed=5)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = CasDiffMVS(cfg.model)
            loss, _, _, _ = compute_gradients(model, cfg, batch,
                                              train_overrides=ov)
            out.append((float(loss), model))
        runs[dt] = out
    return runs


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_remat_gradients_equal(remat_runs, dt):
    (loss0, m0), (loss1, m1) = remat_runs[dt]
    assert m1.update_block_depth2.remat and not m0.update_block_depth2.remat
    assert loss0 == loss1
    for (k, p0), (_, p1) in zip(m0.named_parameters(),
                                m1.named_parameters()):
        assert torch.equal(p0.grad, p1.grad), k


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_remat_leaves_batchnorm_statistics(remat_runs, dt):
    """The recomputed iterations hold no BatchNorm: every running
    statistic and batch count is the one the step without remat left."""
    (_, m0), (_, m1) = remat_runs[dt]
    bufs = dict(m1.named_buffers())
    assert any("num_batches_tracked" in k and int(v) == 1
               for k, v in bufs.items())
    for k, b in m0.named_buffers():
        assert torch.equal(b, bufs[k]), k


def test_remat_recomputes_each_iteration(monkeypatch):
    """Under remat the backward runs every refinement iteration again (its
    K1 launches on the card; counted here through the plain warp), and
    nothing else: 4 source views x 6 iterations = 24 more warps."""
    from diffmvs_tpu_torch.models import stages
    calls = []
    real = stages.warp_and_correlate

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(stages, "warp_and_correlate", counted)
    batch = batch_to_device(synthetic_train_batch(1, 5, 32, 64, 32, seed=2),
                            "cpu")
    counts = []
    for remat in (False, True):
        cfg = tconfig.TrainConfig(model=dataclasses.replace(
            tconfig.CASDIFFMVS, **SMALL, remat=remat), batch_size=1)
        ov = synthetic_train_overrides(cfg.model, 1, 32, 64, seed=3)
        del calls[:]
        compute_gradients(CasDiffMVS(cfg.model), cfg, batch,
                          train_overrides=ov)
        counts.append(len(calls))
    iters = sum(tconfig.CASDIFFMVS.stage_iters[1:])
    assert counts == [4 * (1 + iters), 4 * (1 + 2 * iters)]
    assert warp_corr.launches == warp_corr.bwd_launches == 0
