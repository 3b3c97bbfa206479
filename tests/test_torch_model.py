"""PyTorch port: the CasDiffMVS / DiffMVS inference path as a whole.

The JAX model (default config: XLA warp, no s2d) is initialised from a
seed at 64x96, 3 views, 8/32 hypotheses, with randomised BatchNorm
statistics; its weights are carried into the port with
state_dict_from_jax and loaded with strict=True. Zero diffusion noise on
both sides (rng=None / generator=None). Every depth and confidence of
the output lists is compared at rtol 5e-3 / atol 5e-3, as the JAX
package's full-model parity test does: soft-argmax and convex upsampling
over random weights amplify ulp-level differences.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from diffmvs_tpu.config import CASDIFFMVS, DIFFMVS
from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
from diffmvs_tpu.models.schedule import DiffusionSchedule as JaxSchedule

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch import api
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.models.schedule import DiffusionSchedule
from diffmvs_tpu_torch.tools.jax_import import state_dict_from_jax

from helpers import make_batch

TOL = dict(rtol=5e-3, atol=5e-3)
PRESETS = {"casdiffmvs": CASDIFFMVS, "diffmvs": DIFFMVS}
SMALL = dict(numdepth_initial=8, numdepth=32)


def _randomize_bn(stats, rng):
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def case():
    """Per preset: (jax variables, batch, jax apply fn), built lazily."""
    built = {}

    def get(name):
        if name not in built:
            cfg = dataclasses.replace(PRESETS[name], **SMALL)
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

            def run(export):
                return jax.jit(lambda v, b: model.apply(
                    v, b["imgs"], b["proj_matrices"], b["depth_values"],
                    rng=None, train=False, export=export))(variables, batch)

            built[name] = (cfg, variables, batch, run)
        return built[name]

    return get


def _port(name, variables):
    cfg = dataclasses.replace(tconfig.MODEL_PRESETS[name], **SMALL)
    model = CasDiffMVS(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model.eval()


def _torch_batch(batch):
    return (torch.from_numpy(batch["imgs"]),
            {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
            torch.from_numpy(batch["depth_values"]))


def _assert_lists_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["casdiffmvs", "diffmvs"])
def test_export_forward_matches_jax(case, name):
    cfg, variables, batch, run = case(name)
    want = run(True)
    with torch.no_grad():
        got = _port(name, variables)(*_torch_batch(batch), export=True)
    _assert_lists_close(got["depth"], want["depth"])
    _assert_lists_close(got["photometric_confidence"],
                        want["photometric_confidence"])
    assert got["conf"] == [] and len(want["conf"]) == 0


def test_validation_lists_match_jax(case):
    """export=False: every intermediate depth and per-iteration
    confidence, in the JAX package's list layout."""
    cfg, variables, batch, run = case("casdiffmvs")
    want = run(False)
    with torch.no_grad():
        got = _port("casdiffmvs", variables)(*_torch_batch(batch),
                                             export=False)
    _assert_lists_close(got["depth"], want["depth"])
    _assert_lists_close(got["conf"], want["conf"])
    _assert_lists_close(got["photometric_confidence"],
                        want["photometric_confidence"])


def test_schedule_matches_jax():
    kw = dict(timesteps=1000, sampling_timesteps=3, eta=1.0, scale=0.5)
    js, ts = JaxSchedule(**kw), DiffusionSchedule(**kw)
    for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(ts.table(name), js.table(name))
    assert ts.ddim_time_pairs() == js.ddim_time_pairs()
    for time, time_next in ts.ddim_time_pairs()[:-1]:
        assert ts.ddim_coeffs(time, time_next) == \
            js.ddim_coeffs(time, time_next)
    x_t = np.random.RandomState(0).rand(2, 3, 4).astype(np.float32)
    x0 = np.random.RandomState(1).rand(2, 3, 4).astype(np.float32)
    t = np.array([999, 499], np.int32)
    np.testing.assert_allclose(
        ts.predict_noise_from_start(torch.from_numpy(x_t),
                                    torch.from_numpy(t),
                                    torch.from_numpy(x0)).numpy(),
        np.asarray(js.predict_noise_from_start(x_t, t, x0)),
        rtol=1e-6, atol=1e-6)


def test_two_step_ddim_matches_jax(case):
    """sampling_timesteps = 2: the hidden state resets per DDIM pair and
    the DDIM update runs between pairs (zero noise on both sides)."""
    _, variables, batch, _ = case("diffmvs")
    steps = dict(sampling_timesteps=(1, 2, 1), **SMALL)
    model = JaxCasDiffMVS(dataclasses.replace(DIFFMVS, **steps))
    want = jax.jit(lambda v, b: model.apply(
        v, b["imgs"], b["proj_matrices"], b["depth_values"], rng=None,
        train=False, export=True))(variables, batch)
    tcfg = dataclasses.replace(tconfig.DIFFMVS, **steps)
    port = CasDiffMVS(tcfg)
    port.load_state_dict(state_dict_from_jax(variables, tcfg), strict=True)
    with torch.no_grad():
        got = port.eval()(*_torch_batch(batch), export=True)
    _assert_lists_close(got["depth"], want["depth"])
    _assert_lists_close(got["photometric_confidence"],
                        want["photometric_confidence"])


def test_depth_runner_cpu_end_to_end(case):
    """DepthRunner(device="cpu") from carried weights, numpy and uint8
    inputs; zero noise scale so the seeded generator draws nothing."""
    cfg, variables, batch, run = case("casdiffmvs")
    want = run(True)
    sd = state_dict_from_jax(variables, cfg)
    runner = api.DepthRunner.from_state_dict(
        sd, "casdiffmvs", device="cpu", scale=(0.0, 0.0, 0.0), **SMALL)
    depth, confs = runner(batch["imgs"], batch["proj_matrices"],
                          batch["depth_values"])
    assert depth.device.type == "cpu" and depth.shape == (1, 64, 96)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want["depth"][-1]),
                               **TOL)
    _assert_lists_close(confs, want["photometric_confidence"])

    u8 = (batch["imgs"] * 255).astype(np.uint8)
    d8, _ = runner(u8, batch["proj_matrices"], batch["depth_values"])
    d32, _ = runner(u8.astype(np.float32) / 255.0, batch["proj_matrices"],
                    batch["depth_values"])
    torch.testing.assert_close(d8, d32)


def test_depth_runner_noise_is_seeded():
    """With noise on, one seed gives one answer and the generator is the
    only source of randomness."""
    runner = api.DepthRunner.from_random("casdiffmvs", device="cpu", seed=3,
                                         **SMALL)
    b = make_batch(np.random.RandomState(0), 1, 3, 64, 96, numdepth=32)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    d1, _ = runner(*args)
    d2, _ = runner(*args)
    d3, _ = runner(*args, generator=torch.Generator().manual_seed(4))
    assert torch.equal(d1, d2)
    assert not torch.equal(d1, d3)
    assert torch.isfinite(d1).all()


def test_depth_runner_needs_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.DepthRunner.from_random("casdiffmvs", **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.DepthRunner.from_random("casdiffmvs", device="cuda", **SMALL)
    assert api.DepthRunner.from_random(
        "casdiffmvs", device="cpu", **SMALL).device.type == "cpu"
