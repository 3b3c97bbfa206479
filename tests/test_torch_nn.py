"""PyTorch port: NN blocks against their JAX modules, in eval mode.

Each JAX module is initialised from a seed, its norm statistics and
affines randomised, its weights carried across with
diffmvs_tpu_torch.tools.jax_import and loaded with strict=True; the same
numpy input goes through both. Tolerance rtol 1e-4 / atol 1e-4: float32
convolutions sum in another order in XLA and in PyTorch.
"""

import numpy as np
import jax
import pytest
import torch

from diffmvs_tpu.nn import context as jcontext
from diffmvs_tpu.nn import costreg as jcostreg
from diffmvs_tpu.nn import feature as jfeature
from diffmvs_tpu.nn import layers as jlayers
from diffmvs_tpu.nn import unet as junet

from diffmvs_tpu_torch.nn import context, costreg, feature, layers, unet
from diffmvs_tpu_torch.tools import jax_import as ji

TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize(tree, rng):
    """Norm scales in [0.5, 1.5], biases and BN means shifted, BN variances
    in [0.5, 1.5] (flax initialises them to 1, 0, 0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = v + rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        out[k] = v
    return out


def _carry(jmodule, port, export, rng, *inputs):
    """Init the JAX module on `inputs`, randomise, carry the weights into
    `port` (strict) and return (jax variables, port in eval mode)."""
    variables = jax.device_get(jmodule.init(jax.random.PRNGKey(0), *inputs))
    variables = _randomize(dict(variables), rng)
    e = ji.Emitter(variables)
    export(e)
    port.load_state_dict(e.sd, strict=True)
    return variables, port.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_conv_bn_act(rng):
    x = rng.randn(2, 16, 20, 5).astype(np.float32)
    jm = jlayers.ConvBnAct(8, 3, 2, 1)
    v, port = _carry(jm, layers.ConvBnAct(5, 8, 3, 2, 1),
                     lambda e: e.conv_bn(""), rng, x)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1)
    _close(got, jm.apply(v, x))


def test_conv3d_bn_act(rng):
    x = rng.randn(2, 4, 6, 8, 4).astype(np.float32)
    jm = jlayers.Conv3dBnAct(8, 3, 1, 1)
    v, port = _carry(jm, layers.Conv3dBnAct(4, 8, 3, 1, 1),
                     lambda e: e.conv_bn(""), rng, x)
    with torch.no_grad():
        got = port(_ncdhw(x)).permute(0, 2, 3, 4, 1)
    _close(got, jm.apply(v, x))


def test_deconv3d_bn_act(rng):
    x = rng.randn(2, 3, 4, 5, 16).astype(np.float32)
    jm = jlayers.Deconv3dBnAct(8)

    def export(e):
        e.deconv3d("conv")
        e.bn("bn", "bn")

    v, port = _carry(jm, layers.Deconv3dBnAct(16, 8), export, rng, x)
    with torch.no_grad():
        got = port(_ncdhw(x)).permute(0, 2, 3, 4, 1)
    assert got.shape == (2, 6, 8, 10, 8)
    _close(got, jm.apply(v, x))


def test_sep_conv_gru(rng):
    h = rng.randn(2, 6, 8, 8).astype(np.float32)
    x = rng.randn(2, 6, 8, 12).astype(np.float32)
    jm = jlayers.SepConvGRU(8)
    v, port = _carry(jm, layers.SepConvGRU(8, 12),
                     lambda e: ji.gru(e, ""), rng, h, x)
    with torch.no_grad():
        got = port(_nchw(h), _nchw(x)).permute(0, 2, 3, 1)
    _close(got, jm.apply(v, h, x))


@pytest.mark.parametrize("cascade", [True, False], ids=["cascade", "diffmvs"])
def test_feature_net(rng, cascade):
    x = rng.rand(2, 32, 48, 3).astype(np.float32)
    dims = (48, 32, 16) if cascade else (48, 32, 0)
    jm = jfeature.FeatureNet(8, dims)
    v, port = _carry(jm, feature.FeatureNet(8, dims),
                     lambda e: ji.featurenet(e, cascade, "", ()), rng, x)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = port(_nchw(x))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].permute(0, 2, 3, 1), want[k])


def test_context_net(rng):
    x = rng.rand(1, 32, 48, 3).astype(np.float32)
    dims = (64, 64, 36)
    jm = jcontext.ContextNet(dims)
    v, port = _carry(jm, context.ContextNet(dims),
                     lambda e: ji.contextnet(e, True, "", ()), rng, x)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = port(_nchw(x))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].permute(0, 2, 3, 1), want[k])


def test_cost_reg_net(rng):
    x = rng.randn(1, 8, 8, 12, 4).astype(np.float32)
    jm = jcostreg.CostRegNet(8)
    v, port = _carry(jm, costreg.CostRegNet(4, 8),
                     lambda e: ji.costreg(e, ""), rng, x)
    with torch.no_grad():
        got = port(_ncdhw(x))
    _close(got, jm.apply(v, x))


def test_pixel_view_weight(rng):
    x = rng.randn(2, 8, 8, 12, 4).astype(np.float32)
    jm = jcostreg.PixelViewWeight()
    v, port = _carry(jm, costreg.PixelViewWeight(4),
                     lambda e: ji.pixel_view_weight(e, ""), rng, x)
    with torch.no_grad():
        got = port(_ncdhw(x))
    _close(got, jm.apply(v, x))


@pytest.mark.parametrize("dim,hidden,mults", [(16, 32, (1, 2)),
                                              (8, 20, (1, 2, 4))],
                         ids=["stage1", "stage2"])
def test_diffusion_unet(rng, dim, hidden, mults):
    h, w, cin = 16, 24, 2 * dim
    down = 2 ** (len(mults) - 1)
    x = rng.randn(1, h, w, cin).astype(np.float32)
    hid = np.tanh(rng.randn(1, h // down, w // down, hidden)).astype(np.float32)
    t = np.full((1,), 999, np.int32)
    jm = junet.DiffusionUNet(dim=dim, hidden_dim=hidden, dim_mults=mults)
    v, port = _carry(jm, unet.DiffusionUNet(dim, hidden, cin, mults),
                     lambda e: ji.unet(e, "", (), dim, hidden, mults),
                     rng, x, hid, t)
    want = jm.apply(v, x, hid, t)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(hid), torch.from_numpy(t))
    _close(got[0].permute(0, 2, 3, 1), want[0])
    _close(got[1], want[1])
    _close(got[2], want[2])


def test_condition_encoder(rng):
    h, w, n, g, hd = 12, 16, 4, 4, 16
    depth = rng.rand(1, h, w, 1).astype(np.float32)
    samples = rng.rand(1, h, w, n).astype(np.float32)
    cost = rng.randn(1, h, w, g * n).astype(np.float32)
    jm = junet.ConditionEncoder(hidden_dim=hd, out_chs=hd)
    v, port = _carry(jm, unet.ConditionEncoder(g * n, n, hd, hd),
                     lambda e: ji.condition_encoder(e, ""), rng,
                     depth, samples, cost)
    with torch.no_grad():
        got = port(_nchw(depth), _nchw(samples), _nchw(cost))
    _close(got.permute(0, 2, 3, 1), jm.apply(v, depth, samples, cost))
