"""FeatureNet's stem (conv0 and conv1[0]) as one kernel
(FeatureNet.stem_fusable, ops/feature_stem.py): which path runs, and the
hand-written kernel against the module chain.

On the CPU: the routing decision and the wrapper's refusals. On the card
(the `chip` marker, skipped without CUDA; this file imports no JAX, so on
the card it runs alone with `python -m pytest
tests/test_torch_feature_stem.py --noconftest -m chip`): the kernel
against the module chain with TF32 off, its output's strides, and its
launch count in a forward of both presets and in a training step.
"""

import contextlib
import dataclasses

import pytest
import torch

from diffmvs_tpu_torch import config as tconfig
from diffmvs_tpu_torch.ops import feature_stem
from diffmvs_tpu_torch.parallel import spatial
from diffmvs_tpu_torch.tools.kernel_times import (stem_chain, stem_errors,
                                                  stem_images, stem_net)
from diffmvs_tpu_torch.utils import profiling
from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

SMALL = dict(numdepth_initial=8, numdepth=32)


# ---------------------------------------------------------------------------
# CPU: routing, the wrapper's refusals
# ---------------------------------------------------------------------------

# case: (the module's conditions met, i.e. stem_fusable)
ROUTES = {"cpu_tensor": True, "inference_mode": True, "frozen_grad": True,
          "train_mode": False, "grad_enabled": False,
          "float32_compute": False, "space_conv": False}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_takes_the_module_path(case):
    """The kernel's conditions: eval mode, autograd recording nothing, bf16
    compute, the plain Conv2d. A CPU tensor meets the module's conditions
    but never takes the kernel; every case here runs the module chain and
    launches nothing (a width shard's module is not run: its convs
    exchange halos with the group's other ranks)."""
    net = stem_net("cpu")
    gen = torch.Generator().manual_seed(0)
    x = stem_images(2, 16, 32, "cpu", gen)
    ctx = torch.no_grad()
    if case == "inference_mode":
        ctx = torch.inference_mode()
    elif case == "frozen_grad":
        net.requires_grad_(False)
        ctx = contextlib.nullcontext()
    elif case == "train_mode":
        net.train()
    elif case == "grad_enabled":
        ctx = contextlib.nullcontext()
    elif case == "float32_compute":
        net = stem_net("cpu", dtype=torch.float32)
    elif case == "space_conv":
        spatial.shard_width(net, spatial.SpaceGroup(None, 0, 1))
    before = profiling.counter(feature_stem.COUNTER)
    with ctx:
        assert net.stem_fusable(x) is ROUTES[case]
        if case != "space_conv":
            got = net(x)["stage1"]
            want = net.out1(net.conv3(net.conv2(net.conv1(net.conv0(x)))))
            assert got.shape == (2, 48, 2, 4)
            assert torch.equal(got, want)
    assert profiling.counter(feature_stem.COUNTER) == before


def test_the_module_chain_is_channels_last():
    """The module chain gives conv1[0]'s activation channels-last strides
    from the channels-last images the model hands FeatureNet: the layout
    the kernel's output takes."""
    net = stem_net("cpu")
    x = stem_images(2, 16, 32, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = stem_chain(net, x)
    want = torch.empty((2, 8, 16, 16)).permute(0, 3, 1, 2).stride()
    assert got.shape == (2, 16, 8, 16) and got.dtype == torch.bfloat16
    assert got.stride() == want


def test_kernel_refuses_cpu_tensors():
    net = stem_net("cpu")
    x = stem_images(1, 8, 8, "cpu", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA"):
        feature_stem.stem(x, feature_stem.params(net))


@pytest.mark.parametrize("shape", [(3, 8, 8), (1, 1, 3, 8, 8)],
                         ids=["rank3", "rank5"])
def test_kernel_refuses_images_of_another_rank(shape):
    net = stem_net("cpu")
    with pytest.raises(ValueError, match=r"expected images \[N, 3, H, W\]"):
        feature_stem.stem(torch.rand(shape), feature_stem.params(net))


@pytest.mark.parametrize("channels", [1, 4])
def test_kernel_refuses_other_channel_counts(channels):
    net = stem_net("cpu")
    with pytest.raises(ValueError, match=r"expected images \[N, 3, H, W\]"):
        feature_stem.stem(torch.rand(1, channels, 8, 8),
                          feature_stem.params(net))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


# name: (N, H, W). B = 1 of the DTU cells (5 views at 1152x1600); the
# tank preset's size; a small size that cuts every tile edge (output tiles
# of 16 x 32 half-res pixels); odd sizes
CARD_CASES = {"dtu_b1": (5, 1152, 1600), "tank": (2, 1056, 1920),
              "ragged": (2, 96, 160), "odd": (3, 37, 75), "tiny": (1, 5, 9)}


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_module(card, case):
    """The kernel against the module chain (cuDNN, TF32 off) on the same
    images, both held to the float32 chain of the same weights: the
    kernel's max and mean abs error at most 1.5 times the bf16 chain's own
    (one bf16 rounding a layer against the chain's two, sums in another
    order); the chain's channels-last strides; one launch."""
    n, h, w = CARD_CASES[case]
    net = stem_net(card, seed=2)
    gen = torch.Generator(device=card).manual_seed(3)
    x = stem_images(n, h, w, card, gen)
    with torch.inference_mode():
        assert net.stem_fusable(x)
        before = profiling.counter(feature_stem.COUNTER)
        got = feature_stem.stem(x, feature_stem.params(net))
        launches = profiling.counter(feature_stem.COUNTER) - before
        want = stem_chain(net, x)
    torch.cuda.synchronize()
    assert launches == 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.stride() == want.stride()
    err = stem_errors(net, x, got)
    assert err["max_abs_err"] <= 1.5 * err["module_max_abs_err"], err
    assert err["mean_abs_err"] <= 1.5 * err["module_mean_abs_err"], err


@pytest.mark.chip
def test_one_launch_a_forward_and_none_in_a_training_step(card):
    """A bf16 forward of either preset launches the kernel once, as does
    a validation step; a training step (BatchNorm's batch statistics, a
    backward) launches it never."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import eval_step, train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    def launches(fn):
        before = profiling.counter(feature_stem.COUNTER)
        fn()
        torch.cuda.synchronize()
        return profiling.counter(feature_stem.COUNTER) - before

    imgs, projs, dv = synthetic_inputs(2, 3, 64, 96, 32)
    for preset in ("casdiffmvs", "diffmvs"):
        runner = DepthRunner.from_random(preset, device=card,
                                         compute_dtype="bfloat16", **SMALL)
        assert launches(lambda: runner(imgs, projs, dv)) == 1

    model = dataclasses.replace(tconfig.CASDIFFMVS, **SMALL,
                                compute_dtype="bfloat16")
    cfg = tconfig.TrainConfig(model=model, batch_size=1)
    state = create_train_state(cfg, steps_per_epoch=1, device=card)
    batch = synthetic_train_batch(1, 3, 32, 64, 32)
    gen = torch.Generator(device=card).manual_seed(0)
    assert launches(lambda: train_step(state, cfg, batch, gen)) == 0
    assert launches(lambda: eval_step(state, cfg, batch, gen)) == 1
    assert launches(lambda: train_step(state, cfg, batch, gen)) == 0
