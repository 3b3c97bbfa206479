"""PixelViewWeight over all source views at once (PixelViewWeight.views):
which path runs, and the hand-written kernel (ops/view_weight.py) against
the module's own path.

On the CPU: the routing decision, the stacked-volume form against the
per-view loop, the wrapper's refusals. On the card (the
`chip` marker, skipped without CUDA; this file imports no JAX, so on the
card it runs alone with `python -m pytest tests/test_torch_view_weight.py
--noconftest -m chip`): the kernel against the module path with TF32 off,
and its launch count in a forward and in a training step.
"""

import contextlib
import dataclasses

import pytest
import torch

from diffmvs_tpu_torch import config as tconfig
from diffmvs_tpu_torch.models.stages import InitialStage
from diffmvs_tpu_torch.ops import view_weight
from diffmvs_tpu_torch.ops.correlation import warp_and_correlate
from diffmvs_tpu_torch.parallel import spatial
from diffmvs_tpu_torch.tools.kernel_times import (pvw_library, pvw_module,
                                                  pvw_views)
from diffmvs_tpu_torch.utils import profiling
from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

SMALL = dict(numdepth_initial=8, numdepth=32)


# ---------------------------------------------------------------------------
# CPU: routing, the stacked form, the wrapper's refusals
# ---------------------------------------------------------------------------

# case: (module conditions met, i.e. fusable)
ROUTES = {"cpu_tensor": True, "inference_mode": True, "frozen_grad": True,
          "train_mode": False, "grad_enabled": False, "space_conv": False,
          "no_running_stats": False}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_takes_the_module_path(case):
    """The kernel's conditions: eval mode, autograd recording nothing, the
    plain Conv3d, BatchNorm's running statistics. A CPU tensor meets the module's conditions but never
    takes the kernel; every case here runs the module, view by view, and
    launches nothing (a width shard's module is not run: its convs
    exchange halos with the group's other ranks)."""
    m = pvw_module(4, "cpu")
    x = torch.randn(2, 1, 3, 5, 6, 4)                  # [V-1,B,D,H,W,G]
    ctx = torch.no_grad()
    if case == "inference_mode":
        ctx = torch.inference_mode()
    elif case == "frozen_grad":
        m.requires_grad_(False)
        ctx = contextlib.nullcontext()
    elif case == "train_mode":
        m.train()
    elif case == "grad_enabled":
        ctx = contextlib.nullcontext()
    elif case == "space_conv":
        spatial.shard_width(m, spatial.SpaceGroup(None, 0, 1))
    elif case == "no_running_stats":
        bn = m.conv[0].bn
        bn.track_running_stats = False
        bn.running_mean = bn.running_var = None
    before = profiling.counter(view_weight.COUNTER)
    with ctx:
        assert m.fusable(x) is ROUTES[case]
        if case != "space_conv":
            assert torch.equal(m.views(x), pvw_library(m, pvw_views(x)))
    assert profiling.counter(view_weight.COUNTER) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stage_view_weights_equal_the_per_view_loop(dtype, train):
    """InitialStage's view weights through the stacked volume are the
    module's weights of each view's volume as the warp gives it."""
    b, v, h, w, c, d, g = 2, 3, 8, 12, 16, 4, 4
    torch.manual_seed(0)
    stage = InitialStage(context_dim=8, group_dim=g)
    stage.train(train)
    features = [torch.randn(b, h, w, c).to(dtype) for _ in range(v)]
    context = torch.randn(b, 8, h, w)
    _, projs, _ = synthetic_inputs(b, v, 8 * h, 8 * w, d)
    pairs = torch.from_numpy(projs["stage1"])
    depth = (1.0 / torch.linspace(0.1, 0.25, d)).reshape(1, d, 1, 1)
    depth = depth.expand(b, d, h, w).contiguous()
    with torch.no_grad():
        out = stage(features, context, pairs, depth, lambda x: (x, x))
        cors = [warp_and_correlate(f, features[0], pairs[:, i + 1],
                                   pairs[:, 0], depth, g).to(dtype)
                for i, f in enumerate(features[1:])]
        want = torch.stack([stage.pixel_view_weight(
            cor.permute(0, 4, 1, 2, 3)) for cor in cors])
    assert out[3].shape == (v - 1, b, h, w) and out[3].dtype == torch.float32
    assert torch.equal(out[3], want)


def test_kernel_refuses_cpu_tensors():
    m = pvw_module(4, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        view_weight.view_weights(torch.randn(1, 1, 2, 3, 4, 4),
                                 *view_weight.weights(m))


def test_kernel_refuses_a_volume_of_another_rank():
    """A single view's [B, D, H, W, G] volume is refused: the kernel takes
    the stacked [V-1, B, D, H, W, G] volume of all views."""
    m = pvw_module(4, "cpu")
    with pytest.raises(ValueError, match=r"expected \[V-1, B, D, H, W, G\]"):
        view_weight.view_weights(torch.randn(1, 2, 3, 4, 4),
                                 *view_weight.weights(m))


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


# name: (V-1, B, D, H, W, G). The main path's sweep at B = 1; ragged
# shapes that cut every tile edge (output tiles of 18 x 30);
# one plane; G = 8
CARD_CASES = {"sweep_b1": (4, 1, 48, 144, 200, 4),
              "ragged": (2, 2, 5, 7, 13, 4),
              "ragged_tiles": (2, 1, 5, 19, 37, 4),
              "one_plane": (1, 1, 1, 9, 31, 4),
              "g8": (2, 1, 6, 19, 37, 8)}


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_module(card, case, dtype):
    """The kernel against the module's path (cuDNN in float32, TF32 off)
    on the same volume: max abs error <= 1e-5 on the [0, 1] weights (float32
    sums of 27 G and 216 terms in another order, ~1e-6); one launch."""
    v, b, d, h, w, g = CARD_CASES[case]
    m = pvw_module(g, card, seed=2)
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((v, b, d, h, w, g), generator=gen, device=card).to(dtype)
    with torch.inference_mode():
        assert m.fusable(x)
        before = profiling.counter(view_weight.COUNTER)
        got = m.views(x)
        launches = profiling.counter(view_weight.COUNTER) - before
        want = pvw_library(m, pvw_views(x))
    torch.cuda.synchronize()
    assert launches == 1
    assert got.shape == (v, b, h, w) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.chip
def test_one_launch_a_forward_and_none_in_a_training_step(card):
    """A request and a validation step each launch the kernel once; a
    training step (BatchNorm's batch statistics, a backward) launches it
    never."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import eval_step, train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    def launches(fn):
        before = profiling.counter(view_weight.COUNTER)
        fn()
        torch.cuda.synchronize()
        return profiling.counter(view_weight.COUNTER) - before

    runner = DepthRunner.from_random("casdiffmvs", device=card, **SMALL)
    imgs, projs, dv = synthetic_inputs(2, 3, 64, 96, 32)
    assert launches(lambda: runner(imgs, projs, dv)) == 1

    cfg = tconfig.TrainConfig(
        model=dataclasses.replace(tconfig.CASDIFFMVS, **SMALL), batch_size=1)
    state = create_train_state(cfg, steps_per_epoch=1, device=card)
    batch = synthetic_train_batch(1, 3, 32, 64, 32)
    gen = torch.Generator(device=card).manual_seed(0)
    assert launches(lambda: train_step(state, cfg, batch, gen)) == 0
    assert launches(lambda: eval_step(state, cfg, batch, gen)) == 1
    assert launches(lambda: train_step(state, cfg, batch, gen)) == 0
