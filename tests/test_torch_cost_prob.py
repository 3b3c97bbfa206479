"""CostRegNet's `prob` layer (the 8 -> 1 3x3x3 conv) as one kernel
(CostRegNet.prob_fusable, ops/cost_prob.py): which path runs, and the
hand-written kernel against the module.

On the CPU: the routing decision, the module's output, the wrapper's
refusals and the error measure. On the card (the `chip` marker, skipped
without CUDA; this file imports no JAX, so on the card it runs alone with
`python -m pytest tests/test_torch_cost_prob.py --noconftest -m chip`):
the kernel against the module's cuDNN convolution with TF32 off, and its
launch count in a forward and in a training step.
"""

import contextlib
import dataclasses

import pytest
import torch

from diffmvs_tpu_torch import config as tconfig
from diffmvs_tpu_torch.nn.costreg import CostRegNet
from diffmvs_tpu_torch.ops import cost_prob
from diffmvs_tpu_torch.parallel import spatial
from diffmvs_tpu_torch.tools.kernel_times import (prob_bound, prob_errors,
                                                  prob_input, prob_module)
from diffmvs_tpu_torch.utils import profiling
from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

SMALL = dict(numdepth_initial=8, numdepth=32)


# ---------------------------------------------------------------------------
# CPU: routing, the module's output, the wrapper's refusals
# ---------------------------------------------------------------------------

def costreg(dtype=torch.bfloat16, seed=0):
    """An eval-mode CostRegNet over 4 groups computing in dtype."""
    torch.manual_seed(seed)
    return CostRegNet(4, dtype=dtype).eval()


def volume(dtype=torch.bfloat16, b=2, d=8, h=8, w=12, seed=0):
    """A cost volume as InitialStage hands it over: the channels-last
    [B, G, D, H, W] view of the aggregate [B, D, H, W, G]."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, d, h, w, 4), generator=gen).to(dtype).permute(
        0, 4, 1, 2, 3)


def module_chain(net, x):
    """CostRegNet's forward with `prob` run as the module."""
    c1 = net.conv1(net.conv0(x))
    c3 = net.conv3(net.conv2(c1))
    c5 = net.conv5(net.conv4(c3))
    y = c1 + net.conv7(c3 + net.conv6(c5))
    return net.prob(y)[:, 0]


# case: (the module's conditions met, i.e. prob_fusable)
ROUTES = {"cpu_tensor": True, "inference_mode": True, "frozen_grad": True,
          "float32_compute": True, "train_mode": False, "grad_enabled": False,
          "other_dtype": False, "space_conv": False}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_takes_the_module_path(case):
    """The kernel's conditions: eval mode, autograd recording nothing, the
    input in the layer's compute dtype, the plain Conv3d. A CPU tensor
    meets the module's conditions but never takes the kernel; every case
    here runs the module and launches nothing (a width shard's module is
    not run: its convs exchange halos with the group's other ranks)."""
    net, x = costreg(), volume()
    ctx = torch.no_grad()
    if case == "inference_mode":
        ctx = torch.inference_mode()
    elif case == "frozen_grad":
        net.requires_grad_(False)
        ctx = contextlib.nullcontext()
    elif case == "float32_compute":
        net, x = costreg(torch.float32), volume(torch.float32)
    elif case == "train_mode":
        net.train()
    elif case == "grad_enabled":
        ctx = contextlib.nullcontext()
    elif case == "other_dtype":
        x = volume(torch.float32)
    elif case == "space_conv":
        spatial.shard_width(net, spatial.SpaceGroup(None, 0, 1))
    # the layer's input: 8 channels in its compute dtype, or float32
    y = torch.zeros((2, 8, 8, 8, 12), dtype=torch.float32
                    if case == "other_dtype" else net.prob.compute_dtype)
    before = profiling.counter(cost_prob.COUNTER)
    with ctx:
        assert net.prob_fusable(y) is ROUTES[case]
        if case != "space_conv":
            got = net(x)
            assert torch.equal(got, module_chain(net, x))
            assert got.shape == (2, 8, 8, 12)
    assert profiling.counter(cost_prob.COUNTER) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_costreg_output_on_the_cpu_is_the_module_chain(dtype):
    """On the CPU CostRegNet's logits are its module chain's, in its
    compute dtype."""
    net, x = costreg(dtype), volume(dtype, b=1, d=4, h=4, w=8)
    with torch.no_grad():
        got = net(x)
        want = module_chain(net, x)
    assert got.dtype == dtype and got.shape == (1, 4, 4, 8)
    assert torch.equal(got, want)


def test_kernel_refuses_cpu_tensors():
    m = prob_module("cpu")
    x = prob_input(1, 2, 3, 4, torch.bfloat16, "cpu", torch.Generator())
    with pytest.raises(ValueError, match="CUDA"):
        cost_prob.prob_conv(x, m.weight)


@pytest.mark.parametrize("shape", [(8, 2, 3, 4), (1, 4, 2, 3, 4),
                                   (1, 1, 8, 2, 3, 4)],
                         ids=["rank4", "channels4", "rank6"])
def test_kernel_refuses_a_volume_of_another_shape(shape):
    m = prob_module("cpu")
    with pytest.raises(ValueError, match=r"expected \[B, 8, D, H, W\]"):
        cost_prob.prob_conv(torch.randn(shape), m.weight)


@pytest.mark.parametrize("weight", [(1, 4, 3, 3, 3), (2, 8, 3, 3, 3),
                                    (1, 8, 1, 1, 1)],
                         ids=["in4", "out2", "k1"])
def test_kernel_refuses_a_weight_of_another_shape(weight):
    x = prob_input(1, 2, 3, 4, torch.float32, "cpu", torch.Generator())
    with pytest.raises(ValueError, match="weight shape"):
        cost_prob.prob_conv(x, torch.randn(weight))


def test_kernel_refuses_a_weight_of_another_dtype():
    x = prob_input(1, 2, 3, 4, torch.float32, "cpu", torch.Generator())
    with pytest.raises(TypeError, match="weight must be float32"):
        cost_prob.prob_conv(x, torch.randn(1, 8, 3, 3, 3).bfloat16())


def test_errors_count_bf16_ulps():
    """prob_errors: one bf16 ulp of the module's value reads 1, and near
    zero the ulp of the floor."""
    want = torch.tensor([1.0, -3.0, 1e-6]).bfloat16()
    got = torch.tensor([1.0 + 2 ** -7, -3.0, 1e-6 + 2 ** -18])
    r = prob_errors(got, want)
    assert r["max_ulp_err"] == 1.0
    assert r["max_abs_err"] == 2 ** -7


def test_bound_at_the_sweep():
    """The bound at B = 16 bf16, 48 x 144 x 200: 9.55 GFLOP on the FP32
    pipes (0.143 ms) over 398 MB (0.119 ms)."""
    ms, by = prob_bound(16, 48, 144, 200, 2)
    assert by == "operations" and ms == pytest.approx(0.1426, abs=1e-4)
    ms, by = prob_bound(16, 48, 144, 200, 4)
    assert by == "bytes" and ms == pytest.approx(0.2377, abs=1e-4)


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


# name: (B, D, H, W). The sweep at B = 1 and 16; one plane; ragged shapes
# that cut every tile edge (output tiles of 16 x 30); the Tanks presets'
# 96 planes; and the layer's input as a contiguous NCDHW tensor
CARD_CASES = {"sweep_b1": (1, 48, 144, 200), "sweep_b16": (16, 48, 144, 200),
              "one_plane": (1, 1, 9, 31), "ragged": (2, 5, 25, 61),
              "d96": (1, 96, 33, 40), "ncdhw": (2, 7, 19, 37)}


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_module(card, case, dtype):
    """The kernel against the module's cuDNN convolution (TF32 off) on the
    same volume: float32 within 1e-5, bfloat16 within one bf16 ulp (both
    float32 sums of 216 terms in other orders, rounded once); one launch
    through CostRegNet's routing condition."""
    b, d, h, w = CARD_CASES[case]
    m = prob_module(card, dtype, seed=2)
    gen = torch.Generator(device=card).manual_seed(3)
    x = prob_input(b, d, h, w, dtype, card, gen)
    if case == "ncdhw":
        x = x.contiguous()
    with torch.inference_mode():
        before = profiling.counter(cost_prob.COUNTER)
        got = cost_prob.prob_conv(x, m.weight)
        launches = profiling.counter(cost_prob.COUNTER) - before
        want = m(x)[:, 0]
    torch.cuda.synchronize()
    assert launches == 1
    assert got.shape == want.shape == (b, d, h, w) and got.dtype == dtype
    r = prob_errors(got, want)
    if dtype == torch.float32:
        assert r["max_abs_err"] <= 1e-5, r
    else:
        assert r["max_ulp_err"] <= 1.0, r


@pytest.mark.chip
def test_one_launch_a_forward_and_none_in_a_training_step(card):
    """A request and a validation step each launch the kernel once; a
    training step (autograd records the layer) launches it never."""
    from diffmvs_tpu_torch.api import DepthRunner
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import eval_step, train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    def launches(fn):
        before = profiling.counter(cost_prob.COUNTER)
        fn()
        torch.cuda.synchronize()
        return profiling.counter(cost_prob.COUNTER) - before

    imgs, projs, dv = synthetic_inputs(2, 3, 64, 96, 32)
    for dtype in ("float32", "bfloat16"):
        runner = DepthRunner.from_random("casdiffmvs", device=card,
                                         compute_dtype=dtype, **SMALL)
        assert launches(lambda: runner(imgs, projs, dv)) == 1
    runner = DepthRunner.from_random("diffmvs", device=card, **SMALL)
    assert launches(lambda: runner(imgs, projs, dv)) == 1

    cfg = tconfig.TrainConfig(
        model=dataclasses.replace(tconfig.CASDIFFMVS, **SMALL), batch_size=1)
    state = create_train_state(cfg, steps_per_epoch=1, device=card)
    batch = synthetic_train_batch(1, 3, 32, 64, 32)
    gen = torch.Generator(device=card).manual_seed(0)
    assert launches(lambda: train_step(state, cfg, batch, gen)) == 0
    assert launches(lambda: eval_step(state, cfg, batch, gen)) == 1
    assert launches(lambda: train_step(state, cfg, batch, gen)) == 0
