"""The yardstick's counts: each configuration's FLOPs a map recounted at
its own image size, the bound arithmetic by hand, K2's bound being the
bytes' at the training shapes, and the warp calls at the DTU shapes and
at another view and plane count."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsbench import inputs as I
from mvsbench import manifest
from mvsbench.reference.model import draw_eval_noise
from mvsbench.roofline import counts

DOC = manifest.load()


def count_flops(config, h, w):
    ref = I.reference_model(config, "meta").eval()
    with torch.device("meta"):
        imgs = torch.empty(1, config["views"], h, w, 3)
        projs = {f"stage{i}": torch.empty(1, config["views"], 2, 4, 4)
                 for i in range(1, 5)}
        dv = torch.empty(1, config["model"]["numdepth"])
    noise = {s: [torch.empty(1, h // 2 ** (3 - s), w // 2 ** (3 - s),
                             device="meta")]
             for s in (1, 2) if config["model"]["stage_iters"][s]}
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(imgs, projs, dv, noise)
    return fc.get_total_flops()


def check_flops_per_map(config):
    """What a configuration file is held to, at any published size: its
    image_hw a pair of positive multiples of 32 (the model's stride), at
    least 2 views, and its flops_per_map the count at its own image_hw
    (`counts.flops_per_map` scales from there)."""
    hw = config["image_hw"]
    assert len(hw) == 2 and all(
        isinstance(x, int) and x > 0 and x % 32 == 0 for x in hw), hw
    assert config["views"] >= 2
    assert count_flops(config, *hw) == pytest.approx(
        config["flops_per_map"], rel=1e-6)


@pytest.mark.parametrize("c", DOC["configs"], ids=lambda c: c["name"])
def test_flops_per_map(c):
    check_flops_per_map(manifest.read_json(manifest.ROOT / c["file"]))


def test_noise_draws_are_the_models():
    config = manifest.read_json(manifest.HERE / "configs" /
                                "casdiffmvs-dtu.json")
    noise = draw_eval_noise(config["model"], 2, 64, 96,
                            torch.Generator().manual_seed(0))
    assert [n[0].shape for n in noise.values()] == [(2, 16, 24), (2, 32, 48)]


def test_bounds_by_hand():
    # K1 at the sweep, B = 1, 144 x 200, D 48, C 48, G 4, bf16 features
    n, d, h, w, c, g = 1, 48, 144, 200, 48, 4
    nbytes = (g * d * h * w * 4 + 2 * h * w * c * 2 + d * h * w * 4 + 48)
    ops = d * h * w * (20 + 11 * c + g)
    t, by = counts.warp_bound(n, d, h, w, h, w, c, g, 2)
    assert t == pytest.approx(max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    assert by == "operations"
    # K2 at the stage-3 training shape, B = 4, 256 x 320, D 4, C 16
    n, d, h, w, c = 4, 4, 256, 320, 16
    s = n * d * h * w
    nbytes = 4 * (n * g * d * h * w + s) + n * 48 + 2 * (4 * n * h * w * c)
    t, by = counts.bwd_bound(n, d, h, w, h, w, c, g, s, 4 * s, 2)
    assert t == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert by == "bytes"


@pytest.mark.parametrize("name", ["casdiffmvs-dtu", "diffmvs-dtu"])
def test_k2_bound_is_the_bytes(name):
    """At the training shapes, K2's bound without the in-image samples'
    operations is its bytes'."""
    config = manifest.read_json(manifest.HERE / "configs" / f"{name}.json")
    for call in counts.warp_calls(config["model"], 4, (512, 640), 5):
        _, by = counts.bwd_bound(*call[:4], call.h, call.w, call.c, call.g,
                                 0, 0, 2)
        assert by == "bytes"


def test_warp_calls():
    cas = manifest.read_json(manifest.HERE / "configs" / "casdiffmvs-dtu.json")
    dif = manifest.read_json(manifest.HERE / "configs" / "diffmvs-dtu.json")
    assert len(counts.warp_calls(cas["model"], 16, (1152, 1600), 5)) == 28
    assert len(counts.warp_calls(dif["model"], 16, (1152, 1600), 5)) == 20
    assert json.dumps(counts.warp_calls(dif["model"], 1, (1152, 1600), 5)[-1]) \
        == json.dumps([1, 6, 288, 400, 32, 4])


def test_warp_calls_other_views():
    """The Tanks and Temples shape on the cascade: 10 views, 96 coarse
    planes, 1056 x 1920, B = 16."""
    cas = manifest.read_json(manifest.HERE / "configs" / "casdiffmvs-dtu.json")
    model = dict(cas["model"], numdepth_initial=96)
    calls = counts.warp_calls(model, 16, (1056, 1920), 10)
    assert len(calls) == 9 * (1 + 3 + 3)
    assert list(calls[0]) == [16, 96, 132, 240, 48, 4]
    assert list(calls[-1]) == [16, 4, 528, 960, 16, 4]
