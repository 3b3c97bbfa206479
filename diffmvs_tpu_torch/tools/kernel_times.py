"""K1 and K2 on the card at the main path's and the training cell's
shapes, K3 (with its operands and its entry, warp_corr(...,
batch_rows=False)) at the three DTU shapes, PixelViewWeight's fused
kernel (ops/view_weight.py) at the sweep's shape for B = 16 and B = 1,
FeatureNet's stem kernel (ops/feature_stem.py) over the 80 and 5 images
of B = 16 and B = 1 at 1152x1600, and CostRegNet's prob kernel
(ops/cost_prob.py) at the sweep's shape for B = 16 and B = 1: CUDA-event
times with L2 warm and with L2 flushed, beside each kernel's bound.

    python3 diffmvs_tpu_torch/tools/kernel_times.py [--root DIR] [--dtype bf16]

--dtype is the features' dtype of K2 (f32 by default, the only one a tree
from before K2 read bf16 takes); K1 and K3 are timed in both. --root is
the checkout whose diffmvs_tpu_torch is timed (default: the one
this file belongs to), so that one timing code times two trees in one
call on one card, e.g. an earlier commit unpacked with `git archive`
(each tree builds its own kernels under its own build/). Inputs are made
on the card from fixed seeds, the same for every tree. Prints one JSON
line: the kernel module timed, the card (`nvidia-smi` name and power
limit) and, per kernel and shape, the median ms warm (with and without
the host's launch gap) and L2-cold, and the bound. K3's operands are timed
through the tree's operand kernel, or, in a tree that has none, through
its plain corner_operands (the route is named). PixelViewWeight's four
views are timed through the kernel, beside the module's cuDNN chain view
by view, which is both its plain version (the port's path in training, on
width shards and on the CPU) and the library it replaces at inference:
`plain_ms` and `library_ms` are that one timing. The stem is timed
beside the module chain it replaces (conv0, conv1[0]: cuDNN's bf16
convolutions, BatchNorm, ReLU), again its plain version and the library
(`plain_ms`, `library_ms`), with the kernel's and the bf16 chain's max and
mean abs error against the float32 chain; a tree without the stem kernel
times the chain alone (`"route": "module"`). The prob kernel is timed
beside the module's cuDNN convolution on the same channels-last volume,
again its plain version and the library (`plain_ms`, `library_ms`), with
its max abs error and its largest error in bf16 ulps (`prob_errors`); a
tree without the kernel times the convolution alone. Needs CUDA; fails
without it.

chip_smoke.py takes its timing, bounds and inputs from here too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12       # bf16 on the tensor cores, dense
L2_FLUSH_BYTES = 128 * 2**20   # written between launches: > the 50 MB L2
SPIN_CYCLES = 1_000_000        # ~0.5 ms of clock cycles queued ahead of a
                               # timed call (torch.cuda._sleep)

# name: (stage key, D, C, scale); G = 4 throughout
INFER_SHAPES = {"sweep": ("stage1", 48, 48, 8),
                "stage2": ("stage2", 4, 32, 4),
                "stage3": ("stage3", 4, 16, 2),
                "diffmvs_refine": ("stage2", 6, 32, 4)}
DTU_SHAPES = ("sweep", "stage2", "stage3")
TRAIN_SHAPES = {k: INFER_SHAPES[k] for k in DTU_SHAPES}
INFER_HW, TRAIN_HW, TRAIN_B, VIEWS = (1152, 1600), (512, 640), 4, 5


def cuda_ms(fn, reps=20, warmup=3, cold=False, spin=False):
    """Median CUDA-event time of fn() in ms, inputs warm in L2. The events
    hold the card's time and any gap in which the card waits for the host
    to enqueue fn's launches. With spin=True a spin of SPIN_CYCLES is
    queued before each timed call, so the card has the launches in hand
    when it reaches them: the time is the card's alone. With cold=True L2
    is flushed before each timed call by writing L2_FLUSH_BYTES (outside
    the events), and the spin follows the flush: a cold time is the
    card's alone too."""
    if cold:
        with torch.inference_mode(False):
            flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold:
            flush.fill_(1.0)
        if spin or cold:
            # keep the card busy while the host enqueues the events and
            # fn's launches, so the events time the kernels, not the host
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(fn):
    """{ms, card_ms, cold_ms} of fn(): cuda_ms warm with the host's gap,
    warm without it (spin) and L2-cold (without it too)."""
    return dict(ms=cuda_ms(fn), card_ms=cuda_ms(fn, spin=True),
                cold_ms=cuda_ms(fn, cold=True))


def bound(nbytes, ops, flops=H100_F32_FLOPS):
    """Least time (ms) at the card's memory rate and the operations' rate
    (f32 outside the tensor cores unless `flops` says otherwise), and which
    of the two bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def warp_bound(n, d, h, w, hs, ws, c, g, feat_bytes):
    """K1: each input read once and the output written once, against the
    operations it needs (coordinates ~20 per plane-pixel, 11 per channel
    for the three lerps and the product-accumulate, 1 per group mean)."""
    nbytes = (n * g * d * h * w * 4 + n * h * w * c * feat_bytes
              + n * hs * ws * c * feat_bytes + n * d * h * w * 4 + n * 48)
    return bound(nbytes, n * d * h * w * (20 + 11 * c + g))


def pre_bound(n, d, h, w, hs, ws, c, g, feat_bytes):
    """K3: the output written once and src, ref and the five corner
    operands (int32 xi, yi, f32 fx, fy, a validity byte: 17 bytes per
    plane-pixel) read once, against ~10 operations per plane-pixel, 11 per
    channel (two y-lerps, the x-lerp, the product-accumulate) and 1 per
    group mean."""
    nbytes = (n * g * d * h * w * 4 + n * h * w * c * feat_bytes
              + n * hs * ws * c * feat_bytes + n * d * h * w * 17)
    return bound(nbytes, n * d * h * w * (10 + 11 * c + g))


def operands_bound(n, d, h, w):
    """K3's operand kernel: the depths (4 bytes per plane-pixel) and the
    projection scalars read once, the five operands (17 bytes) written
    once, against ~20 operations per plane-pixel for the coordinates and
    ~10 for the split."""
    return bound(n * d * h * w * 21 + n * 48, n * d * h * w * 30)


def bwd_bound(n, d, h, w, hs, ws, c, g, inside, corners, feat_bytes=4):
    """K2: g, src, ref, depth read once, d_src and d_ref written once (the
    features and their gradients feat_bytes per value), against ~20
    operations per sample for the coordinates, 9 per channel of an
    in-image sample (re-sampling, the d_ref product-accumulate, the
    scatter value) and 2 per channel of an in-image corner (its weight and
    its atomic add)."""
    nbytes = (4 * (n * g * d * h * w + n * d * h * w) + n * 48 + feat_bytes
              * (2 * n * hs * ws * c + 2 * n * h * w * c))
    return bound(nbytes, 20 * n * d * h * w + 9 * c * inside + 2 * c * corners)


def sample_counts(sp, rp, depth, hs, ws, x_off=0):
    """(samples, samples with a corner in the image, in-image corners) of
    one warp call (x_off: a width shard's column offset): the work K2 does
    on these inputs."""
    from diffmvs_tpu_torch.geometry.transforms import relative_projection
    from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
    rot, trans = relative_projection(sp.float(), rp.float())
    x, y = plane_sweep_coords(rot, trans, depth, x_off)
    x0, y0 = x.floor(), y.floor()
    inside = (x0 >= -1) & (x0 <= ws - 1) & (y0 >= -1) & (y0 <= hs - 1)
    vx = (x0 >= 0, x0 <= ws - 2)
    vy = (y0 >= 0, y0 <= hs - 2)
    corners = sum(int((inside & a & b).sum()) for a in vy for b in vx)
    return x.numel(), int(inside.sum()), corners


def k2_global_atomics(sp, rp, depth, hs, ws, c, x_off=0):
    """(128-bit global atomics K2 sends on these inputs, the scalar ones of
    one atomic per channel per in-image corner that the design before it
    sent). K2 (warp_corr_bwd.cu) holds each corner slot's sum in registers
    while a pixel's sample stays on one source pixel from plane to plane,
    and adds it to d_src, C/4 threads one float4 each, when the slot moves
    to another pixel or the planes end: replayed here from the coordinates.
    Assumes the float4 path (C/G % 4 == 0, aligned bases)."""
    from diffmvs_tpu_torch.geometry.transforms import relative_projection
    from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
    rot, trans = relative_projection(sp.float(), rp.float())
    x, y = plane_sweep_coords(rot, trans, depth, x_off)
    x0, y0 = x.floor(), y.floor()
    inside = (x0 >= -1) & (x0 <= ws - 1) & (y0 >= -1) & (y0 <= hs - 1)
    x0 = torch.where(inside, x0, 0.0).long()
    y0 = torch.where(inside, y0, 0.0).long()
    cols = ((x0.clamp_min(0), x0 >= 0),
            ((x0 + 1).clamp_max(ws - 1), x0 <= ws - 2))
    rows = ((y0.clamp_min(0), y0 >= 0),
            ((y0 + 1).clamp_max(hs - 1), y0 <= hs - 2))
    starts = corners = 0
    for yq, vy in rows:
        for xq, vx in cols:
            key = yq * ws + xq
            valid = inside & vy & vx
            held = torch.full_like(key[:, 0], -1)
            for d in range(key.shape[1]):
                start = valid[:, d] & (key[:, d] != held)
                starts += int(start.sum())
                held = torch.where(valid[:, d], key[:, d], held)
            corners += int(valid.sum())
    return starts * (c // 4), corners * c


def pvw_bound(n, d, h, w, g, in_bytes):
    """PixelViewWeight's n volumes [d, h, w, g]: each read once (in_bytes a
    value), the [n, h, w] float32 weights written once, against the two
    convolutions' 2 * 27 * (8 g + 8) operations a voxel (2160 at g = 4;
    BatchNorm, ReLU and the max are ~20 more, not counted)."""
    voxels = n * d * h * w
    return bound(voxels * g * in_bytes + n * h * w * 4,
                 voxels * 2 * 27 * (8 * g + 8))


# PixelViewWeight at the sweep's shape: 4 source views, D = 48, 144x200
# (1152x1600 at 1/8), G = 4; batch sizes timed
PVW_SHAPE = (4, 48, 144, 200, 4)
PVW_BATCHES = (16, 1)


def pvw_module(g, dev, seed=0):
    """An eval-mode PixelViewWeight of the tree imported, with BatchNorm
    statistics and affine terms away from their initial values."""
    from diffmvs_tpu_torch.nn.costreg import PixelViewWeight
    torch.manual_seed(seed)
    m = PixelViewWeight(g)
    bn = m.conv[0].bn
    with torch.no_grad():
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.3, 0.3)
    return m.eval().to(dev)


def pvw_views(cor_feats):
    """The V-1 volumes of cor_feats [V-1, B, D, H, W, G] one by one as the
    warp gives them: [B, D, H, W, G] views of [B, G, D, H, W] buffers."""
    return [c.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
            for c in cor_feats]


def pvw_library(m, cor_list):
    """The module's cuDNN chain over the volumes of pvw_views, view by
    view, as InitialStage ran it before the kernel: [V-1, B, H, W]."""
    return torch.stack([m(c.permute(0, 4, 1, 2, 3)) for c in cor_list])


def time_pvw(res, dev, gen):
    """PixelViewWeight's four views at PVW_SHAPE for each of PVW_BATCHES,
    bf16 and f32 volumes, into res["pvw"]: the kernel's timings, its max
    abs error against the module's chain, the chain's ms, the bound."""
    from diffmvs_tpu_torch.ops import view_weight
    v, d, h, w, g = PVW_SHAPE
    m = pvw_module(g, dev)
    params = view_weight.weights(m)
    for b in PVW_BATCHES:
        x32 = torch.randn((v, b, d, h, w, g), device=dev, generator=gen)
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = x32.to(dt)
            cor_list = pvw_views(x)
            bound_ms, bound_by = pvw_bound(v * b, d, h, w, g,
                                           x.element_size())
            with torch.inference_mode():
                library = timings(lambda: pvw_library(m, cor_list))
                got = view_weight.view_weights(x, *params)
                want = pvw_library(m, cor_list)
                res["pvw"][f"b{b}:{tag}"] = dict(
                    route="kernel",
                    **timings(lambda: view_weight.view_weights(x, *params)),
                    plain_ms=library["card_ms"],
                    library_ms=library["card_ms"],
                    library_cold_ms=library["cold_ms"],
                    max_abs_err=(got - want).abs().max().item(),
                    bound_ms=bound_ms, bound_by=bound_by)
        del x32, x, cor_list


def stem_bound(n, h, w):
    """FeatureNet's stem over n images of h x w: each float32 image read
    once (12 bytes a pixel), conv1[0]'s bf16 activation written once (32
    bytes a half-res pixel), against the three convolutions' operations
    on the tensor cores: 2 * (27 * 8 + 72 * 8) a pixel and 2 * 200 * 16 a
    half-res pixel (3184 a pixel; BatchNorm and ReLU not counted)."""
    ho, wo = (h + 1) // 2, (w + 1) // 2
    return bound(n * h * w * 12 + n * ho * wo * 32,
                 n * (h * w * 2 * (27 + 72) * 8 + ho * wo * 2 * 200 * 16),
                 H100_BF16_FLOPS)


# FeatureNet's stem: the images of B = 16 and B = 1 view-sets of 5 views
# at DTU's size
STEM_IMAGES = (80, 5)
STEM_HW = (1152, 1600)


def stem_net(dev, seed=0, dtype=torch.bfloat16):
    """An eval-mode FeatureNet of the tree imported computing in dtype,
    its stem's BatchNorm statistics and affine terms away from their
    initial values."""
    from diffmvs_tpu_torch.nn.feature import FeatureNet
    torch.manual_seed(seed)
    net = FeatureNet(dtype=dtype)
    with torch.no_grad():
        for b in (net.conv0[0], net.conv0[1], net.conv1[0]):
            b.bn.running_mean.uniform_(-0.5, 0.5)
            b.bn.running_var.uniform_(0.5, 2.0)
            b.bn.weight.uniform_(0.5, 1.5)
            b.bn.bias.uniform_(-0.3, 0.3)
    return net.eval().to(dev)


def stem_images(n, h, w, dev, gen):
    """n images in [0, 1) as FeatureNet gets them from the model: the
    channels-last float32 view [n, 3, h, w] of [n, h, w, 3]."""
    return torch.rand((n, h, w, 3), device=dev,
                      generator=gen).permute(0, 3, 1, 2)


def stem_chain(net, x):
    """The module chain of the stem: conv0, then conv1[0]."""
    return net.conv1[0](net.conv0(x))


def stem_errors(net, x, got):
    """{max_abs_err, mean_abs_err} of got, and the bf16 module chain's
    own (`module_*`), against the float32 chain of net's weights (a float32
    twin; TF32 off is the caller's)."""
    twin = stem_net(x.device, dtype=torch.float32)
    twin.load_state_dict(net.state_dict())
    with torch.inference_mode():
        want = stem_chain(twin, x)
        err = (got.float() - want).abs()
        mod = (stem_chain(net, x).float() - want).abs()
    return dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                module_max_abs_err=mod.max().item(),
                module_mean_abs_err=mod.mean().item())


def time_stem(res, dev, gen):
    """FeatureNet's stem over STEM_IMAGES images of STEM_HW, into
    res["stem"]: the kernel's timings and errors, the module chain's ms,
    the bound; a tree without the kernel: the chain's timings."""
    h, w = STEM_HW
    net = stem_net(dev)
    try:
        from diffmvs_tpu_torch.ops import feature_stem
    except ImportError:
        feature_stem = None
    for n in STEM_IMAGES:
        x = stem_images(n, h, w, dev, gen)
        bound_ms, bound_by = stem_bound(n, h, w)
        with torch.inference_mode():
            library = timings(lambda: stem_chain(net, x))
            row = dict(route="module", **library)
            if feature_stem is not None:
                layers = feature_stem.params(net)
                got = feature_stem.stem(x, layers)
                row = dict(route="kernel",
                           **timings(lambda: feature_stem.stem(x, layers)),
                           **stem_errors(net, x, got),
                           strides_equal=(got.stride()
                                          == stem_chain(net, x).stride()))
        res["stem"][f"n{n}:bf16"] = dict(
            **row, plain_ms=library["card_ms"],
            library_ms=library["card_ms"],
            library_cold_ms=library["cold_ms"],
            bound_ms=bound_ms, bound_by=bound_by)
        del x


def prob_bound(n, d, h, w, in_bytes):
    """CostRegNet's prob convolution over n volumes [8, d, h, w]: each
    read once and the [n, d, h, w] logits written once (in_bytes a value),
    against 2 * 27 * 8 = 432 operations a voxel on the FP32 pipes."""
    voxels = n * d * h * w
    return bound(voxels * 9 * in_bytes, voxels * 2 * 27 * 8)


# CostRegNet's prob layer at the sweep's shape: D = 48, 144x200 (1152x1600
# at 1/8); batch sizes timed
PROB_SHAPE = (48, 144, 200)
PROB_BATCHES = (16, 1)
# the bf16 check: one bf16 ulp of the module's value, or of this magnitude
# near zero, where the two float32 sums' own difference (~1e-7) spans
# several ulps of the value
PROB_ULP_FLOOR = 2.0 ** -10


def prob_module(dev, dtype=torch.bfloat16, seed=0):
    """CostRegNet's prob layer of the tree imported (a Conv3d 8 -> 1,
    3x3x3, padding 1, no bias, computing in dtype), in eval mode."""
    from diffmvs_tpu_torch.nn.layers import Conv3d
    torch.manual_seed(seed)
    return Conv3d(8, 1, 3, padding=1, bias=False, dtype=dtype).eval().to(dev)


def prob_input(n, d, h, w, dtype, dev, gen):
    """The layer's input as CostRegNet hands it over: [n, 8, d, h, w] in
    dtype with channels-last strides."""
    return torch.randn((n, d, h, w, 8), device=dev, generator=gen).to(
        dtype).permute(0, 4, 1, 2, 3)


def prob_errors(got, want):
    """{max_abs_err, max_ulp_err} of got against want (the module's
    logits): the largest absolute difference, and the largest in bf16 ulps
    of max(|want|, PROB_ULP_FLOOR)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    _, exp = torch.frexp(want.abs().clamp_min(PROB_ULP_FLOOR))
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    return dict(max_abs_err=err.max().item(),
                max_ulp_err=(err / ulp).max().item())


def time_prob(res, dev, gen):
    """CostRegNet's prob layer at PROB_SHAPE for each of PROB_BATCHES, bf16
    and f32, into res["prob"]: the kernel's timings and errors against the
    module, the module's ms, the bound; a tree without the kernel: the
    module's timings."""
    try:
        from diffmvs_tpu_torch.ops import cost_prob
    except ImportError:
        cost_prob = None
    d, h, w = PROB_SHAPE
    for b in PROB_BATCHES:
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            m = prob_module(dev, dt)
            x = prob_input(b, d, h, w, dt, dev, gen)
            bound_ms, bound_by = prob_bound(b, d, h, w, x.element_size())
            with torch.inference_mode():
                library = timings(lambda: m(x))
                row = dict(route="module", **library)
                if cost_prob is not None:
                    got = cost_prob.prob_conv(x, m.weight)
                    row = dict(route="kernel", **timings(
                        lambda: cost_prob.prob_conv(x, m.weight)),
                        **prob_errors(got, m(x)[:, 0]))
            res["prob"][f"b{b}:{tag}"] = dict(
                **row, plain_ms=library["card_ms"],
                library_ms=library["card_ms"],
                library_cold_ms=library["cold_ms"],
                bound_ms=bound_ms, bound_by=bound_by)
            del x


def make_depth(name, n, d, h, w, dev, gen, smooth=False):
    """Sweep planes 4..10 m, or refinement hypotheses 0.05 m apart around
    a depth of 4..10 m drawn per pixel, or with smooth=True, a depth map
    that varies over ~16 pixels as a scene's does (bilinear from a 1/16
    grid); all with degenerate depths (zero, behind the camera, tiny and
    huge) in the first row."""
    if name == "sweep":
        inv = torch.arange(d, device=dev) / (d - 1.0)
        depth = 1.0 / (0.1 + 0.15 * inv)
        depth = depth.reshape(1, d, 1, 1).expand(n, d, h, w).contiguous()
    else:
        if smooth:
            coarse = torch.rand(n, 1, h // 16 + 2, w // 16 + 2, device=dev,
                                generator=gen)
            base = 4.0 + 6.0 * torch.nn.functional.interpolate(
                coarse, size=(h, w), mode="bilinear", align_corners=True)
        else:
            base = 4.0 + 6.0 * torch.rand(n, 1, h, w, device=dev,
                                          generator=gen)
        offs = (torch.arange(d, device=dev) - d / 2) * 0.05
        depth = (base + offs.reshape(1, d, 1, 1)).contiguous()
    depth[:, :, 0, :4] = torch.tensor([0.0, -5.0, 1e-30, 1e30], device=dev)
    return depth


def shape_inputs(name, n, hw, dev, gen, smooth=False):
    """(src/ref projection pairs of the widest baseline, depths, D, C,
    h, w) of one shape of INFER_SHAPES at image size hw."""
    from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs
    stage, d, c, s = INFER_SHAPES[name]
    h, w = hw[0] // s, hw[1] // s
    _, projs, _ = synthetic_inputs(n, VIEWS, hw[0], hw[1], 384)
    pairs = torch.from_numpy(projs[stage]).to(dev)
    depth = make_depth(name, n, d, h, w, dev, gen, smooth)
    return pairs[:, VIEWS - 1], pairs[:, 0], depth, d, c, h, w


def time_k3(warp_corr, res, dev, gen):
    """K3 (launch_pre on the plain operands), its operands and its entry
    warp_corr(..., batch_rows=False) at the DTU shapes, f32 and bf16,
    random and (refinement stages) smooth depths, into res["k3"] and
    res["k3_operands"]; the projection scalars of one call (the tree's
    projection kernel, or projection_scalars) into res["k3_projection"]."""
    kernel = getattr(warp_corr, "launch_operands", None)
    projection = getattr(warp_corr, "launch_projection", None)
    cases = [(name, False) for name in DTU_SHAPES] + [
        (name, True) for name in DTU_SHAPES if name != "sweep"]
    for name, smooth in cases:
        sp, rp, depth, d, c, h, w = shape_inputs(name, 1, INFER_HW, dev, gen,
                                                 smooth)
        src32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        tag = name + (":smooth" if smooth else "")
        if name == "sweep":
            res["k3_projection"] = dict(
                **timings(lambda: (projection or warp_corr.projection_scalars)
                          (sp, rp)),
                route="kernel" if projection is not None else "plain")
        with torch.inference_mode():
            ops = warp_corr.corner_operands(src32, sp, rp, depth)
            if kernel is not None:
                rt = warp_corr.projection_scalars(sp, rp)
                times = timings(lambda: kernel(rt, depth, h, w))
            else:
                times = timings(lambda: warp_corr.corner_operands(
                    src32, sp, rp, depth))
            res["k3_operands"][tag] = dict(
                **times, bound_ms=operands_bound(1, d, h, w)[0],
                route="kernel" if kernel is not None else "plain")
            for dt, dtag in ((torch.float32, "f32"),
                             (torch.bfloat16, "bf16")):
                src, ref = src32.to(dt), ref32.to(dt)
                times = timings(lambda: warp_corr.launch_pre(src, ref, *ops,
                                                             4))
                entry = timings(lambda: warp_corr.warp_corr(
                    src, ref, sp, rp, depth, 4, batch_rows=False))
                b, _ = pre_bound(1, d, h, w, h, w, c, 4, src.element_size())
                res["k3"][f"{tag}:{dtag}"] = dict(**times, bound_ms=b,
                                                  entry=entry)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="K2's feature dtype")
    args = ap.parse_args(argv)
    k2_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from diffmvs_tpu_torch.ops import warp_corr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False   # the port's float32 convs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    warp_corr.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"module": warp_corr.__file__, "smi": smi, "k2_dtype": args.dtype,
           "k1": {}, "k2": {}, "k3": {}, "k3_operands": {}, "pvw": {},
           "stem": {}, "prob": {}}
    # the refinement shapes also with smooth depth maps (make_depth)
    cases = [(name, False) for name in INFER_SHAPES] + [
        (name, True) for name in INFER_SHAPES if name != "sweep"]
    for name, smooth in cases:
        sp, rp, depth, d, c, h, w = shape_inputs(name, 1, INFER_HW, dev, gen,
                                                 smooth)
        rt = warp_corr.projection_scalars(sp, rp)
        src32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        ref32 = torch.randn(1, h, w, c, device=dev, generator=gen)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            src, ref = src32.to(dt), ref32.to(dt)
            with torch.inference_mode():
                times = timings(lambda: warp_corr.warp_corr_rt(
                    src, ref, rt, depth, 4))
            b, _ = warp_bound(1, d, h, w, h, w, c, 4, src.element_size())
            key = f"{name}{':smooth' if smooth else ''}:{tag}"
            res["k1"][key] = dict(**times, bound_ms=b)
    cases = [(name, False) for name in TRAIN_SHAPES] + [
        (name, True) for name in TRAIN_SHAPES if name != "sweep"]
    for name, smooth in cases:
        sp, rp, depth, d, c, h, w = shape_inputs(name, TRAIN_B, TRAIN_HW,
                                                 dev, gen, smooth)
        rt = warp_corr.projection_scalars(sp, rp)
        src = torch.randn(TRAIN_B, h, w, c, device=dev, generator=gen)
        ref = torch.randn(TRAIN_B, h, w, c, device=dev, generator=gen)
        g = torch.randn(TRAIN_B, 4, d, h, w, device=dev, generator=gen)
        src, ref = src.to(k2_dtype), ref.to(k2_dtype)
        times = timings(lambda: warp_corr.warp_corr_backward(
            src, ref, rt, depth, g, 4))
        _, inside, corners = sample_counts(sp, rp, depth, h, w)
        b, _ = bwd_bound(TRAIN_B, d, h, w, h, w, c, 4, inside, corners,
                         src.element_size())
        res["k2"][name + (":smooth" if smooth else "")] = dict(
            **times, bound_ms=b)
    time_k3(warp_corr, res, dev, gen)
    time_pvw(res, dev, gen)
    time_stem(res, dev, gen)
    time_prob(res, dev, gen)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
