"""The yardstick's arithmetic: the card's published peaks, the least time
of a kernel call from its operations and bytes, the warp kernels' calls
that a configuration's forward or training step needs, and the FLOPs of
a depth map.

The bound functions are copies of the port's tools/kernel_times.py
(`bound`, `warp_bound`, `bwd_bound`) as they stood when the benchmark was
written: each input byte read once and each output byte written once,
against the card's memory rate and float32 rate. Kept here so that the
yardstick does not move when the program does.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
H100_BYTES_PER_S = 3.35e12      # HBM3
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bfloat16 on the tensor cores, dense


def bound(nbytes, ops):
    """Least time (ms) at the card's memory rate and f32 rate, and which
    of the two bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def warp_bound(n, d, h, w, hs, ws, c, g, feat_bytes):
    """K1 (warp + group correlation, forward): each input read once and
    the output written once, against the operations it needs
    (coordinates ~20 per plane-pixel, 11 per channel for the three lerps
    and the product-accumulate, 1 per group mean)."""
    nbytes = (n * g * d * h * w * 4 + n * h * w * c * feat_bytes
              + n * hs * ws * c * feat_bytes + n * d * h * w * 4 + n * 48)
    return bound(nbytes, n * d * h * w * (20 + 11 * c + g))


def bwd_bound(n, d, h, w, hs, ws, c, g, inside, corners, feat_bytes=4):
    """K2 (its backward): g, src, ref, depth read once, d_src and d_ref
    written once (the features and their gradients feat_bytes per value),
    against ~20 operations per sample for the coordinates, 9 per channel
    of an in-image sample and 2 per channel of an in-image corner."""
    nbytes = (4 * (n * g * d * h * w + n * d * h * w) + n * 48 + feat_bytes
              * (2 * n * hs * ws * c + 2 * n * h * w * c))
    return bound(nbytes, 20 * n * d * h * w + 9 * c * inside + 2 * c * corners)


class WarpCall(NamedTuple):
    """One warp call: batch, planes, map height and width (source maps
    are as large), channels, groups."""
    n: int
    d: int
    h: int
    w: int
    c: int
    g: int


def feat_dims(model: Dict):
    """Feature channels per stage: the cascade's (48, 32, 16), DiffMVS's
    (48, 32, 0)."""
    return (48, 32, 16) if model["stage_iters"][2] else (48, 32, 0)


def warp_calls(model: Dict, n: int, hw, views: int) -> List[WarpCall]:
    """The warp calls of one forward of `model` on n view-sets of hw:
    the sweep's views - 1 at 1/8 resolution, then per refinement stage
    s, each DDIM time pair's iterations times views - 1 at 1/2^(3-s)."""
    feat = feat_dims(model)
    h, w = hw
    calls = [WarpCall(n, model["numdepth_initial"], h // 8, w // 8, feat[0],
                      model["cost_dim_stage"][0])] * (views - 1)
    for s in (1, 2):
        it = model["stage_iters"][s]
        if not it:
            continue
        f = 2 ** (3 - s)
        calls += [WarpCall(n, model["cost_num"][s], h // f, w // f, feat[s],
                           model["cost_dim_stage"][s])] * (
            it * model["sampling_timesteps"][s] * (views - 1))
    return calls


def feat_bytes(model: Dict) -> int:
    return 2 if model["compute_dtype"] == "bfloat16" else 4


def k1_bound_ms(model: Dict, n: int, hw, views: int) -> float:
    """Least card time (ms) of the warp forwards one forward needs."""
    fb = feat_bytes(model)
    return sum(warp_bound(c.n, c.d, c.h, c.w, c.h, c.w, c.c, c.g, fb)[0]
               for c in warp_calls(model, n, hw, views))


def k2_bound_ms(model: Dict, n: int, hw, views: int) -> float:
    """Least card time (ms) of the warp backwards one training step needs
    (one per warp call of the training forward, which has the export
    forward's calls). How many samples land in the image depends on the
    depths the model proposes, which the harness does not see, so their
    operations are left out: the bound is then the bytes' at the
    training shapes (test_mvsbench_counts), never above the true least
    time, and the share is never counted too high."""
    fb = feat_bytes(model)
    return sum(bwd_bound(c.n, c.d, c.h, c.w, c.h, c.w, c.c, c.g, 0, 0,
                         fb)[0]
               for c in warp_calls(model, n, hw, views))


def flops_per_map(config: Dict, hw) -> float:
    """The FLOPs of one depth map of hw, from the configuration file's
    count at its own image size (convolutions scale with the pixels)."""
    h0, w0 = config["image_hw"]
    return config["flops_per_map"] * (hw[0] * hw[1]) / (h0 * w0)
