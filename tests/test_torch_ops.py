"""PyTorch port: geometry, ops and the warp kernel's module against JAX.

Same numpy inputs through the JAX function and its port counterpart on
the CPU (the port's plain paths). Tolerances:
  * coordinates rtol 1e-6 / atol 1e-4 px, the rest rtol 1e-5 / atol 1e-6:
    the same float32 ops in the same order, only FMA contraction on the
    XLA side may differ;
  * warp + correlation rtol 1e-4 / atol 1e-5: the Pallas kernel
    interpolates y-then-x, the plain path x-then-y;
  * K3's plain version (batch_rows=False) against the K1 plain path
    rtol 1e-5 / atol 1e-6: the same coordinates, the two interpolation
    orders and sum orders differ only in rounding.
"""

import ast
import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffmvs_tpu.geometry import sampling as jsampling
from diffmvs_tpu.geometry import transforms as jtransforms
from diffmvs_tpu.geometry import upsample as jupsample
from diffmvs_tpu.geometry import warp as jwarp
from diffmvs_tpu.ops import correlation as jcorr
from diffmvs_tpu.ops import softargmax as jsoftargmax
from diffmvs_tpu.ops.pallas.warp_corr import (_corner_split,
                                              warp_corr_miss_fraction,
                                              warp_corr_pallas)

from diffmvs_tpu_torch.geometry import sampling, transforms, upsample, warp
from diffmvs_tpu_torch.ops import correlation, native, softargmax, warp_corr
from diffmvs_tpu_torch.tools import kernel_times
from diffmvs_tpu_torch.utils import profiling

from helpers import make_cams, stage_projs

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-6)
COORD_TOL = dict(rtol=1e-6, atol=1e-4)
CORR_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(rng, n=2, h=64, w=96, stage="stage2"):
    """(src_pair, ref_pair) [n, 2, 4, 4]: the test rig, jittered."""
    cams = stage_projs(make_cams(2, h, w))[stage]
    src = np.repeat(cams[1:2], n, axis=0)
    src[:, 0, :3, 3] += 0.05 * rng.randn(n, 3).astype(np.float32)
    ref = np.repeat(cams[0:1], n, axis=0)
    return src, ref


def test_relative_projection(rng):
    src, ref = _pairs(rng, n=3)
    rot_j, tr_j = jtransforms.relative_projection(src, ref)
    rot_t, tr_t = transforms.relative_projection(T(src), T(ref))
    np.testing.assert_allclose(_np(rot_t), _np(rot_j), **TOL)
    np.testing.assert_allclose(_np(tr_t), _np(tr_j), **TOL)


def test_plane_sweep_coords_with_zero_depth_plane(rng):
    src, ref = _pairs(rng, n=2, h=32, w=48, stage="stage1")
    rot, tr = jtransforms.relative_projection(src, ref)
    rot, tr = np.array(rot), np.array(tr)
    # sample 1: z == 0 everywhere -> the 1e-8 clamp
    rot[1, 2] = 0.0
    tr[1, 2] = 0.0
    depth = (4.0 + 6.0 * rng.rand(2, 5, 4, 6)).astype(np.float32)
    xj, yj = jwarp.plane_sweep_coords(rot, tr, depth)
    xt, yt = warp.plane_sweep_coords(T(rot), T(tr), T(depth))
    np.testing.assert_allclose(_np(xt), _np(xj), **COORD_TOL)
    np.testing.assert_allclose(_np(yt), _np(yj), **COORD_TOL)
    assert np.abs(_np(xt[1])).max() > 1e6          # divided by 1e-8


def test_bilinear_sample_straddles_every_border(rng):
    hs, ws, c = 7, 9, 5
    src = rng.randn(2, hs, ws, c).astype(np.float32)
    # coordinates over [-1.5, size + 0.5]: fully outside, straddling each
    # border and corner, inside, plus exact integer pixel centres
    x = rng.uniform(-1.5, ws + 0.5, (2, 300)).astype(np.float32)
    y = rng.uniform(-1.5, hs + 0.5, (2, 300)).astype(np.float32)
    x[:, :20] = np.arange(-1, 19, dtype=np.float32) / 2.0
    y[:, :20] = np.arange(-1, 19, dtype=np.float32) / 3.0
    want = jsampling.bilinear_sample(src, x, y)
    got = sampling.bilinear_sample(T(src), T(x), T(y))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_upsample_with_mask(rng):
    b, h, w, r = 2, 5, 7, 4
    depth = rng.rand(b, h, w).astype(np.float32)
    logits = rng.randn(b, h, w, 9 * r * r).astype(np.float32)
    want = jupsample.upsample_with_mask(depth, logits, r)
    got = upsample.upsample_with_mask(
        T(depth), T(logits).permute(0, 3, 1, 2), r)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_depth_regression_with_confidence(rng):
    logits = (3.0 * rng.randn(2, 12, 5, 6)).astype(np.float32)
    nj, cj = jsoftargmax.depth_regression_with_confidence(logits)
    nt, ct = softargmax.depth_regression_with_confidence(T(logits))
    np.testing.assert_allclose(_np(nt), _np(nj), **TOL)
    np.testing.assert_allclose(_np(ct), _np(cj), **TOL)


@pytest.mark.parametrize("mode", ["fixed", "confidence", "first_iteration"])
def test_depth_range_samples(rng, mode):
    cur = rng.rand(2, 6, 7).astype(np.float32)
    conf = rng.rand(2, 6, 7).astype(np.float32)
    kw = dict(min_radius=0.125, max_radius=8.0)
    if mode == "fixed":
        want = jtransforms.depth_range_samples(cur, 4, 1 / 96, **kw)
        got = transforms.depth_range_samples(T(cur), 4, 1 / 96, **kw)
    else:
        use = mode == "confidence"
        want = jtransforms.depth_range_samples(
            cur, 4, 1 / 96, conf, use_confidence=jnp.asarray(use), **kw)
        got = transforms.depth_range_samples(
            T(cur), 4, 1 / 96, T(conf), use_confidence=use, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_aggregate_views(rng):
    cor = rng.randn(3, 2, 4, 5, 6, 4).astype(np.float32)
    vw = rng.rand(3, 2, 5, 6).astype(np.float32)
    want = jcorr.aggregate_views(cor, vw)
    got = correlation.aggregate_views(T(cor), T(vw))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _corr_case(rng, case, channels=None):
    """(src, ref, src_pair, ref_pair, depths, window_group) numpy inputs.

    "refine": 48x128, C=16, D=4 banded hypotheses (stage-3 geometry);
    "sweep": 48x100, C=32, a uniform 8-plane sweep (stage-1 geometry);
    `channels` overrides C."""
    if case == "refine":
        hs, ws, c, d, stage, fullmul = 48, 128, 16, 4, "stage3", 2
    else:
        hs, ws, c, d, stage, fullmul = 48, 100, 32, 8, "stage1", 8
    c = channels or c
    projs = stage_projs(make_cams(2, hs * fullmul, ws * fullmul))[stage]
    src = rng.randn(1, hs, ws, c).astype(np.float32)
    ref = rng.randn(1, hs, ws, c).astype(np.float32)
    if case == "refine":
        base = 6.0 + 1.5 * rng.rand(1, 1, hs, ws).astype(np.float32)
        offs = (np.arange(d, dtype=np.float32) - d / 2) * 0.02
        depths = base + offs.reshape(1, d, 1, 1)
        wg = 0
    else:
        sweep = 1.0 / np.linspace(1 / 10.0, 1 / 4.0, d, dtype=np.float32)
        depths = np.broadcast_to(sweep.reshape(1, d, 1, 1), (1, d, hs, ws))
        wg = 4
    return (src, ref, projs[1][None], projs[0][None],
            np.ascontiguousarray(depths, np.float32), wg)


@pytest.mark.parametrize("case", ["refine", "sweep"])
def test_warp_and_correlate_plain_matches_jax(rng, case):
    src, ref, sp, rp, depths, wg = _corr_case(rng, case)
    got = _np(correlation.warp_and_correlate(
        T(src), T(ref), T(sp), T(rp), T(depths), 4))
    want_xla = np.asarray(jax.jit(
        lambda *a: jcorr.warp_and_correlate(*a, 4))(src, ref, sp, rp, depths))
    want_pallas = np.asarray(jax.jit(
        lambda *a: warp_corr_pallas(*a, 4, window_group=wg, interpret=True)
    )(src, ref, sp, rp, depths))
    assert got.shape == want_xla.shape == want_pallas.shape
    np.testing.assert_allclose(got, want_xla, **CORR_TOL)
    np.testing.assert_allclose(got, want_pallas, **CORR_TOL)


def test_warp_and_correlate_takes_plain_path_on_cpu(rng, monkeypatch):
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine")

    def no_kernel(*args, **kwargs):
        raise AssertionError("kernel called for CPU tensors")

    monkeypatch.setattr(warp_corr, "warp_corr", no_kernel)
    before = profiling.counter("warp_corr.k1")
    args = (T(src), T(ref), T(sp), T(rp), T(depths), 4)
    got = correlation.warp_and_correlate(*args)
    want = correlation.warp_and_correlate_plain(*args)
    assert torch.equal(got, want)
    assert profiling.counter("warp_corr.k1") == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine")
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr.warp_corr(T(src), T(ref), T(sp), T(rp), T(depths), 4)


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel modules builds and loads nothing: native builds
    the libraries and loads them on the first CUDA call only."""
    code = ("from diffmvs_tpu_torch.ops import (cost_prob, feature_stem, "
            "native, view_weight, warp_corr); "
            "from diffmvs_tpu_torch.utils import profiling; "
            "assert native._built is None; "
            "assert native._libs == {} and native._bound == {}; "
            "names = ('warp_corr.k1', 'warp_corr.k2', 'warp_corr.k3', "
            "'warp_corr.operands', 'warp_corr.projection', "
            "view_weight.COUNTER, feature_stem.COUNTER, cost_prob.COUNTER, "
            "'build.compiled', 'build.found'); "
            "assert all(profiling.counter(n) == 0 for n in names); "
            "srcs = native.sources(); "
            "assert {'cost_prob', 'feature_stem', 'pixel_view_weight', "
            "'warp_corr', 'warp_corr_bwd', 'warp_corr_pre'} <= set(srcs); "
            "assert all(p.is_file() for p in "
            "(*srcs.values(), *native.headers())); "
            "assert 'warp_geom.cuh' in [p.name for p in native.headers()]")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


@pytest.mark.parametrize("name", sorted(
    p.name for p in native.CSRC.iterdir() if p.suffix in (".cu", ".cuh")))
def test_build_key_covers_every_include(name):
    """native.build() keys its cache on every source and header of
    ops/csrc/: each file there is one of them, and every local header a
    file includes is a header of the key, so an edit to it rebuilds the
    kernels. The warp kernels' sources (K1, K2, K3) include the coordinate
    code they share; the other kernels share none."""
    path = native.CSRC / name
    keyed = {p.name for p in (*native.sources().values(), *native.headers())}
    assert name in keyed
    includes = [line.split('"')[1] for line in path.read_text().splitlines()
                if line.strip().startswith("#include \"")]
    headers = {p.name for p in native.headers()}
    assert all(inc in headers for inc in includes), (name, includes)
    if path.suffix == ".cu" and name.startswith("warp_corr"):
        assert "warp_geom.cuh" in includes, f"{name} includes no shared header"


@pytest.mark.parametrize("module", sorted(
    p.name for p in native.CSRC.parent.glob("*.py")))
def test_only_native_binds_kernels(module):
    """Only ops/native.py imports ctypes, calls CDLL or calls build(); no
    module of ops/ reads another ops module's private names."""
    tree = ast.parse((native.CSRC.parent / module).read_text())
    ops_names = {a.asname or a.name for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)
                 and n.module == "diffmvs_tpu_torch.ops" for a in n.names}
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {
        n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    called = {n.func.id if isinstance(n.func, ast.Name) else n.func.attr
              for n in ast.walk(tree) if isinstance(n, ast.Call)
              and isinstance(n.func, (ast.Name, ast.Attribute))}
    private = [f"{n.value.id}.{n.attr}" for n in ast.walk(tree)
               if isinstance(n, ast.Attribute)
               and isinstance(n.value, ast.Name) and n.value.id in ops_names
               and n.attr.startswith("_") and not n.attr.startswith("__")]
    if module == "native.py":
        assert "ctypes" in imported and {"CDLL", "_build"} <= called
        return
    assert "ctypes" not in imported
    assert not {"CDLL", "build"} & called
    assert not private, private


@pytest.mark.parametrize("devices", [("cpu",), ("cpu", "meta")],
                         ids=["cpu", "cpu_meta"])
def test_native_device_refuses(devices):
    """native.device() takes tensors on one CUDA device only and names the
    kernel when it refuses."""
    tensors = [torch.zeros(2, device=d) for d in devices]
    with pytest.raises(ValueError, match="^some_kernel: .*one CUDA device"):
        native.device("some_kernel", tensors)


@pytest.mark.parametrize("case", ["refine", "sweep"])
def test_k2_atomic_count_replay(rng, case):
    """kernel_times.k2_global_atomics, the count of K2's 128-bit d_src
    atomics that PERF.md reports, against a pixel-by-pixel replay of the
    kernel's hold: each corner slot's sum goes out when the slot's source
    pixel changes, and once at the end."""
    src, _, sp, rp, depths, _ = _corr_case(rng, case)
    _, hs, ws, c = src.shape
    depths = np.ascontiguousarray(depths[:, :, :6, :9])
    v4, scalar = kernel_times.k2_global_atomics(T(sp), T(rp), T(depths), hs,
                                                ws, c)
    rot, trans = transforms.relative_projection(T(sp), T(rp))
    x, y = warp.plane_sweep_coords(rot, trans, T(depths))
    starts = corners = 0
    _, d, h, w = depths.shape
    for i in range(h):
        for j in range(w):
            held = [-1] * 4
            for k in range(d):
                x0 = math.floor(x[0, k, i, j].item())
                y0 = math.floor(y[0, k, i, j].item())
                if not (-1 <= x0 <= ws - 1 and -1 <= y0 <= hs - 1):
                    continue
                for q, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0),
                                              (1, 1))):
                    xq, yq = x0 + dx, y0 + dy
                    if 0 <= xq < ws and 0 <= yq < hs:
                        corners += 1
                        if yq * ws + xq != held[q]:
                            starts += 1
                            held[q] = yq * ws + xq
    assert corners > 0 and starts < corners
    assert (v4, scalar) == (starts * (c // 4), corners * c)


# ---------------------------------------------------------------------------
# K3: warp_corr(..., batch_rows=False) and its plain version
# ---------------------------------------------------------------------------

def test_corner_split_matches_jax(rng):
    hs, ws = 9, 13
    x = rng.uniform(-3.0, ws + 2.0, (2, 3, 5, 7)).astype(np.float32)
    y = rng.uniform(-3.0, hs + 2.0, (2, 3, 5, 7)).astype(np.float32)
    x[0, 0, 0, :4] = [-1.0, -0.5, ws - 1.0, ws - 0.5]   # corner boundaries
    want = [np.asarray(a) for a in _corner_split(x, y, hs, ws)]
    got = [_np(a) for a in warp_corr.corner_split(T(x), T(y), hs, ws)]
    np.testing.assert_array_equal(got[4], want[4])          # validity
    v = want[4]
    assert 0 < v.mean() < 1
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g[v], w[v])


def test_corner_split_decides_validity_before_the_cast():
    x = torch.tensor([[[[float("nan"), float("inf"), -float("inf"),
                         1e30, -1e30, 2.5]]]])
    y = torch.full_like(x, 1.5)
    xi, yi, fx, fy, valid = warp_corr.corner_split(x, y, 4, 6)
    assert valid.tolist() == [[[[False] * 5 + [True]]]]
    assert xi[..., :5].eq(0).all() and fx[..., :5].eq(0).all()
    assert (xi[..., 5].item(), fx[..., 5].item()) == (3, 0.5)


@pytest.mark.parametrize("dtype, packed, channels, groups", [
    ("f32", False, 16, 4), ("bf16", True, 16, 4), ("bf16", None, 24, 8)],
    ids=["f32", "packed_bf16", "bf16"])
def test_k3_plain_matches_jax_k3(rng, dtype, packed, channels, groups):
    """K3's plain version against the TPU kernel `_corr_kernel` in
    interpret mode (warp_corr_pallas(batch_rows=False)), on a refinement
    geometry where its windows and bands miss no sample: f32, bf16 in the
    packed mode (channel pairs, even C/G) and bf16 in the default mode at
    C/G = 3. The plain version sums each group in channel order; the
    packed mode's evens + odds differ from that only in rounding."""
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine", channels)
    miss = warp_corr_miss_fraction(src, sp, rp, depths, window_group=0,
                                   tile=64)
    assert float(miss) == 0.0
    if dtype == "bf16":
        src = np.array(jnp.asarray(src, jnp.bfloat16).astype(jnp.float32))
        ref = np.array(jnp.asarray(ref, jnp.bfloat16).astype(jnp.float32))
        jsrc, jref = (jnp.asarray(a, jnp.bfloat16) for a in (src, ref))
        tsrc, tref = (T(a).to(torch.bfloat16) for a in (src, ref))
    else:
        jsrc, jref, tsrc, tref = src, ref, T(src), T(ref)
    want = np.asarray(jax.jit(lambda *a: warp_corr_pallas(
        *a, groups, batch_rows=False, packed=packed, interpret=True))(
            jsrc, jref, sp, rp, depths))
    got = warp_corr.warp_corr(tsrc, tref, T(sp), T(rp), T(depths), groups,
                              batch_rows=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, **CORR_TOL)


@pytest.mark.parametrize("case", ["refine", "sweep"])
def test_k3_plain_matches_k1_plain(rng, case):
    """Same coordinates, K3's interpolation order against K1's plain path,
    with degenerate depths (zero, behind the camera, tiny, huge) in the
    first row: both give zero there."""
    src, ref, sp, rp, depths, _ = _corr_case(rng, case)
    depths = depths.copy()
    depths[:, :, 0, :4] = [0.0, -5.0, 1e-30, 1e30]
    args = (T(src), T(ref), T(sp), T(rp), T(depths), 4)
    got = warp_corr.warp_corr(*args, batch_rows=False)
    want = correlation.warp_and_correlate_plain(*args)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert torch.isfinite(got).all()


def test_k3_plain_gradient_matches_k1_plain(rng):
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine")
    g_out = T(rng.randn(1, 4, 48, 128, 4).astype(np.float32))

    def grads(fn):
        s = T(src).requires_grad_()
        r = T(ref).requires_grad_()
        return torch.autograd.grad(fn(s, r), (s, r), g_out)

    got = grads(lambda s, r: warp_corr.warp_corr(
        s, r, T(sp), T(rp), T(depths), 4, batch_rows=False))
    want = grads(lambda s, r: correlation.warp_and_correlate_plain(
        s, r, T(sp), T(rp), T(depths), 4))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_k3_mode_takes_plain_path_on_cpu(rng, monkeypatch):
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine")

    def no_kernel(*args, **kwargs):
        raise AssertionError("K3 launched for CPU tensors")

    monkeypatch.setattr(warp_corr, "launch_pre", no_kernel)
    monkeypatch.setattr(warp_corr, "warp_corr_rt", no_kernel)
    before = profiling.counter("warp_corr.k3")
    got = warp_corr.warp_corr(T(src), T(ref), T(sp), T(rp), T(depths), 4,
                              batch_rows=False)
    ops = warp_corr.corner_operands(T(src), T(sp), T(rp), T(depths))
    want = correlation.corner_correlate_plain(T(src), T(ref), *ops, 4)
    assert torch.equal(got, want)
    assert profiling.counter("warp_corr.k3") == before


def test_k3_mode_takes_bf16_at_odd_channels_per_group(rng):
    """bf16 features at C/G = 3 through warp_corr(..., batch_rows=False)
    on the CPU: the plain result, the bf16 values summed in f32."""
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine", 24)
    s, r = (T(a).to(torch.bfloat16) for a in (src, ref))
    got = warp_corr.warp_corr(s, r, T(sp), T(rp), T(depths), 8,
                              batch_rows=False)
    ops = warp_corr.corner_operands(s, T(sp), T(rp), T(depths))
    assert got.shape == (1, 4, 48, 128, 8) and got.dtype == torch.float32
    assert torch.equal(got, correlation.corner_correlate_plain(s, r, *ops, 8))
    want = correlation.corner_correlate_plain(s.float(), r.float(), *ops, 8)
    assert torch.equal(got, want)


def test_corner_operands_match_jax(rng):
    """The operand kernel's plain version (from the [N, 12] projection
    scalars) against the JAX package's plane_sweep_coords + _corner_split,
    with degenerate depths in the first row: the same validity, the
    coordinates corner + fraction to COORD_TOL (XLA may contract other
    products on the CPU), zeros where invalid."""
    src, _, sp, rp, depths, _ = _corr_case(rng, "sweep")
    depths = depths.copy()
    depths[:, :, 0, :4] = [0.0, -5.0, 1e-30, 1e30]
    _, hs, ws, _ = src.shape
    rot, trans = jtransforms.relative_projection(sp, rp)
    x, y = jwarp.plane_sweep_coords(rot, trans, depths)
    want = [np.asarray(a) for a in _corner_split(x, y, hs, ws)]
    got = [_np(a) for a in warp_corr.corner_operands(
        T(src), T(sp), T(rp), T(depths))]
    np.testing.assert_array_equal(got[4], want[4])
    v = want[4]
    assert 0 < v.mean() < 1
    for i in (0, 1):
        np.testing.assert_allclose(got[i][v] - 1 + got[i + 2][v],
                                   want[i][v] - 1 + want[i + 2][v],
                                   **COORD_TOL)
    assert not any(g[~v].any() for g in got[:4])


def test_k3_kernel_refuses_cpu_tensors(rng):
    src, ref, sp, rp, depths, _ = _corr_case(rng, "refine")
    ops = warp_corr.corner_operands(T(src), T(sp), T(rp), T(depths))
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr.launch_pre(T(src), T(ref), *ops, 4)


def test_operand_kernel_refuses_cpu_tensors(rng):
    _, _, sp, rp, depths, _ = _corr_case(rng, "refine")
    rt = warp_corr.projection_scalars(T(sp), T(rp))
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr.launch_operands(rt, T(depths), 48, 128)


def test_projection_kernel_refuses_cpu_tensors(rng):
    _, _, sp, rp, _, _ = _corr_case(rng, "refine")
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr.launch_projection(T(sp), T(rp))
