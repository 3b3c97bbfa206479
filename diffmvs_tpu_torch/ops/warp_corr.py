"""Hand-written CUDA kernels for the fused plane-sweep warp + group
correlation: the forward (K1), its backward (K2), the forward from
precomputed corner operands (K3), their build and their binding, and the
autograd Functions that join them.

Counterparts of the TPU kernels `_corr_kernel_rowbatch`, `_corr_kernel`
(diffmvs_tpu/ops/pallas/warp_corr.py) and `_bwd_kernel`
(diffmvs_tpu/ops/pallas/warp_corr_bwd.py). The sources are
ops/csrc/warp_corr.cu (K1), ops/csrc/warp_corr_bwd.cu (K2) and
ops/csrc/warp_corr_pre.cu (K3 with its operand and projection kernels);
all include ops/csrc/warp_geom.cuh: K1, K2 and the operand kernel share
its coordinate code, so they sample at the same coordinates bit for bit,
and K1 and K3 are two instantiations of its block-tiled forward. Their
header notes say what bounds them and how they are laid out.

Two modes, as warp_corr_pallas(..., batch_rows=...) has them:
  * batch_rows=True (the model's path): K1 computes the coordinates in the
    kernel from the depths and 12 projection scalars;
  * batch_rows=False: the projection kernel writes the 12 scalars, the
    operand kernel the corners, fractions and validity as [N, D, H, W]
    tensors, and K3 reads them. CPU tensors take the plain versions
    (projection_scalars, corner_operands_rt and
    ops/correlation.corner_correlate_plain).

Build: on the first CUDA call, nvcc compiles each .cu file into a shared
library with a plain C interface under <repo>/build/diffmvs_tpu_torch/
(one nvcc process per source, started together), keyed by a hash of the
sources and the flags, and ctypes loads them. Nothing is built or loaded
when this module is imported, so it imports on hosts without nvcc or a
card.

Width shards (parallel/spatial.py): K1 and K2 take the column offset
x_off of ref's first column; the depths, ref, the output and d_ref are
indexed by the local column x, the coordinates computed at x + x_off,
and src is the full-width source (wider than ref), so K2's d_src comes
out full width.

Gradients: warp_corr() runs K1 inside WarpCorr (K3 inside WarpCorrPre),
torch.autograd.Functions whose backward launches K2 for the feature
gradients and gives the projections, the depths and the corner operands
none (the coordinates are stop-gradient'ed, as in the reference). K2
reads float32 or bfloat16 features, sums in float32 and returns the
gradients in the features' dtype.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from diffmvs_tpu_torch.geometry.transforms import relative_projection
from diffmvs_tpu_torch.geometry.warp import plane_sweep_coords
from diffmvs_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"warp_corr": CSRC / "warp_corr.cu",          # K1
           "warp_corr_bwd": CSRC / "warp_corr_bwd.cu",  # K2
           "warp_corr_pre": CSRC / "warp_corr_pre.cu",  # K3
           # PixelViewWeight's conv stack (ops/view_weight.py)
           "pixel_view_weight": CSRC / "pixel_view_weight.cu",
           # FeatureNet's full-resolution stem (ops/feature_stem.py)
           "feature_stem": CSRC / "feature_stem.cu"}
HEADERS = (CSRC / "warp_geom.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "diffmvs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launch counters, kept in the port's registry (utils/profiling.py) and
# credited to the span that launched: warp_corr.k1 counts every K1 launch,
# .k2 every K2 launch, .k3 every K3 launch, .operands and .projection every
# launch of K3's operand and projection kernels; K1, K2 and K3 also by
# (D, H, W, C) shape. The module's old names read them (__getattr__).
COUNTERS = {"launches": "warp_corr.k1", "bwd_launches": "warp_corr.k2",
            "pre_launches": "warp_corr.k3",
            "operand_launches": "warp_corr.operands",
            "projection_launches": "warp_corr.projection"}
BY_SHAPE = {"launches_by_shape": "warp_corr.k1",
            "bwd_launches_by_shape": "warp_corr.k2",
            "pre_launches_by_shape": "warp_corr.k3"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None
_pre_lib = None


def reset_counts():
    profiling.reset_counters("warp_corr.")


def __getattr__(name):
    """launches, bwd_launches, ... (totals) and launches_by_shape,
    bwd_launches_by_shape, pre_launches_by_shape (Counters), read from the
    registry."""
    if name in COUNTERS:
        return profiling.counter(COUNTERS[name])
    if name in BY_SHAPE:
        return profiling.keyed(BY_SHAPE[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("warp_corr: nvcc not found (set CUDA_HOME)")
    return found


def build() -> dict:
    """Compile the kernels that this source + flags has no library for yet.

    Returns {name: path of the shared library}. The nvcc processes run
    side by side; each one's -Xptxas -v report (registers, spills) is kept
    beside its library as <name>.log. Runs in a "warp_corr.build" span,
    counting the libraries compiled (build.compiled) and found built
    (build.found).
    """
    with profiling.span("warp_corr.build"):
        return _build()


def _build() -> dict:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (*SOURCES.values(), *HEADERS):
        digest.update(path.name.encode() + path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    profiling.count("build.found", len(libs) - len(todo))
    profiling.count("build.compiled", len(todo))
    if not todo:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} ({proc.returncode}):\n{log[-4000:]}")
        else:
            os.replace(tmp, libs[name])   # atomic when two processes build
    if failed:
        raise RuntimeError("warp_corr: nvcc failed: " + "\n".join(failed))
    return libs


def _load():
    """(K1, K2) libraries; K3's comes from _load_pre(). Builds every
    source of SOURCES."""
    global _lib, _bwd_lib
    if _lib is None:
        libs = build()
        fwd = ctypes.CDLL(str(libs["warp_corr"]))
        fwd.warp_corr_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
            + [ctypes.c_void_p])
        fwd.warp_corr_forward.restype = ctypes.c_int
        bwd = ctypes.CDLL(str(libs["warp_corr_bwd"]))
        bwd.warp_corr_backward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_void_p])
        bwd.warp_corr_backward.restype = ctypes.c_int
        _lib, _bwd_lib = fwd, bwd
    return _lib, _bwd_lib


def _load_pre():
    global _pre_lib
    if _pre_lib is None:
        lib = ctypes.CDLL(str(build()["warp_corr_pre"]))
        lib.warp_corr_pre_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
        lib.warp_corr_pre_forward.restype = ctypes.c_int
        lib.warp_corr_operands.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.warp_corr_operands.restype = ctypes.c_int
        lib.warp_corr_projection.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.warp_corr_projection.restype = ctypes.c_int
        _pre_lib = lib
    return _pre_lib


def projection_scalars(src_pair, ref_pair):
    """[N, 12] float32 (rot row-major | trans) of src <- ref, without
    gradient (the coordinates are stop-gradient'ed)."""
    with torch.no_grad():
        rot, trans = relative_projection(src_pair.float(), ref_pair.float())
        n = rot.shape[0]
        return torch.cat([rot.reshape(n, 9), trans.reshape(n, 3)],
                         1).contiguous()


def warp_corr(src_fea, ref_fea, src_pair, ref_pair, depth_values, groups,
              batch_rows: bool = True, x_off: int = 0):
    """Kernel launch of warp_and_correlate.

    src_fea [N, Hs, Ws, C], ref_fea [N, H, W, C]: contiguous, float32 or
    bfloat16 (the same for both);
    depth_values [N, D, H, W] contiguous float32; src_pair/ref_pair
    [N, 2, 4, 4].
    batch_rows=True launches K1 (CUDA tensors only); batch_rows=False goes
    through warp_corr_pre (K3 on CUDA tensors, its plain version on CPU
    tensors), which takes no column offset.
    x_off: the global column of ref's first column (a width shard's
    offset; src is then the full-width source).
    Returns [N, D, H, W, G] float32: a view of a contiguous
    [N, G, D, H, W] buffer, differentiable in the two feature maps.
    """
    if not batch_rows:
        if x_off:
            raise ValueError("warp_corr: batch_rows=False takes no column "
                             "offset")
        return warp_corr_pre(src_fea, ref_fea, src_pair, ref_pair,
                             depth_values, groups)
    return warp_corr_rt(src_fea, ref_fea,
                        projection_scalars(src_pair, ref_pair),
                        depth_values, groups, x_off)


def warp_corr_rt(src_fea, ref_fea, rt, depth_values, groups, x_off=0):
    """warp_corr with the projection already packed as [N, 12] scalars."""
    _check_forward(src_fea, ref_fea, rt, depth_values, groups, x_off)
    return WarpCorr.apply(src_fea, ref_fea, rt, depth_values, groups, x_off)


class WarpCorr(torch.autograd.Function):
    """K1 forward, K2 backward. The projections (rt) and the depths get
    no gradient, as the reference computes the coordinates under
    no_grad."""

    @staticmethod
    def forward(ctx, src_fea, ref_fea, rt, depth_values, groups, x_off=0):
        out = _launch_forward(src_fea, ref_fea, rt, depth_values, groups,
                              x_off)
        ctx.save_for_backward(src_fea, ref_fea, rt, depth_values)
        ctx.groups, ctx.x_off = groups, x_off
        return out.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, grad_out):
        src_fea, ref_fea, rt, depth_values = ctx.saved_tensors
        g = grad_out.permute(0, 4, 1, 2, 3)     # K1's [N, G, D, H, W] order
        if not g.is_contiguous():
            g = g.contiguous()
        d_src, d_ref = warp_corr_backward(src_fea, ref_fea, rt, depth_values,
                                          g, ctx.groups, ctx.x_off)
        need_src, need_ref = ctx.needs_input_grad[:2]
        return (d_src if need_src else None, d_ref if need_ref else None,
                None, None, None, None)


def _check_cuda(what, tensors):
    """The device of tensors: one CUDA device of compute capability 9.0,
    every tensor contiguous; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{what}: built for sm_90a (H100/H200) only")
    return dev


def _check_forward(src_fea, ref_fea, rt, depth_values, groups, x_off=0):
    _check_cuda("warp_corr", (src_fea, ref_fea, rt, depth_values))
    if src_fea.dtype not in _DTYPE_CODE or ref_fea.dtype != src_fea.dtype:
        raise TypeError(f"warp_corr: features must both be float32 or "
                        f"bfloat16, got {src_fea.dtype}/{ref_fea.dtype}")
    if depth_values.dtype != torch.float32 or rt.dtype != torch.float32:
        raise TypeError("warp_corr: depth_values and rt must be float32")
    if src_fea.dim() != 4 or ref_fea.dim() != 4 or depth_values.dim() != 4:
        raise ValueError("warp_corr: expected 4-D features and depths")
    n, hs, ws, c = src_fea.shape
    _, d, h, w = depth_values.shape
    if (tuple(ref_fea.shape) != (n, h, w, c)
            or depth_values.shape[0] != n or tuple(rt.shape) != (n, 12)):
        raise ValueError(
            f"warp_corr: shapes src {tuple(src_fea.shape)} ref "
            f"{tuple(ref_fea.shape)} depth {tuple(depth_values.shape)} "
            f"rt {tuple(rt.shape)} do not agree")
    if groups <= 0 or c % groups != 0 or hs == 0 or ws == 0:
        raise ValueError(f"warp_corr: C={c} not divisible by G={groups} "
                         f"or empty source")
    # K1 and K2 put the sample in a grid dimension of at most 65535 and
    # index a pixel of one map with 32 bits (offsets across samples,
    # planes and channels are 64-bit)
    if n > 65535 or max(h * w, hs * ws) >= 2 ** 31:
        raise ValueError(f"warp_corr: a batch of {n} maps of {h}x{w} "
                         f"(source {hs}x{ws}) exceeds the kernels' limits "
                         f"(65535 samples, 2^31 pixels a map)")
    if not 0 <= x_off < 2 ** 24 - w:
        raise ValueError(f"warp_corr: column offset {x_off} out of range")


def _launch_forward(src_fea, ref_fea, rt, depth_values, groups, x_off=0):
    """K1: returns the contiguous [N, G, D, H, W] float32 buffer."""
    n, hs, ws, c = src_fea.shape
    _, d, h, w = depth_values.shape
    dev = src_fea.device
    lib, _ = _load()
    out = torch.empty((n, groups, d, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.warp_corr_forward(
            _DTYPE_CODE[src_fea.dtype], src_fea.data_ptr(),
            ref_fea.data_ptr(), depth_values.data_ptr(), rt.data_ptr(),
            out.data_ptr(), n, d, h, w, hs, ws, c, groups, x_off, stream)
    if err != 0:
        raise RuntimeError(f"warp_corr: kernel launch failed, cudaError {err}")
    profiling.count("warp_corr.k1", key=(d, h, w, c))
    return out


def warp_corr_backward(src_fea, ref_fea, rt, depth_values, g, groups,
                       x_off=0):
    """K2: the feature gradients of warp_corr_rt (CUDA tensors only).

    src_fea, ref_fea, rt, depth_values, x_off as for warp_corr_rt (float32
    or bfloat16 features, read as they are); g [N, G, D, H, W] contiguous
    float32, the cotangent of the forward's float32 output in its buffer
    order. K2 sums both gradients in float32: d_ref in registers, rounded
    once as it is stored; d_src by atomics into a float32 buffer, rounded
    once here.
    Returns (d_src [N, Hs, Ws, C], d_ref [N, H, W, C]) in the features'
    dtype, as autograd wants them.
    """
    _check_forward(src_fea, ref_fea, rt, depth_values, groups, x_off)
    if g.dtype != torch.float32:
        raise TypeError(f"warp_corr_backward: the cotangent must be "
                        f"float32, got {g.dtype}")
    n, hs, ws, c = src_fea.shape
    _, d, h, w = depth_values.shape
    dev = src_fea.device
    if (g.device != dev or tuple(g.shape) != (n, groups, d, h, w)
            or not g.is_contiguous()):
        raise ValueError(f"warp_corr_backward: cotangent {tuple(g.shape)} "
                         f"must be a contiguous [N, G, D, H, W] = "
                         f"{(n, groups, d, h, w)} tensor on {dev}")
    _, lib = _load()
    d_src = torch.zeros(src_fea.shape, dtype=torch.float32, device=dev)
    d_ref = torch.empty_like(ref_fea)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.warp_corr_backward(
            _DTYPE_CODE[src_fea.dtype], src_fea.data_ptr(),
            ref_fea.data_ptr(), depth_values.data_ptr(), rt.data_ptr(),
            g.data_ptr(), d_src.data_ptr(), d_ref.data_ptr(), n, d, h, w, hs,
            ws, c, groups, x_off, stream)
    if err != 0:
        raise RuntimeError(f"warp_corr_backward: kernel launch failed, "
                           f"cudaError {err}")
    profiling.count("warp_corr.k2", key=(d, h, w, c))
    return d_src.to(src_fea.dtype), d_ref


# ---------------------------------------------------------------------------
# K3: the batch_rows=False mode
# ---------------------------------------------------------------------------

def corner_split(x, y, hs, ws):
    """Integer corners into the 1-padded source, fractions and validity
    (diffmvs_tpu/ops/pallas/warp_corr.py:_corner_split).

    x, y: [N, D, H, W] float32 source coordinates. Returns (xi, yi) int32
    in [0, ws] / [0, hs] (the original x0 + 1, y0 + 1), (fx, fy) float32
    and valid bool (some corner lies in the image), each [N, D, H, W].
    Validity is decided in float before the integer cast, so NaN and huge
    coordinates are invalid; invalid samples carry xi = yi = 0 and zero
    fractions. (JAX's cast saturates, which makes them invalid too, except
    a NaN coordinate, which it turns into corner 0 with a NaN fraction.)
    """
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    valid = (x0 >= -1) & (x0 <= ws - 1) & (y0 >= -1) & (y0 <= hs - 1)
    zero = torch.zeros_like(x)
    fx = torch.where(valid, x - x0, zero)
    fy = torch.where(valid, y - y0, zero)
    xi = torch.where(valid, x0, zero - 1.0).to(torch.int32) + 1
    yi = torch.where(valid, y0, zero - 1.0).to(torch.int32) + 1
    return xi, yi, fx, fy, valid


def corner_operands_rt(rt, depth_values, hs, ws):
    """The operand kernel's plain version: (xi, yi, fx, fy, valid) of one
    source view of hs x ws from the [N, 12] projection scalars and the
    depths [N, D, H, W], without gradient."""
    n = rt.shape[0]
    with torch.no_grad():
        x, y = plane_sweep_coords(rt[:, :9].reshape(n, 3, 3), rt[:, 9:],
                                  depth_values)
        return corner_split(x, y, hs, ws)


def corner_operands(src_fea, src_pair, ref_pair, depth_values):
    """(xi, yi, fx, fy, valid) of one source view, without gradient: the
    operands K3 and its plain version read, computed in plain PyTorch (the
    CPU path, and the oracle of the operand kernel on the card)."""
    return corner_operands_rt(projection_scalars(src_pair, ref_pair),
                              depth_values, src_fea.shape[1],
                              src_fea.shape[2])


def warp_corr_pre(src_fea, ref_fea, src_pair, ref_pair, depth_values,
                  groups):
    """warp_corr(..., batch_rows=False): the corner operands, then K3.

    Same arguments and result as warp_corr. The projection is computed
    once and serves the operands and the backward. On CPU tensors it
    returns the plain versions (projection_scalars, corner_operands_rt,
    then ops/correlation.corner_correlate_plain); on CUDA tensors it
    launches the projection kernel, the operand kernel and K3 (inside
    WarpCorrPre, whose backward is K2) or raises.
    """
    hs, ws = src_fea.shape[1], src_fea.shape[2]
    if src_fea.device.type == "cpu":
        from diffmvs_tpu_torch.ops.correlation import corner_correlate_plain
        rt = projection_scalars(src_pair, ref_pair)
        ops = corner_operands_rt(rt, depth_values, hs, ws)
        return corner_correlate_plain(src_fea, ref_fea, *ops, groups)
    rt = launch_projection(src_pair, ref_pair)
    ops = launch_operands(rt, depth_values, hs, ws)
    return WarpCorrPre.apply(src_fea, ref_fea, *ops, rt, depth_values,
                             groups)


class WarpCorrPre(torch.autograd.Function):
    """K3 forward, K2 backward: K2 is the gradient of the exact forward at
    the coordinates K1 computes, which the operand kernel's operands
    reproduce bit for bit. No gradient for the operands, projections or
    depths."""

    @staticmethod
    def forward(ctx, src_fea, ref_fea, xi, yi, fx, fy, valid, rt,
                depth_values, groups):
        out = launch_pre(src_fea, ref_fea, xi, yi, fx, fy, valid, groups)
        ctx.save_for_backward(src_fea, ref_fea, rt, depth_values)
        ctx.groups, ctx.x_off = groups, 0
        return out.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, grad_out):
        d_src, d_ref, *_ = WarpCorr.backward(ctx, grad_out)
        return (d_src, d_ref) + (None,) * 8


def launch_projection(src_pair, ref_pair):
    """The projection kernel (CUDA tensors only): projection_scalars'
    [N, 12] float32 scalars, bit for bit, in one launch instead of
    relative_projection's chain of about a hundred small ops.
    src_pair/ref_pair [N, 2, 4, 4]."""
    src_pair = src_pair.float().contiguous()
    ref_pair = ref_pair.float().contiguous()
    dev = _check_cuda("warp_corr_projection", (src_pair, ref_pair))
    if (src_pair.dim() != 4 or tuple(src_pair.shape[1:]) != (2, 4, 4)
            or tuple(ref_pair.shape) != tuple(src_pair.shape)):
        raise ValueError(f"warp_corr_projection: pairs "
                         f"{tuple(src_pair.shape)} / {tuple(ref_pair.shape)}"
                         f" are not [N, 2, 4, 4]")
    n = src_pair.shape[0]
    lib = _load_pre()
    rt = torch.empty((n, 12), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.warp_corr_projection(
            src_pair.data_ptr(), ref_pair.data_ptr(), rt.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_corr_projection: kernel launch failed, "
                           f"cudaError {err}")
    profiling.count("warp_corr.projection")
    return rt


def launch_operands(rt, depth_values, hs, ws):
    """The operand kernel (CUDA tensors only): (xi, yi, fx, fy, valid) as
    corner_operands_rt gives them, from rt [N, 12] and depth_values
    [N, D, H, W], contiguous float32, for a source image of hs x ws."""
    dev = _check_cuda("warp_corr_operands", (depth_values, rt))
    if depth_values.dtype != torch.float32 or rt.dtype != torch.float32:
        raise TypeError("warp_corr_operands: depth_values and rt must be "
                        "float32")
    if depth_values.dim() != 4:
        raise ValueError("warp_corr_operands: expected 4-D depths")
    n, d, h, w = depth_values.shape
    if tuple(rt.shape) != (n, 12) or hs <= 0 or ws <= 0:
        raise ValueError(f"warp_corr_operands: rt {tuple(rt.shape)} for "
                         f"depths {tuple(depth_values.shape)}, source "
                         f"{hs}x{ws}")
    lib = _load_pre()
    xi = torch.empty((n, d, h, w), dtype=torch.int32, device=dev)
    yi = torch.empty_like(xi)
    fx = torch.empty((n, d, h, w), dtype=torch.float32, device=dev)
    fy = torch.empty_like(fx)
    valid = torch.empty((n, d, h, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.warp_corr_operands(
            depth_values.data_ptr(), rt.data_ptr(), xi.data_ptr(),
            yi.data_ptr(), fx.data_ptr(), fy.data_ptr(), valid.data_ptr(), n,
            d, h, w, hs, ws, stream)
    if err != 0:
        raise RuntimeError(f"warp_corr_operands: kernel launch failed, "
                           f"cudaError {err}")
    profiling.count("warp_corr.operands")
    return xi, yi, fx, fy, valid


def launch_pre(src_fea, ref_fea, xi, yi, fx, fy, valid, groups):
    """K3 (CUDA tensors only): returns the contiguous [N, G, D, H, W]
    float32 buffer.

    src_fea [N, Hs, Ws, C], ref_fea [N, H, W, C] contiguous float32 or
    bfloat16 (any C/G, any alignment); xi, yi int32, fx, fy float32, valid
    bool, each contiguous [N, D, H, W], as corner_split gives them.
    """
    operands = (xi, yi, fx, fy, valid)
    dev = _check_cuda("warp_corr_pre", (src_fea, ref_fea) + operands)
    if src_fea.dtype not in _DTYPE_CODE or ref_fea.dtype != src_fea.dtype:
        raise TypeError(f"warp_corr_pre: features must both be float32 or "
                        f"bfloat16, got {src_fea.dtype}/{ref_fea.dtype}")
    want = (torch.int32, torch.int32, torch.float32, torch.float32,
            torch.bool)
    if tuple(t.dtype for t in operands) != want:
        raise TypeError("warp_corr_pre: operands must be int32 xi, yi, "
                        "float32 fx, fy and bool valid")
    if src_fea.dim() != 4 or ref_fea.dim() != 4 or xi.dim() != 4:
        raise ValueError("warp_corr_pre: expected 4-D features and operands")
    n, hs, ws, c = src_fea.shape
    _, d, h, w = xi.shape
    if (tuple(ref_fea.shape) != (n, h, w, c)
            or any(tuple(t.shape) != (n, d, h, w) for t in operands)):
        raise ValueError(
            f"warp_corr_pre: shapes src {tuple(src_fea.shape)} ref "
            f"{tuple(ref_fea.shape)} operands {tuple(xi.shape)} do not agree")
    if groups <= 0 or c % groups != 0 or hs == 0 or ws == 0:
        raise ValueError(f"warp_corr_pre: C={c} not divisible by G={groups} "
                         f"or empty source")
    lib = _load_pre()
    out = torch.empty((n, groups, d, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.warp_corr_pre_forward(
            _DTYPE_CODE[src_fea.dtype], src_fea.data_ptr(),
            ref_fea.data_ptr(), xi.data_ptr(), yi.data_ptr(), fx.data_ptr(),
            fy.data_ptr(), valid.data_ptr(), out.data_ptr(), n, d, h, w, hs,
            ws, c, groups, stream)
    if err != 0:
        raise RuntimeError(f"warp_corr_pre: kernel launch failed, cudaError "
                           f"{err}")
    profiling.count("warp_corr.k3", key=(d, h, w, c))
    return out
