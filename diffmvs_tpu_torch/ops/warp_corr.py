"""Hand-written CUDA kernels for the fused plane-sweep warp + group
correlation: the forward (K1), its backward (K2), their build and their
binding, and the autograd Function that joins them.

Counterparts of the TPU kernels `_corr_kernel_rowbatch`
(diffmvs_tpu/ops/pallas/warp_corr.py) and `_bwd_kernel`
(diffmvs_tpu/ops/pallas/warp_corr_bwd.py). The sources are
ops/csrc/warp_corr.cu (K1) and ops/csrc/warp_corr_bwd.cu (K2); both
include ops/csrc/warp_geom.cuh, so the backward samples at the forward's
coordinates bit for bit. Their header notes say what bounds them and how
they are laid out.

Build: on the first CUDA call, nvcc compiles each .cu file into a shared
library with a plain C interface under <repo>/build/diffmvs_tpu_torch/
(one nvcc process per source, started together), keyed by a hash of the
sources and the flags, and ctypes loads them. Nothing is built or loaded
when this module is imported, so it imports on hosts without nvcc or a
card.

Gradients: warp_corr() runs K1 inside WarpCorr, a torch.autograd.Function
whose backward launches K2 for the feature gradients and gives the
projections and the depths none (the coordinates are stop-gradient'ed,
as in the reference). K2 takes float32 features only.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from diffmvs_tpu_torch.geometry.transforms import relative_projection

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"warp_corr": CSRC / "warp_corr.cu",          # K1
           "warp_corr_bwd": CSRC / "warp_corr_bwd.cu"}  # K2
HEADERS = (CSRC / "warp_geom.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "diffmvs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launch counters: `launches` counts every K1 launch, `bwd_launches` every
# K2 launch; the Counters split the same launches by (D, H, W, C) shape
launches = 0
launches_by_shape: collections.Counter = collections.Counter()
bwd_launches = 0
bwd_launches_by_shape: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None


def reset_counts():
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0
    launches_by_shape.clear()
    bwd_launches_by_shape.clear()


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
    beside its library as <name>.log.
    """
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (*SOURCES.values(), *HEADERS):
        digest.update(path.name.encode() + path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
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
    global _lib, _bwd_lib
    if _lib is None:
        libs = build()
        fwd = ctypes.CDLL(str(libs["warp_corr"]))
        fwd.warp_corr_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
        fwd.warp_corr_forward.restype = ctypes.c_int
        bwd = ctypes.CDLL(str(libs["warp_corr_bwd"]))
        bwd.warp_corr_backward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        bwd.warp_corr_backward.restype = ctypes.c_int
        _lib, _bwd_lib = fwd, bwd
    return _lib, _bwd_lib


def projection_scalars(src_pair, ref_pair):
    """[N, 12] float32 (rot row-major | trans) of src <- ref, without
    gradient (the coordinates are stop-gradient'ed)."""
    with torch.no_grad():
        rot, trans = relative_projection(src_pair.float(), ref_pair.float())
        n = rot.shape[0]
        return torch.cat([rot.reshape(n, 9), trans.reshape(n, 3)],
                         1).contiguous()


def warp_corr(src_fea, ref_fea, src_pair, ref_pair, depth_values, groups):
    """Kernel launch of warp_and_correlate (CUDA tensors only).

    src_fea [N, Hs, Ws, C], ref_fea [N, H, W, C]: contiguous, float32 or
    bfloat16 (the same for both; float32 where a gradient is needed);
    depth_values [N, D, H, W] contiguous float32; src_pair/ref_pair
    [N, 2, 4, 4].
    Returns [N, D, H, W, G] float32: a view of a contiguous
    [N, G, D, H, W] buffer, differentiable in the two feature maps.
    """
    return warp_corr_rt(src_fea, ref_fea,
                        projection_scalars(src_pair, ref_pair),
                        depth_values, groups)


def warp_corr_rt(src_fea, ref_fea, rt, depth_values, groups):
    """warp_corr with the projection already packed as [N, 12] scalars."""
    _check_forward(src_fea, ref_fea, rt, depth_values, groups)
    if (torch.is_grad_enabled()
            and (src_fea.requires_grad or ref_fea.requires_grad)
            and src_fea.dtype != torch.float32):
        raise TypeError("warp_corr: the backward kernel takes float32 "
                        f"features only, got {src_fea.dtype}")
    return WarpCorr.apply(src_fea, ref_fea, rt, depth_values, groups)


class WarpCorr(torch.autograd.Function):
    """K1 forward, K2 backward. The projections (rt) and the depths get
    no gradient, as the reference computes the coordinates under
    no_grad."""

    @staticmethod
    def forward(ctx, src_fea, ref_fea, rt, depth_values, groups):
        out = _launch_forward(src_fea, ref_fea, rt, depth_values, groups)
        ctx.save_for_backward(src_fea, ref_fea, rt, depth_values)
        ctx.groups = groups
        return out.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, grad_out):
        src_fea, ref_fea, rt, depth_values = ctx.saved_tensors
        g = grad_out.permute(0, 4, 1, 2, 3)     # K1's [N, G, D, H, W] order
        if not g.is_contiguous():
            g = g.contiguous()
        d_src, d_ref = warp_corr_backward(src_fea, ref_fea, rt, depth_values,
                                          g, ctx.groups)
        need_src, need_ref = ctx.needs_input_grad[:2]
        return (d_src if need_src else None, d_ref if need_ref else None,
                None, None, None)


def _check_forward(src_fea, ref_fea, rt, depth_values, groups):
    tensors = (src_fea, ref_fea, rt, depth_values)
    dev = src_fea.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("warp_corr: all tensors must be on one CUDA device")
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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("warp_corr: inputs must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("warp_corr: built for sm_90a (H100/H200) only")


def _launch_forward(src_fea, ref_fea, rt, depth_values, groups):
    """K1: returns the contiguous [N, G, D, H, W] float32 buffer."""
    global launches
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
            out.data_ptr(), n, d, h, w, hs, ws, c, groups, stream)
    if err != 0:
        raise RuntimeError(f"warp_corr: kernel launch failed, cudaError {err}")
    launches += 1
    launches_by_shape[(d, h, w, c)] += 1
    return out


def warp_corr_backward(src_fea, ref_fea, rt, depth_values, g, groups):
    """K2: the feature gradients of warp_corr_rt (CUDA tensors only).

    src_fea, ref_fea, rt, depth_values as for warp_corr_rt, float32
    features; g [N, G, D, H, W] contiguous float32, the cotangent of the
    forward's output in its buffer order.
    Returns (d_src [N, Hs, Ws, C], d_ref [N, H, W, C]) float32.
    """
    global bwd_launches
    _check_forward(src_fea, ref_fea, rt, depth_values, groups)
    if src_fea.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"warp_corr_backward: float32 only, got features "
                        f"{src_fea.dtype}, cotangent {g.dtype}")
    n, hs, ws, c = src_fea.shape
    _, d, h, w = depth_values.shape
    dev = src_fea.device
    if (g.device != dev or tuple(g.shape) != (n, groups, d, h, w)
            or not g.is_contiguous()):
        raise ValueError(f"warp_corr_backward: cotangent {tuple(g.shape)} "
                         f"must be a contiguous [N, G, D, H, W] = "
                         f"{(n, groups, d, h, w)} tensor on {dev}")
    _, lib = _load()
    d_src = torch.zeros_like(src_fea)
    d_ref = torch.empty_like(ref_fea)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.warp_corr_backward(
            src_fea.data_ptr(), ref_fea.data_ptr(), depth_values.data_ptr(),
            rt.data_ptr(), g.data_ptr(), d_src.data_ptr(), d_ref.data_ptr(),
            n, d, h, w, hs, ws, c, groups, stream)
    if err != 0:
        raise RuntimeError(f"warp_corr_backward: kernel launch failed, "
                           f"cudaError {err}")
    bwd_launches += 1
    bwd_launches_by_shape[(d, h, w, c)] += 1
    return d_src, d_ref
