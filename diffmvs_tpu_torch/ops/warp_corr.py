"""Hand-written CUDA kernel for the fused plane-sweep warp + group
correlation (forward), its build and its binding.

Counterpart of diffmvs_tpu/ops/pallas/warp_corr.py (the TPU kernel
`_corr_kernel_rowbatch`). The source is ops/csrc/warp_corr.cu; its header
note says what bounds it and how it is laid out.

Build: on the first CUDA call, nvcc compiles the .cu file into a shared
library with a plain C interface under <repo>/build/diffmvs_tpu_torch/,
keyed by a hash of the source and the flags, and ctypes loads it. Nothing
is built or loaded when this module is imported, so it imports on hosts
without nvcc or a card.

Only for inference: the kernel has no backward yet, and the wrapper raises
if a tensor that needs a gradient reaches it.
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "warp_corr.cu"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "diffmvs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launch counters: `launches` counts every kernel launch; the Counter
# splits the same launches by (D, H, W, C) shape
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reset_counts():
    global launches
    launches = 0
    launches_by_shape.clear()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("warp_corr: nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile the kernel if this source + flags has no library yet.

    Returns the path of the shared library. The compiler's -Xptxas -v
    report (registers, spills) is kept beside it as build.log.
    """
    text = SOURCE.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = BUILD_ROOT / key[:16]
    lib_path = out_dir / "libwarp_corr.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"warp_corr: nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)      # atomic when two processes build at once
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.warp_corr_forward
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def projection_scalars(src_pair, ref_pair):
    """[N, 12] float32 (rot row-major | trans) of src <- ref."""
    rot, trans = relative_projection(src_pair.float(), ref_pair.float())
    n = rot.shape[0]
    return torch.cat([rot.reshape(n, 9), trans.reshape(n, 3)], 1).contiguous()


def warp_corr(src_fea, ref_fea, src_pair, ref_pair, depth_values, groups):
    """Kernel launch of warp_and_correlate (CUDA tensors only).

    src_fea [N, Hs, Ws, C], ref_fea [N, H, W, C]: contiguous, float32 or
    bfloat16 (the same for both); depth_values [N, D, H, W] contiguous
    float32; src_pair/ref_pair [N, 2, 4, 4].
    Returns [N, D, H, W, G] float32: a view of a contiguous
    [N, G, D, H, W] buffer.
    """
    return warp_corr_rt(src_fea, ref_fea,
                        projection_scalars(src_pair, ref_pair),
                        depth_values, groups)


def warp_corr_rt(src_fea, ref_fea, rt, depth_values, groups):
    """warp_corr with the projection already packed as [N, 12] scalars."""
    global launches
    tensors = (src_fea, ref_fea, rt, depth_values)
    dev = src_fea.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("warp_corr: all tensors must be on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("warp_corr: the kernel has no backward; call it "
                           "under torch.no_grad() or inference_mode()")
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

    lib = _load()
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
    return out.permute(0, 2, 3, 4, 1)
