"""The build, load and launch of the port's hand-written CUDA kernels.

Every ops/csrc/*.cu is one library with a plain C interface, named after
its file stem (lib<stem>.so); every ops/csrc/*.cuh is a header they may
include. build() compiles each source that this set of sources and flags
has no library for yet into <repo>/build/diffmvs_tpu_torch/<hash>/ (one
nvcc process per source, started together), keyed by a hash of every
source, header and flag; a process runs it once, at its set-up or on its
first CUDA call. function() loads a library with ctypes and binds one of
its symbols; launch() calls it on a device's current stream. Nothing is built or
loaded when this module is imported, so it imports on hosts without nvcc
or a card.

A kernel module (ops/warp_corr.py, ops/view_weight.py, ops/feature_stem.py,
ops/cost_prob.py) checks its operands, takes their card from device(), and
launches through function() and launch(). A new kernel is a .cu file in
ops/csrc/ and such a module; nothing here changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from diffmvs_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "diffmvs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the dtype argument of the kernels that read float32 or bfloat16 operands
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# function()'s argument codes: C int, C float, pointer (a data_ptr)
ARG_TYPES = {"i": ctypes.c_int, "f": ctypes.c_float, "p": ctypes.c_void_p}

_built = None           # build()'s {library: path}, kept for function()
_bound = {}             # (library, symbol) -> the bound ctypes function
_libs = {}              # library -> ctypes.CDLL
_lock = threading.Lock()


def sources() -> dict:
    """{library name: its .cu source}, one per file of ops/csrc/."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def headers() -> list:
    """The headers of ops/csrc/, part of the build's key."""
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("native: nvcc not found (set CUDA_HOME)")
    return found


def build() -> dict:
    """Compile the kernels that this source + flags has no library for yet.

    Returns {name: path of the shared library}. The nvcc processes run
    side by side; each one's -Xptxas -v report (registers, spills) is kept
    beside its library as <name>.log. Runs in a "warp_corr.build" span,
    counting the libraries compiled (build.compiled) and found built
    (build.found). function() loads what the last call returned.
    """
    global _built
    with profiling.span("warp_corr.build"):
        _built = _build()
    return _built


def _build() -> dict:
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (*srcs.values(), *headers()):
        digest.update(path.name.encode() + path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    libs = {name: out_dir / f"lib{name}.so" for name in srcs}
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(srcs[name])]
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
        raise RuntimeError("native: nvcc failed: " + "\n".join(failed))
    return libs


def function(name: str, symbol: str, argtypes: str):
    """`symbol` of library `name` (ops/csrc/<name>.cu), which returns a
    cudaError and takes the arguments `argtypes` codes (ARG_TYPES), then
    the stream launch() appends. The library is loaded on the first call
    for it, after one build() if the process has run none."""
    fn = _bound.get((name, symbol))
    if fn is None:
        with _lock:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str((_built or build())[name]))
            fn = getattr(_libs[name], symbol)
            fn.argtypes = [ARG_TYPES[c] for c in argtypes] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _bound[name, symbol] = fn
    return fn


def device(what: str, tensors) -> torch.device:
    """The device of tensors: one CUDA device of compute capability 9.0,
    every tensor contiguous; raises naming the kernel `what` otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{what}: built for sm_90a (H100/H200) only")
    return dev


def launch(what: str, fn, dev: torch.device, *args):
    """fn(*args, stream) on dev's current stream; raises naming the
    kernel `what` when it returns a cudaError."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed, cudaError {err}")
