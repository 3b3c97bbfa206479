"""ctypes bindings for the native JPEG decode + resize library.

Counterpart of diffmvs_tpu/data/native_io.py, over the same source,
native/jpeg_loader.cpp: a GIL-free std::thread pool decodes JPEGs with
libjpeg and resamples them with Pillow's BILINEAR arithmetic straight into
numpy buffers, bit-identical to PIL's decode + resize
(tests/test_torch_data.py holds the two equal).

Build: on first use, one g++ process compiles the source into
<repo>/build/diffmvs_tpu_torch/native/<hash>/libdiffmvs_io.so (keyed by a
hash of the source and the flags; the JAX package's native/ directory is
left alone). Where there is no g++ or no libjpeg, the library is not
built and the data layer decodes with PIL, which gives the same pixels: a
host decoder choice, not a device fallback.
`decoder()` says which one runs and `build_error` why the native one
does not.
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
from typing import List, Optional, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "jpeg_loader.cpp"
BUILD_ROOT = REPO / "build" / "diffmvs_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-funroll-loops",
             "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None


def _build() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_ROOT / digest / "libdiffmvs_io.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, lib)          # atomic when two processes build
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        lib.djpeg_dims.restype = ctypes.c_int
        lib.djpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.djpeg_decode_resize.restype = ctypes.c_int
        lib.djpeg_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.djpeg_decode_resize_batch.restype = ctypes.c_int
        lib.djpeg_decode_resize_batch.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """"native" (libjpeg + the Pillow-exact resize) or "pil"."""
    return "native" if available() else "pil"


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.djpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def decode_resize(data: bytes, size_wh: Tuple[int, int]
                  ) -> Optional[np.ndarray]:
    """Decode a JPEG and Pillow-BILINEAR-resize it to (W, H); returns
    [H, W, 3] uint8, or None on failure (the caller decodes with PIL)."""
    lib = _load()
    if lib is None:
        return None
    w, h = int(size_wh[0]), int(size_wh[1])
    out = np.empty((h, w, 3), np.uint8)
    if lib.djpeg_decode_resize(data, len(data), w, h,
                               out.ctypes.data_as(ctypes.c_void_p)):
        return None
    return out


def decode_resize_batch(datas: Sequence[bytes],
                        sizes_wh: Sequence[Tuple[int, int]],
                        nthreads: int = 0) -> Optional[List[np.ndarray]]:
    """Threaded batch decode + resize (the GIL released for the whole
    batch). nthreads=0: one thread per image, at most os.cpu_count()."""
    lib = _load()
    if lib is None:
        return None
    n = len(datas)
    if n == 0:
        return []
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    outs = [np.empty((int(hh), int(ww), 3), np.uint8)
            for ww, hh in sizes_wh]
    arr_d = (ctypes.c_char_p * n)(*datas)
    arr_l = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    arr_w = (ctypes.c_int * n)(*[int(s[0]) for s in sizes_wh])
    arr_h = (ctypes.c_int * n)(*[int(s[1]) for s in sizes_wh])
    arr_o = (ctypes.c_void_p * n)(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
    if lib.djpeg_decode_resize_batch(n, arr_d, arr_l, arr_w, arr_h,
                                     arr_o, nthreads):
        return None
    return outs
