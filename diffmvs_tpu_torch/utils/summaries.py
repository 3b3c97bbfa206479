"""Image summaries (the reference's save_images).

Counterpart of diffmvs_tpu/utils/summaries.py: normalized 8-bit PNGs of
the first sample in logdir/images/ and, when a TensorBoard writer is
given, image summaries. The PNG encoder is the standard library's zlib
and struct (no imaging package needed).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

import numpy as np


def _normalize(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros_like(img, dtype=np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] (grey) or [H, W, 3] (RGB) -> an 8-bit PNG file."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png: shape {img.shape} is not [H, W(, 3)]")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + row.tobytes() for row in img)   # filter: none
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def save_images(logdir: str, mode: str, images: Dict, step: int,
                tb=None) -> None:
    """images: {name: [B, H, W] or [B, H, W, C]} arrays or tensors; saves
    the first sample."""
    outdir = os.path.join(logdir, "images")
    os.makedirs(outdir, exist_ok=True)
    for name, value in images.items():
        if hasattr(value, "detach"):
            value = value.detach().float().cpu().numpy()
        img = np.asarray(value)
        if img.ndim == 4:
            img = img[0]
        elif img.ndim == 3 and img.shape[0] not in (1, 3):
            img = img[0]
        img = _normalize(np.squeeze(img))
        write_png(os.path.join(outdir, f"{mode}_{name}_{step:08d}.png"), img)
        if tb is not None:
            arr = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
            tb.add_image(f"{mode}/{name}", arr, step)
