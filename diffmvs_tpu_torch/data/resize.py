"""Host-side image/array resizing (counterpart of
diffmvs_tpu/data/resize.py; the reference used cv2: PIL covers the
bilinear image path and nearest resampling is pure indexing).

cv2.INTER_NEAREST parity: cv2 maps destination pixel i to source index
floor(i * src/dst), which is what `_nearest_indices` computes — so GT depth
pyramids match the reference's cv2.resize(..., INTER_NEAREST) exactly for
integer decimation factors.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def resize_image_bilinear(img, size_wh, dtype=np.float32) -> np.ndarray:
    """img: [H, W, 3] float32 in [0,1], uint8, or a PIL Image;
    size_wh: (W, H). Returns float32 in [0,1], or raw uint8 with
    dtype=np.uint8.

    Stays in uint8 through the resample when possible: datasets request
    dtype=np.uint8 and the model normalizes on the device (u8/255 in f32),
    a quarter of the worker-IPC and host-to-device bytes of float32."""
    if isinstance(img, Image.Image):
        pil = img
    elif img.dtype == np.uint8:
        pil = Image.fromarray(img)
    else:
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    if pil.size != tuple(size_wh):
        pil = pil.resize(tuple(size_wh), Image.BILINEAR)
    if dtype == np.uint8:
        return np.asarray(pil)
    return np.asarray(pil, dtype=np.float32) / 255.0


def _nearest_indices(dst: int, src: int) -> np.ndarray:
    return np.minimum((np.arange(dst) * (src / dst)).astype(np.int64),
                      src - 1)


def resize_nearest(arr: np.ndarray, size_wh) -> np.ndarray:
    """Nearest-neighbor resize of [H, W] arrays (GT depth / masks)."""
    w, h = size_wh
    yi = _nearest_indices(h, arr.shape[0])
    xi = _nearest_indices(w, arr.shape[1])
    return arr[yi[:, None], xi[None, :]]


def multiscale_pyramid(arr: np.ndarray) -> dict:
    """stage1..4 pyramid at 1/8, 1/4, 1/2, 1/1 (datasets/dtu.py:101-113)."""
    h, w = arr.shape
    return {
        "stage1": resize_nearest(arr, (w // 8, h // 8)),
        "stage2": resize_nearest(arr, (w // 4, h // 4)),
        "stage3": resize_nearest(arr, (w // 2, h // 2)),
        "stage4": arr,
    }
