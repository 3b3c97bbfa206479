"""Byte-compatible file codecs: PFM, cam.txt, pair.txt, mask PNG.

Counterpart of diffmvs_tpu/data/io.py (the reference's datasets/data_io.py
codecs). The files written are byte-identical to the JAX package's, so
either package's fusion and evaluation can read the other's exports.
"""

from __future__ import annotations

import re
import sys
from typing import List, Tuple

import numpy as np
from PIL import Image


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def read_pfm(filename: str) -> Tuple[np.ndarray, float]:
    """Returns (data flipped to top-down, scale)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{filename}: not a PFM file")

        dim_match = re.match(r"^(\d+)\s(\d+)\s$",
                             f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = map(int, dim_match.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype.name != "float32":
        raise ValueError("PFM image dtype must be float32")
    image = np.flipud(image)

    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxWx3, HxWx1 or HxW")

    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale:f}\n".encode())
        # flipud is a negative-stride view, which tofile would write one
        # element at a time (108 ms for a 1152x1600 map on the H100 host,
        # PERF.md); the contiguous copy writes the same bytes in one go
        np.ascontiguousarray(image).tofile(f)


# ---------------------------------------------------------------------------
# cam.txt
# ---------------------------------------------------------------------------

def write_cam(filename: str, cam: np.ndarray, depth_max: float,
              depth_min: float) -> None:
    """cam: [2,4,4] (extrinsic, intrinsic). NB the reference stores the depth
    range line as 'depth_max depth_min' (data_io.py:139) — preserved here for
    byte compatibility; read_camera_parameters swaps it back."""
    with open(filename, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0][i][j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1][i][j]) for j in range(3)) + " \n")
        f.write(f"\n{depth_max} {depth_min}\n")


def read_cam_file(filename: str):
    """Standard MVSNet cam.txt: returns (intrinsics 3x3, extrinsics 4x4,
    depth_min, depth_max) with the dataset-side 'min max' line order
    (datasets/mvs.py:79-91)."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                               sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                               sep=" ").reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    depth_max = float(lines[11].split()[-1])
    if depth_min < 0:
        depth_min = 1.0
    return intrinsics, extrinsics, depth_min, depth_max


def read_camera_parameters(filename: str):
    """Fusion-side reader of write_cam outputs: returns (intrinsics,
    extrinsics, depth_max, depth_min) with the swapped line order and the
    hardcoded DTU range clamp (data_io.py:143-159)."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                               sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                               sep=" ").reshape(3, 3)
    depth_min = float(lines[11].split()[1])
    depth_max = float(lines[11].split()[0])
    if depth_max > 425:  # DTU clamp, data_io.py:156-158
        depth_max = 935
        depth_min = 425
    return intrinsics, extrinsics, depth_max, depth_min


# ---------------------------------------------------------------------------
# pair.txt / masks / images
# ---------------------------------------------------------------------------

def read_pair_file(filename: str, dataset: str = "dtu",
                   score_thres: float = 0.1) -> List[Tuple[int, List[int]]]:
    """Fusion-side pair list; ETH3D applies the score>0.1 filter
    (data_io.py:172-191)."""
    data = []
    with open(filename) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            tokens = f.readline().rstrip().split()
            if dataset != "eth3d":
                src_views = [int(x) for x in tokens[1::2]]
            else:
                ids = [int(x) for x in tokens[1::2]]
                scores = [float(x) for x in tokens[2::2]]
                src_views = [i for i, s in zip(ids, scores)
                             if s > score_thres and i != ref_view]
            if src_views:
                data.append((ref_view, src_views))
    return data


def read_pair_file_scored(filename: str,
                          score_thres: float = 0.1) -> List[Tuple[int, List[int]]]:
    """Dataset-side pair list with score filtering (datasets/mvs.py:47-77)."""
    data = []
    with open(filename) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            tokens = f.readline().rstrip().split()
            ids = [int(x) for x in tokens[1::2]]
            scores = [float(x) for x in tokens[2::2]]
            src_views = [i for i, s in zip(ids, scores)
                         if s > score_thres and i != ref_view]
            if src_views:
                data.append((ref_view, src_views))
    return data


def save_mask(filename: str, mask: np.ndarray) -> None:
    assert mask.dtype == np.bool_
    Image.fromarray(mask.astype(np.uint8) * 255).save(filename)


def read_img(filename: str) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]."""
    return np.array(Image.open(filename), dtype=np.float32) / 255.0


def read_img_u8(filename: str) -> np.ndarray:
    """[H, W, 3] uint8 (datasets emit raw bytes; the model normalizes on
    the device). JPEGs go through the native loader when it is built
    (a bit-identical decode, data/native_io.py); everything else, and
    JPEGs where libjpeg is missing, through PIL."""
    if filename.endswith((".jpg", ".jpeg")):
        from diffmvs_tpu_torch.data import native_io

        if native_io.available():
            with open(filename, "rb") as f:
                data = f.read()
            dims = native_io.jpeg_dims(data)
            if dims is not None:
                out = native_io.decode_resize(data, dims)
                if out is not None:
                    return out
    return np.asarray(Image.open(filename))
