"""Minimal binary PLY writer and reader.

Counterpart of diffmvs_tpu/fusion/ply.py, byte-identical files: vertex
elements with float32 x/y/z and uint8 red/green/blue, binary
little-endian, as the reference's fusion exports them.
"""

from __future__ import annotations

import numpy as np

VERTEX = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
          ("red", "u1"), ("green", "u1"), ("blue", "u1")]


def write_ply(filename: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """xyz: [N, 3] float; rgb: [N, 3] uint8 (or float in [0, 1])."""
    xyz = np.asarray(xyz, dtype="<f4")
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    n = xyz.shape[0]

    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar red\n"
        "property uchar green\n"
        "property uchar blue\n"
        "end_header\n"
    )
    vertex = np.empty(n, dtype=VERTEX)
    vertex["x"], vertex["y"], vertex["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    vertex["red"], vertex["green"], vertex["blue"] = (
        rgb[:, 0], rgb[:, 1], rgb[:, 2])
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        vertex.tofile(f)


def read_ply(filename: str):
    """Read back a PLY written by write_ply: (xyz [N, 3], rgb [N, 3])."""
    with open(filename, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        vertex = np.fromfile(f, dtype=VERTEX, count=n)
    xyz = np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=1)
    rgb = np.stack([vertex["red"], vertex["green"], vertex["blue"]], axis=1)
    return xyz, rgb
