"""Eval/inference dataset for dtu / tank / eth3d / general scenes.

Counterpart of diffmvs_tpu/data/mvs.py (the reference's datasets/mvs.py):
fixed per-benchmark sizes (DTU 1600x1152, T&T 1920x1056, ETH3D 1920x1280),
score-filtered pair lists (> 0.1; general: > 0.01), the inverse-depth
linspace, and 4-level projection matrices at x{0.125, 0.25, 0.5, 1}
intrinsics. Samples are numpy (uint8 images); data/pipeline.py batches
them through a torch DataLoader.
"""

from __future__ import annotations

import io
import os
from typing import List, Sequence

import numpy as np
from PIL import Image
from torch.utils.data import Dataset

from diffmvs_tpu_torch.data import native_io
from diffmvs_tpu_torch.data.io import read_cam_file
from diffmvs_tpu_torch.data.resize import resize_image_bilinear

FIXED_WH = {"dtu": (1600, 1152), "tank": (1920, 1056), "eth3d": (1920, 1280)}


def _stage_proj_matrices(proj_matrices: np.ndarray) -> dict:
    """[V,2,4,4] -> per-stage dict with scaled intrinsics (mvs.py:170-185)."""
    out = {}
    for stage, s in (("stage1", 0.125), ("stage2", 0.25),
                     ("stage3", 0.5), ("stage4", 1.0)):
        mats = proj_matrices.copy()
        mats[:, 1, :2, :] = proj_matrices[:, 1, :2, :] * s
        out[stage] = mats
    return out


class MVSDataset(Dataset):
    def __init__(self, datapath, n_views=5, numdepth=384, dataset="dtu",
                 scan: Sequence[str] = ("scan1",), max_h=4800, max_w=6400):
        self.datapath = datapath
        self.dataset = dataset
        self.n_views = n_views
        self.numdepth = numdepth
        self.max_h, self.max_w = max_h, max_w
        self.input_scans = list(scan)
        self.img_wh = FIXED_WH.get(dataset)
        self.cam_folder = "cams" if dataset == "general" else "cams_1"
        self.metas = self._build_metas()

    def _parse_pair(self, path: str, scan: str, thres: float) -> List:
        metas = []
        with open(path) as f:
            num_viewpoint = int(f.readline())
            for _ in range(num_viewpoint):
                ref_view = int(f.readline().rstrip())
                tokens = f.readline().rstrip().split()
                ids = [int(x) for x in tokens[1::2]]
                scores = [float(x) for x in tokens[2::2]]
                src_views = [i for i, s in zip(ids, scores)
                             if s > thres and i != ref_view]
                if src_views:
                    metas.append((scan, ref_view, src_views))
        return metas

    def _build_metas(self) -> List:
        if self.dataset == "general":
            return self._parse_pair(
                os.path.join(self.datapath, "pair.txt"), "", 0.01)
        metas = []
        for scan in self.input_scans:
            metas += self._parse_pair(
                os.path.join(self.datapath, scan, "pair.txt"), scan, 0.1)
        return metas

    def __len__(self):
        return len(self.metas)

    def _scale_adaptive(self, img, intrinsics, base=32):
        """Resize to a multiple of `base` under (max_h, max_w)
        (mvs.py:104-124). img: PIL Image (decoded lazily, resampled in
        uint8 — see resize_image_bilinear)."""
        w, h = img.size
        if h > self.max_h or w > self.max_w:
            scale_h = self.max_h / h
            scale_w = self.max_w / w
            new_w = int(scale_w * w // base * base)
            new_h = int(scale_h * h // base * base)
        else:
            new_w, new_h = int(w // base * base), int(h // base * base)
        intrinsics = intrinsics.copy()
        intrinsics[0, :] *= new_w / w
        intrinsics[1, :] *= new_h / h
        return resize_image_bilinear(img, (new_w, new_h),
                                     dtype=np.uint8), intrinsics

    def _target_wh(self, ow, oh, intr):
        """Per-dataset target size + intrinsics scaling for one image of
        original size (ow, oh) — the sizing math of _scale_adaptive /
        the fixed img_wh path, shared by the PIL and native loaders."""
        if self.dataset != "general":
            nw, nh = self.img_wh
        else:
            base = 32
            if oh > self.max_h or ow > self.max_w:
                nw = int(self.max_w / ow * ow // base * base)
                nh = int(self.max_h / oh * oh // base * base)
            else:
                nw, nh = int(ow // base * base), int(oh // base * base)
        intr = intr.copy()
        intr[0, :] *= nw / ow
        intr[1, :] *= nh / oh
        return nw, nh, intr

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.n_views - 1]

        imgs, proj_matrices = [], []
        depth_values = None
        datas, sizes = [], []          # native batch-decode operands
        for i, vid in enumerate(view_ids):
            base = (self.datapath if self.dataset == "general"
                    else os.path.join(self.datapath, scan))
            img_path = os.path.join(base, f"images/{vid:08d}.jpg")
            npy_path = os.path.join(base, f"images/{vid:08d}.npy")
            intr, extr, depth_min, depth_max = read_cam_file(
                os.path.join(base, self.cam_folder, f"{vid:08d}_cam.txt"))

            if os.path.exists(npy_path):
                # pre-decoded serving cache: uint8 [H, W, 3] already at
                # the eval resolution, the cam file's intrinsics already
                # matching it; no JPEG decode
                img = np.load(npy_path)
                nw, nh, intr = self._target_wh(img.shape[1], img.shape[0],
                                               intr)
                if (nw, nh) != (img.shape[1], img.shape[0]):
                    img = resize_image_bilinear(img, (nw, nh),
                                                dtype=np.uint8)
                imgs.append(img)
                mat = np.zeros((2, 4, 4), dtype=np.float32)
                mat[0] = extr
                mat[1, :3, :3] = intr
                proj_matrices.append(mat)
                if i == 0:
                    depth_values = np.linspace(
                        1.0 / depth_max, 1.0 / depth_min, self.numdepth,
                        dtype=np.float32)
                continue

            data = dims = None
            if native_io.available():
                with open(img_path, "rb") as f:
                    data = f.read()
                dims = native_io.jpeg_dims(data)
            if dims is not None:
                nw, nh, intr = self._target_wh(dims[0], dims[1], intr)
                datas.append(data)
                sizes.append((nw, nh))
                imgs.append(None)      # filled by the batch decode below
            else:
                img = Image.open(img_path)
                nw, nh, intr = self._target_wh(*img.size, intr)
                imgs.append(resize_image_bilinear(img, (nw, nh),
                                                  dtype=np.uint8))

            mat = np.zeros((2, 4, 4), dtype=np.float32)
            mat[0] = extr
            mat[1, :3, :3] = intr
            proj_matrices.append(mat)

            if i == 0:
                depth_values = np.linspace(
                    1.0 / depth_max, 1.0 / depth_min, self.numdepth,
                    dtype=np.float32)

        if datas:
            # GIL-free threaded decode + resize (bit-equal to the PIL
            # path, native/jpeg_loader.cpp); PIL where it fails
            decoded = native_io.decode_resize_batch(datas, sizes)
            if decoded is None:
                decoded = [resize_image_bilinear(
                    Image.open(io.BytesIO(d)), s, dtype=np.uint8)
                    for d, s in zip(datas, sizes)]
            it = iter(decoded)
            imgs = [next(it) if im is None else im for im in imgs]

        name_scan = scan + "/" if self.dataset != "general" else ""
        return {
            "imgs": np.stack(imgs),                       # [V, H, W, 3]
            "proj_matrices": _stage_proj_matrices(np.stack(proj_matrices)),
            "depth_values": depth_values,
            "filename": name_scan + "{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
