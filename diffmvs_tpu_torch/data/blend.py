"""BlendedMVS / BlendedMVG training dataset.

Counterpart of diffmvs_tpu/data/blend.py, sample for sample: per-scan
cams/pair.txt (views with fewer sources than nviews - 1 are skipped),
`random.sample` of the source views in train mode, uint8 images read by
data/io.read_img_u8, an inverse-depth linspace without its endpoint, the
GT depth pyramid and its mask (GT within [depth_min, depth_max]) at each
scale, and full-resolution intrinsics scaled by x{1/8, 1/4, 1/2, 1}.
"""

from __future__ import annotations

import os
import random
from typing import List

import numpy as np
from torch.utils.data import Dataset

from diffmvs_tpu_torch.data.io import read_img_u8, read_pfm
from diffmvs_tpu_torch.data.resize import multiscale_pyramid


class MVSDataset(Dataset):
    def __init__(self, datapath, listfile, mode="train", nviews=5,
                 ndepths=384):
        self.datapath = datapath
        self.listfile = listfile
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.metas = self._build_list()

    def _build_list(self) -> List:
        with open(self.listfile) as f:
            scans = [line.rstrip() for line in f.readlines()]
        metas = []
        for scan in scans:
            pair_file = os.path.join(self.datapath, scan, "cams/pair.txt")
            with open(pair_file) as f:
                num_viewpoint = int(f.readline())
                for _ in range(num_viewpoint):
                    ref_view = int(f.readline().rstrip())
                    src_views = [int(x) for x in
                                 f.readline().rstrip().split()[1::2]]
                    if len(src_views) < self.nviews - 1:
                        continue
                    metas.append((scan, ref_view, src_views))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, filename):
        with open(filename) as f:
            lines = [line.rstrip() for line in f.readlines()]
        extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                                   sep=" ").reshape(4, 4)
        intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                                   sep=" ").reshape(3, 3)
        depth_min = float(lines[11].split()[0])
        depth_max = float(lines[11].split()[-1])
        return intrinsics, extrinsics, depth_min, depth_max

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        if self.mode == "train":
            src_ids = random.sample(src_views, self.nviews - 1)
        else:
            src_ids = src_views[: self.nviews - 1]
        view_ids = [ref_view] + src_ids

        imgs, proj_matrices = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            img = read_img_u8(os.path.join(
                self.datapath, f"{scan}/blended_images/{vid:0>8}.jpg"))
            intr, extr, depth_min, depth_max = self._read_cam(os.path.join(
                self.datapath, f"{scan}/cams/{vid:0>8}_cam.txt"))

            mat = np.zeros((2, 4, 4), dtype=np.float32)
            mat[0] = extr
            mat[1, :3, :3] = intr
            proj_matrices.append(mat)
            imgs.append(img)

            if i == 0:
                depth_values = np.linspace(
                    1 / depth_max, 1 / depth_min, self.ndepths,
                    endpoint=False).astype(np.float32)
                depth = np.array(read_pfm(os.path.join(
                    self.datapath,
                    f"{scan}/rendered_depth_maps/{vid:0>8}.pfm"))[0],
                    dtype=np.float32)
                depth_ms = multiscale_pyramid(depth)
                mask_ms = {
                    k: ((v >= depth_min) & (v <= depth_max)).astype(
                        np.float32)
                    for k, v in depth_ms.items()
                }

        proj = np.stack(proj_matrices)
        stages = {}
        for stage, s in (("stage1", 1 / 8), ("stage2", 1 / 4),
                         ("stage3", 1 / 2), ("stage4", 1.0)):
            m = proj.copy()
            m[:, 1, :2, :] = proj[:, 1, :2, :] * s
            stages[stage] = m

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": stages,
            "depth": depth_ms,
            "depth_values": depth_values,
            "mask": mask_ms,
        }
