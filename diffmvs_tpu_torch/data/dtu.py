"""DTU training dataset (Yao Yao's preprocessed layout).

Counterpart of diffmvs_tpu/data/dtu.py, sample for sample: the one
Cameras/pair.txt for every scan, 7 light conditions per view in train mode
(light 3 in test mode), `random.sample` of the source views in train mode,
uint8 640x512 images, the 1600x1200 GT depth and visibility mask halved by
nearest resampling and centre-cropped to 640x512, the mask AND the depth
range, 4-scale GT / mask pyramids, the depth range from the cam file with
interval_scale = 1.06 / (ndepths / 192) and an inverse-depth linspace with
its endpoint. The cam files carry 1/4-resolution intrinsics, so the stages
scale them by x{0.5, 1, 2, 4}.
"""

from __future__ import annotations

import os
import random
from typing import List

import numpy as np
from PIL import Image
from torch.utils.data import Dataset

from diffmvs_tpu_torch.data.io import read_pfm
from diffmvs_tpu_torch.data.resize import multiscale_pyramid, resize_nearest


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
            pair_file = os.path.join(self.datapath, "Cameras/pair.txt")
            with open(pair_file) as f:
                num_viewpoint = int(f.readline())
                for _ in range(num_viewpoint):
                    ref_view = int(f.readline().rstrip())
                    src_views = [int(x) for x in
                                 f.readline().rstrip().split()[1::2]]
                    if self.mode == "train":
                        for light_idx in range(7):
                            metas.append((scan, light_idx, ref_view,
                                          src_views))
                    else:
                        metas.append((scan, 3, ref_view, src_views))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, filename):
        """(intrinsics, extrinsics, depth_min, depth_max); the depth line is
        'depth_min interval', the interval scaled to ndepths planes."""
        with open(filename) as f:
            lines = [line.rstrip() for line in f.readlines()]
        extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                                   sep=" ").reshape(4, 4)
        intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                                   sep=" ").reshape(3, 3)
        depth_min = float(lines[11].split()[0])
        interval_scale = 1.06 / (float(self.ndepths) / 192.0)
        depth_interval = float(lines[11].split()[1]) * interval_scale
        depth_max = depth_interval * self.ndepths + depth_min
        return intrinsics, extrinsics, depth_min, depth_max

    @staticmethod
    def _prepare_img(hr_img: np.ndarray) -> np.ndarray:
        """1600x1200 -> 800x600 (nearest) -> centre crop 640x512."""
        h, w = hr_img.shape
        ds = resize_nearest(hr_img, (w // 2, h // 2))
        h, w = ds.shape
        th, tw = 512, 640
        sh, sw = (h - th) // 2, (w - tw) // 2
        return ds[sh:sh + th, sw:sw + tw]

    def _read_depth_mask(self, depth_file, mask_file, depth_min, depth_max):
        depth_hr = np.array(read_pfm(depth_file)[0], dtype=np.float32)
        depth_lr = self._prepare_img(depth_hr)

        mask = np.array(Image.open(mask_file), dtype=np.float32)
        mask = (mask > 10).astype(np.float32)
        mask = self._prepare_img(mask)
        mask = (mask.astype(bool) & (depth_lr >= depth_min)
                & (depth_lr <= depth_max)).astype(np.float32)
        return multiscale_pyramid(depth_lr), multiscale_pyramid(mask)

    def __getitem__(self, idx):
        scan, light_idx, ref_view, src_views = self.metas[idx]
        if self.mode == "train":
            src_ids = random.sample(src_views, self.nviews - 1)
        else:
            src_ids = src_views[: self.nviews - 1]
        view_ids = [ref_view] + src_ids

        imgs, proj_matrices = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            img_filename = os.path.join(
                self.datapath,
                f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light_idx}_r5000.png")
            mask_filename = os.path.join(
                self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")
            depth_filename = os.path.join(
                self.datapath, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm")
            cam_filename = os.path.join(
                self.datapath, f"Cameras/train/{vid:0>8}_cam.txt")

            img = np.asarray(Image.open(img_filename))      # raw uint8
            intr, extr, depth_min, depth_max = self._read_cam(cam_filename)

            mat = np.zeros((2, 4, 4), dtype=np.float32)
            mat[0] = extr
            mat[1, :3, :3] = intr
            proj_matrices.append(mat)

            if i == 0:
                depth_ms, mask_ms = self._read_depth_mask(
                    depth_filename, mask_filename, depth_min, depth_max)
                depth_values = np.linspace(1 / depth_max, 1 / depth_min,
                                           self.ndepths, dtype=np.float32)
            imgs.append(img)

        proj = np.stack(proj_matrices)
        stages = {}
        for stage, s in (("stage1", 0.5), ("stage2", 1.0),
                         ("stage3", 2.0), ("stage4", 4.0)):
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
