"""COLMAP sparse-model ingestion: cams/*_cam.txt + pair.txt + images.

Counterpart of diffmvs_tpu/tools/colmap.py (the reference's
colmap_input.py), whose numpy half is copied here: the text and binary
COLMAP parsers, K from the camera parameters, extrinsics from the
quaternions, the depth range from the 1st-99th percentile of the visible
sparse points' depths, and the MVSNet triangulation-angle view-selection
scores. The --vggt mode scores view pairs by the dot products of the
R2Former descriptors of tools/retrieval.py instead, computed on the card
unless --device cpu is given.

    python -m diffmvs_tpu_torch.tools.colmap --dense_folder scene \
        --save_folder mvs_scene [--model_ext .txt] [--vggt] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import os
import shutil
import struct
from typing import Dict

import numpy as np
import torch

from diffmvs_tpu_torch.api import resolve_device

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5), CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x ** 2 - 2 * z ** 2,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x ** 2 - 2 * y ** 2],
    ])


# ---------------------------------------------------------------------------
# text parsers
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = Camera(
                id=cam_id, model=elems[1], width=int(elems[2]),
                height=int(elems[3]),
                params=np.array(tuple(map(float, elems[4:]))))
    return cameras


def read_images_text(path: str) -> Dict[int, BaseImage]:
    images = {}
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            image_id = int(elems[0])
            qvec = np.array(tuple(map(float, elems[1:5])))
            tvec = np.array(tuple(map(float, elems[5:8])))
            camera_id = int(elems[8])
            name = elems[9]
            elems = f.readline().split()
            xys = np.column_stack([tuple(map(float, elems[0::3])),
                                   tuple(map(float, elems[1::3]))])
            point3D_ids = np.array(tuple(map(int, elems[2::3])))
            images[image_id] = BaseImage(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name, xys=xys, point3D_ids=point3D_ids)
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            xyz = np.array(tuple(map(float, elems[1:4])))
            rgb = np.array(tuple(map(int, elems[4:7])))
            error = float(elems[7])
            image_ids = np.array(tuple(map(int, elems[8::2])))
            point2D_idxs = np.array(tuple(map(int, elems[9::2])))
            points[pid] = Point3D(pid, xyz, rgb, error, image_ids,
                                  point2D_idxs)
    return points


# ---------------------------------------------------------------------------
# binary parsers
# ---------------------------------------------------------------------------

def _read_next_bytes(f, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, f.read(num_bytes))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read_next_bytes(f, 8 * model.num_params,
                                      "d" * model.num_params)
            cameras[cam_id] = Camera(cam_id, model.model_name, width, height,
                                     np.array(params))
    return cameras


def read_images_binary(path: str) -> Dict[int, BaseImage]:
    images = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            num_points = _read_next_bytes(f, 8, "Q")[0]
            data = _read_next_bytes(f, 24 * num_points, "ddq" * num_points)
            xys = np.column_stack([data[0::3], data[1::3]])
            point3D_ids = np.array(data[2::3], dtype=np.int64)
            images[image_id] = BaseImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                xys, point3D_ids)
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 43, "QdddBBBd")
            pid = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            error = props[7]
            track_len = _read_next_bytes(f, 8, "Q")[0]
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  np.array(track[0::2]),
                                  np.array(track[1::2]))
    return points


def read_model(path: str, ext: str = ".bin"):
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras.txt")),
                read_images_text(os.path.join(path, "images.txt")),
                read_points3d_text(os.path.join(path, "points3D.txt")))
    return (read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def intrinsics_from_camera(cam: Camera) -> np.ndarray:
    """K from COLMAP params (colmap_input.py:331-344)."""
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        return np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1]])
    if cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
        return np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
    raise ValueError(f"unsupported camera model {cam.model}")


def triangulation_score(p_world, center_i, center_j, theta0=5.0,
                        sigma1=1.0, sigma2=10.0) -> float:
    """MVSNet view-selection score (colmap_input.py:374-390)."""
    a = p_world - center_i
    b = p_world - center_j
    cos = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-10)
    theta = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    sigma = sigma1 if theta <= theta0 else sigma2
    return float(np.exp(-((theta - theta0) ** 2) / (2 * sigma ** 2)))


def score_pairs(images, points3d, extrinsics, descriptors=None):
    """Pairwise view-selection scores.

    Default: sum of triangulation scores over shared 3D points. If
    `descriptors` ({image_id: unit vector}) is given, uses global-descriptor
    dot products instead (the VGGT/R2Former mode, colmap_input.py:392-395).
    """
    ids = sorted(images.keys())
    n = len(ids)
    score = np.zeros((n, n))
    if descriptors is not None:
        for i in range(n):
            for j in range(i + 1, n):
                s = float(np.dot(descriptors[ids[i]], descriptors[ids[j]]))
                score[i, j] = score[j, i] = s
        return ids, score

    centers = {}
    for idx, iid in enumerate(ids):
        e = extrinsics[iid]
        centers[iid] = -e[:3, :3].T @ e[:3, 3]

    # points seen by each image
    for pid, pt in points3d.items():
        img_list = [i for i in np.unique(pt.image_ids) if i in images]
        for a in range(len(img_list)):
            for b in range(a + 1, len(img_list)):
                i, j = img_list[a], img_list[b]
                s = triangulation_score(pt.xyz, centers[i], centers[j])
                ii, jj = ids.index(i), ids.index(j)
                score[ii, jj] += s
                score[jj, ii] += s
    return ids, score


# ImageNet statistics for the retrieval ViT's input normalization
# (the reference's torchvision Normalize, colmap_input.py:294-329)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def compute_image_descriptors(dense_folder: str, images,
                              checkpoint: str = None, vit_cfg=None,
                              device=None):
    """Encode every sparse-model image into a global descriptor for
    retrieval view selection (the reference's --VGGT mode): resize to the
    ViT input size, ImageNet normalization, the R2Former DeiT-distilled
    ViT, L2-normalized output, on `device` (CUDA unless "cpu" is asked
    for; without a card that raises).

    checkpoint: an R2Former .pth (timm key layout, a "module." prefix
    allowed, a pickle: load only files you trust); random weights from
    seed 0 otherwise. Returns {image_id: [num_classes] unit vector}."""
    from PIL import Image

    from diffmvs_tpu_torch.api import resolve_device, set_f32_precision
    from diffmvs_tpu_torch.tools.retrieval import (DistilledViT, ViTConfig,
                                                   compute_descriptors)

    dev = resolve_device(device)
    set_f32_precision()
    cfg = vit_cfg or ViTConfig()
    ids = sorted(images.keys())
    arrs = []
    for iid in ids:
        path = os.path.join(dense_folder, "images", images[iid].name)
        pil = Image.open(path).convert("RGB").resize(
            (cfg.image_size, cfg.image_size), Image.BILINEAR)
        x = np.asarray(pil, np.float32) / 255.0
        arrs.append((x - IMAGENET_MEAN) / IMAGENET_STD)
    batch_imgs = np.stack(arrs)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DistilledViT(cfg)
    if checkpoint:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
        model.load_state_dict({k.removeprefix("module."): v
                               for k, v in sd.items()}, strict=True)
    desc = compute_descriptors(model.to(dev).eval(), batch_imgs)
    return {iid: desc[i] for i, iid in enumerate(ids)}


def convert(dense_folder: str, save_folder: str, model_ext: str = ".bin",
            num_src: int = 10, descriptors=None, vggt: bool = False,
            retrieval_ckpt: str = None, vit_cfg=None, device=None):
    """COLMAP sparse model -> cams/%08d_cam.txt + pair.txt + images/
    (colmap_input.py:246-452). device: where --vggt's ViT runs."""
    sparse = os.path.join(dense_folder, "sparse")
    if not os.path.isdir(sparse):
        sparse = dense_folder
    cameras, images, points3d = read_model(sparse, model_ext)

    if vggt and descriptors is None:
        descriptors = compute_image_descriptors(
            dense_folder, images, checkpoint=retrieval_ckpt,
            vit_cfg=vit_cfg, device=device)

    os.makedirs(os.path.join(save_folder, "cams"), exist_ok=True)
    os.makedirs(os.path.join(save_folder, "images"), exist_ok=True)

    ids = sorted(images.keys())
    extrinsics = {}
    for iid in ids:
        img = images[iid]
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(img.qvec)
        e[:3, 3] = img.tvec
        extrinsics[iid] = e

    # depth ranges: 1st-99th percentile of visible point depths
    depth_ranges = {}
    for iid in ids:
        img = images[iid]
        zs = []
        for pid in img.point3D_ids:
            if pid == -1 or pid not in points3d:
                continue
            p = points3d[pid].xyz
            z = (extrinsics[iid][:3, :3] @ p + extrinsics[iid][:3, 3])[2]
            zs.append(z)
        if zs:
            zs = np.sort(np.array(zs))
            dmin = float(np.percentile(zs, 1)) * 0.75
            dmax = float(np.percentile(zs, 99)) * 1.25
        else:
            dmin, dmax = 0.1, 100.0
        depth_ranges[iid] = (max(dmin, 1e-3), dmax)

    sorted_ids, score = score_pairs(images, points3d, extrinsics,
                                    descriptors)

    # write cams + copy images, renaming to sequential %08d
    for new_id, iid in enumerate(sorted_ids):
        img = images[iid]
        cam = cameras[img.camera_id]
        k = intrinsics_from_camera(cam)
        dmin, dmax = depth_ranges[iid]
        path = os.path.join(save_folder, "cams", f"{new_id:08d}_cam.txt")
        with open(path, "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(str(extrinsics[iid][r, c])
                                 for c in range(4)) + "\n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(str(k[r, c]) for c in range(3)) + "\n")
            f.write(f"\n{dmin} {(dmax - dmin) / 256.0} 256 {dmax}\n")
        src = os.path.join(dense_folder, "images", img.name)
        dst = os.path.join(save_folder, "images", f"{new_id:08d}.jpg")
        if os.path.exists(src):
            if src.lower().endswith((".jpg", ".jpeg")):
                shutil.copyfile(src, dst)
            else:
                from PIL import Image
                Image.open(src).convert("RGB").save(dst)

    # pair.txt: top-num_src scored source views per ref
    with open(os.path.join(save_folder, "pair.txt"), "w") as f:
        f.write(f"{len(sorted_ids)}\n")
        for i, iid in enumerate(sorted_ids):
            order = np.argsort(-score[i])
            entries = [(j, score[i][j]) for j in order
                       if j != i][:num_src]
            f.write(f"{i}\n{len(entries)} ")
            f.write(" ".join(f"{j} {s:.4f}" for j, s in entries) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="COLMAP sparse model -> MVS inputs")
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--save_folder", required=True)
    p.add_argument("--model_ext", default=".bin", choices=[".bin", ".txt"])
    p.add_argument("--num_src", type=int, default=10)
    p.add_argument("--vggt", action="store_true",
                   help="score view pairs with R2Former global "
                        "descriptors instead of triangulation angles "
                        "(colmap_input.py:292-329,392-395)")
    p.add_argument("--retrieval_ckpt", default=None,
                   help="R2Former .pth checkpoint for --vggt")
    p.add_argument("--device", default="cuda",
                   help="where --vggt's ViT runs: cuda (default) or cpu; "
                        "checked before any file is written")
    args = p.parse_args(argv)
    resolve_device(args.device)
    convert(args.dense_folder, args.save_folder, args.model_ext,
            args.num_src, vggt=args.vggt,
            retrieval_ckpt=args.retrieval_ckpt, device=args.device)


if __name__ == "__main__":
    main()
