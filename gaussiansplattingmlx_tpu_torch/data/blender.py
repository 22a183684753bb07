"""Blender-style (torch-splatting ``info.json``) dataset loader (numpy; the
port's copy of the JAX package's ``data/blender.py``).

    {"images": [{"intrinsic": [[3x3]], "pose": [[4x4]], "rgb": "r_0.png",
                 "depth": "r_0_depth.png", "alpha": "r_0_alpha.png",
                 "max_depth": 5.0, "HW": [H, W]}, ...], "bbox": [[..], [..]], ...}

Poses are Blender/OpenGL camera-to-world, converted to OpenCV.  Depth PNGs
hold gray * max_depth.  The initial cloud is the depth maps back-projected
where alpha == 1, or, when a view lacks depth or alpha, 100,000 points drawn
uniformly in the bbox by numpy's default_rng(0).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.camera import Camera, opengl_to_opencv_c2w
from ..utils.point_cloud import PointCloud, point_cloud_from_depth
from .colmap import read_resized
from .dataset import TrainData


def _load_png(path, resize_factor: float) -> np.ndarray:
    return read_resized(path, resize_factor).astype(np.float32) / 255.0


def load_blender(
    root,
    resize_factor: float = 1.0,
    white_background: bool = False,
    znear: float = 0.1,
    zfar: float = 100.0,
) -> Tuple[TrainData, PointCloud]:
    root = Path(root)
    info = json.loads((root / "info.json").read_text())
    images = info["images"]
    max_depth = images[0].get("max_depth", 1.0)

    cams, rgbs, depths, alphas, intrinsics, c2ws = [], [], [], [], [], []
    for img in images:
        pose = np.asarray(img["pose"], np.float64).reshape(4, 4)
        c2w = opengl_to_opencv_c2w(pose)
        K = np.asarray(img["intrinsic"], np.float64)[:3, :3]

        rgb = _load_png(root / img["rgb"], resize_factor)
        if rgb.ndim == 3 and rgb.shape[2] == 4:
            rgb = rgb[:, :, :3]
        h, w = rgb.shape[:2]
        K = K.copy()
        K[:2] *= resize_factor

        depth = None
        if img.get("depth"):
            d = _load_png(root / img["depth"], resize_factor)
            if d.ndim == 3:
                d = d[..., 0]
            depth = d * max_depth
        alpha = None
        if img.get("alpha"):
            a = _load_png(root / img["alpha"], resize_factor)
            if a.ndim == 3:
                a = a[..., 0]
            alpha = a

        if white_background and alpha is not None:
            rgb = alpha[:, :, None] * rgb + (1.0 - alpha[:, :, None])

        cams.append(Camera.from_intrinsics(w, h, K, c2w, znear, zfar))
        rgbs.append(rgb)
        depths.append(depth)
        alphas.append(alpha)
        intrinsics.append(K)
        c2ws.append(c2w)

    have_depth = all(d is not None for d in depths)
    have_alpha = all(a is not None for a in alphas)
    data = TrainData(
        cameras=cams,
        images=np.stack(rgbs),
        alphas=np.stack(alphas) if have_alpha else None,
        depths=np.stack(depths) if have_depth else None,
    )

    if have_depth and have_alpha:
        pcd = point_cloud_from_depth(data.images, data.depths, data.alphas,
                                     np.stack(intrinsics), np.stack(c2ws))
    else:
        bbox = np.asarray(info.get("bbox", [[-1, -1, -1], [1, 1, 1]]), np.float64)
        rng = np.random.default_rng(0)
        pts = rng.uniform(bbox[0], bbox[1], size=(100_000, 3)).astype(np.float32)
        pcd = PointCloud(coords=pts, colors=np.full((len(pts), 3), 127.5, np.float32))
    return data, pcd
