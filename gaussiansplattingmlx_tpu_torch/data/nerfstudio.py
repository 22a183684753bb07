"""nerfstudio ``transforms.json`` dataset loader (numpy; the port's copy of
the JAX package's ``data/nerfstudio.py``): global or per-frame intrinsics
(fl_x, fl_y, cx, cy, w, h), OpenGL -> OpenCV poses, a frame path without a
suffix read as ``.png``, and the initial cloud from ``ply_file_path`` or,
without one, ``init_points_fallback`` points drawn uniformly in the cameras'
bounding box grown by 1 by numpy's default_rng(seed).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.camera import Camera, opengl_to_opencv_c2w
from ..utils.point_cloud import PointCloud
from .colmap import load_image
from .dataset import TrainData
from .ply import read_point_cloud_ply


def load_nerfstudio(
    root,
    resize_factor: float = 1.0,
    white_background: bool = False,
    znear: float = 0.1,
    zfar: float = 100.0,
    init_points_fallback: int = 100_000,
    seed: int = 0,
) -> Tuple[TrainData, PointCloud]:
    root = Path(root)
    meta = json.loads((root / "transforms.json").read_text())

    def intr(frame) -> dict:
        def get(key):
            return frame.get(key, meta.get(key))

        return dict(fl_x=get("fl_x"), fl_y=get("fl_y"), cx=get("cx"), cy=get("cy"),
                    w=int(get("w")), h=int(get("h")))

    cameras, rgbs, alphas = [], [], []
    have_alpha = True
    for frame in meta["frames"]:
        k = intr(frame)
        pose = np.asarray(frame["transform_matrix"], np.float64).reshape(4, 4)
        c2w = opengl_to_opencv_c2w(pose)
        img_path = root / frame["file_path"]
        if not img_path.suffix:
            img_path = img_path.with_suffix(".png")
        pixels, alpha = load_image(img_path, resize_factor, white_background)
        h, w = pixels.shape[:2]
        sx, sy = w / k["w"], h / k["h"]
        cameras.append(
            Camera.from_c2w(w, h, k["fl_x"] * sx, k["fl_y"] * sy, c2w, znear, zfar))
        rgbs.append(pixels)
        if alpha is None:
            have_alpha = False
        alphas.append(alpha)

    data = TrainData(
        cameras=cameras,
        images=np.stack(rgbs),
        alphas=np.stack(alphas) if have_alpha else None,
    )

    ply_path = meta.get("ply_file_path")
    if ply_path and (root / ply_path).exists():
        pts, cols = read_point_cloud_ply(root / ply_path)
        if cols is None:
            cols = np.full((len(pts), 3), 0.5, np.float32)
        pcd = PointCloud(coords=pts, colors=cols * 255.0)
    else:
        centers = np.stack([c.camera_center for c in cameras])
        lo = centers.min(0) - 1.0
        hi = centers.max(0) + 1.0
        rng = np.random.default_rng(seed)
        pts = rng.uniform(lo, hi, size=(init_points_fallback, 3)).astype(np.float32)
        pcd = PointCloud(coords=pts, colors=np.full((len(pts), 3), 127.5, np.float32))
    return data, pcd
