"""Training dataset container: per-view cameras and target images (numpy
only; the port's copy of the JAX package's ``data/dataset.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..utils.camera import Camera


@dataclasses.dataclass
class TrainData:
    cameras: List[Camera]
    images: np.ndarray  # [B, H, W, 3] float32 in [0, 1]
    alphas: Optional[np.ndarray] = None  # [B, H, W]
    depths: Optional[np.ndarray] = None  # [B, H, W]

    def __post_init__(self):
        if len(self.cameras) != self.images.shape[0]:
            raise ValueError(f"{len(self.cameras)} cameras for "
                             f"{self.images.shape[0]} images")

    @property
    def num_views(self) -> int:
        return len(self.cameras)

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    def has_depth(self) -> bool:
        return self.depths is not None

    def view_tensors(self, index: int) -> dict:
        """One view's camera tensors and targets as numpy arrays; the depth
        mask is alpha == 1 where alphas exist, all ones with depths alone,
        all zeros without depths."""
        t = self.cameras[index].tensors()
        t["target_rgb"] = self.images[index]
        shape = (self.height, self.width)
        if self.depths is not None:
            t["target_depth"] = self.depths[index]
            t["depth_mask"] = (
                (self.alphas[index] >= 1.0).astype(np.float32)
                if self.alphas is not None
                else np.ones(shape, np.float32)
            )
        else:
            t["target_depth"] = np.zeros(shape, np.float32)
            t["depth_mask"] = np.zeros(shape, np.float32)
        return t

    def shift_cameras(self, centroid: np.ndarray) -> "TrainData":
        """The same views with every camera translated by ``-centroid``: the
        shift ``PointCloud.centering`` applied to the cloud."""
        new_cams = []
        for cam in self.cameras:
            c2w = np.asarray(cam.c2w, np.float64).copy()
            c2w[:3, 3] -= centroid
            new_cams.append(Camera.from_c2w(cam.width, cam.height, cam.focal_x, cam.focal_y,
                                            c2w, znear=cam.znear, zfar=cam.zfar))
        return TrainData(cameras=new_cams, images=self.images, alphas=self.alphas,
                         depths=self.depths)
