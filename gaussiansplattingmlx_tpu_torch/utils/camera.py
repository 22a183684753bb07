"""Camera model in the reference's row-vector OpenCV convention (numpy only;
the port's copy of the JAX package's ``utils/camera.py``).

* ``world_view`` = (c2w)^-1 transposed: ``p_view = [x, y, z, 1] @ world_view``;
* ``proj`` = P^T for the column-vector perspective matrix P (znear 0.1,
  zfar 100, depth mapped to [0, 1]);
* ``camera_center`` = translation column of c2w.

Host-side matrix math is float64, cast to float32 arrays for the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def perspective_matrix(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """Column-vector perspective matrix, z mapped to [0, 1]."""
    tan_half_y = math.tan(fov_y / 2.0)
    tan_half_x = math.tan(fov_x / 2.0)
    top = tan_half_y * znear
    right = tan_half_x * znear

    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(znear * zfar) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable per-view camera; array attributes are float32 numpy."""

    width: int
    height: int
    focal_x: float
    focal_y: float
    fov_x: float
    fov_y: float
    world_view: np.ndarray  # [4,4] row-vector view transform (= w2c^T)
    proj: np.ndarray  # [4,4] row-vector projection (= P^T)
    camera_center: np.ndarray  # [3]
    c2w: np.ndarray  # [4,4] original camera-to-world
    znear: float = 0.1
    zfar: float = 100.0

    @staticmethod
    def from_c2w(
        width: int,
        height: int,
        focal_x: float,
        focal_y: float,
        c2w: np.ndarray,
        znear: float = 0.1,
        zfar: float = 100.0,
    ) -> "Camera":
        c2w = np.asarray(c2w, dtype=np.float64).reshape(4, 4)
        fov_x = focal2fov(focal_x, width)
        fov_y = focal2fov(focal_y, height)
        w2c = np.linalg.inv(c2w)
        proj = perspective_matrix(znear, zfar, fov_x, fov_y).T
        return Camera(
            width=width,
            height=height,
            focal_x=float(focal_x),
            focal_y=float(focal_y),
            fov_x=float(fov_x),
            fov_y=float(fov_y),
            world_view=w2c.T.astype(np.float32),
            proj=proj.astype(np.float32),
            camera_center=c2w[:3, 3].astype(np.float32),
            c2w=c2w.astype(np.float32),
            znear=float(znear),
            zfar=float(zfar),
        )

    @staticmethod
    def from_intrinsics(
        width: int,
        height: int,
        intrinsic: np.ndarray,
        c2w: np.ndarray,
        znear: float = 0.1,
        zfar: float = 100.0,
    ) -> "Camera":
        """From a 3x3 or 4x4 intrinsic matrix (focal on the diagonal)."""
        K = np.asarray(intrinsic, dtype=np.float64)
        return Camera.from_c2w(width, height, float(K[0, 0]), float(K[1, 1]), c2w, znear, zfar)

    def tensors(self) -> dict:
        """Flat dict of float32 arrays used by the projection op."""
        return {
            "view": self.world_view,
            "proj": self.proj,
            "camera_center": self.camera_center,
            "fov_x": np.float32(self.fov_x),
            "fov_y": np.float32(self.fov_y),
            "focal_x": np.float32(self.focal_x),
            "focal_y": np.float32(self.focal_y),
        }


def opengl_to_opencv_c2w(c2w: np.ndarray) -> np.ndarray:
    """Blender/OpenGL camera-to-world -> OpenCV convention: invert, negate
    rows 1-2 of the w2c, invert again (the JAX package's formulation, kept
    literally so the float64 results match)."""
    c2w = np.asarray(c2w, dtype=np.float64).reshape(4, 4)
    w2c = np.linalg.inv(c2w)
    w2c[1:3, :] *= -1.0
    return np.linalg.inv(w2c)


def spatial_lr_scale_auto(cameras) -> float:
    """INRIA-style position-LR scene scaling: 1.1 x the radius of the camera
    bounding sphere (the largest distance of a camera center from their
    centroid), for ``OptimizerConfig.spatial_lr_scale``."""
    centers = np.stack([np.asarray(c.tensors()["camera_center"]) for c in cameras])
    return float(1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())
