"""Point-cloud container and the ray / depth back-projection helpers the
loaders use (numpy only; the port's copy of the JAX package's
``utils/point_cloud.py``).  They run once at dataset load."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PointCloud:
    coords: np.ndarray  # [N, 3] float32
    colors: np.ndarray  # [N, 3] float32, 0..255
    alphas: Optional[np.ndarray] = None  # [N]

    @property
    def size(self) -> int:
        return self.coords.shape[0]

    def random_sample(self, count: int, seed: int = 0) -> "PointCloud":
        """``count`` points drawn without replacement by numpy's default_rng
        (the JAX package's stream); the whole cloud when it is no larger."""
        if count >= self.size:
            return self
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.size, size=count, replace=False)
        return PointCloud(
            coords=self.coords[idx],
            colors=self.colors[idx],
            alphas=None if self.alphas is None else self.alphas[idx],
        )

    def centering(self, sigma_cull: float = 3.0) -> Tuple["PointCloud", np.ndarray]:
        """Drop the points farther from the centroid than the mean distance
        plus ``sigma_cull`` standard deviations, then subtract the kept
        points' centroid.  Returns (new cloud, centroid) so that the caller
        shifts the cameras by the same centroid (``TrainData.shift_cameras``)."""
        coords = self.coords
        centroid = coords.mean(axis=0)
        d = np.linalg.norm(coords - centroid, axis=1)
        keep = d <= d.mean() + sigma_cull * d.std()
        coords = coords[keep]
        centroid = coords.mean(axis=0)
        return (
            PointCloud(
                coords=(coords - centroid).astype(np.float32),
                colors=self.colors[keep],
                alphas=None if self.alphas is None else self.alphas[keep],
            ),
            centroid.astype(np.float32),
        )


def rays_from_camera(
    height: int, width: int, intrinsic: np.ndarray, c2w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel ray origins and directions ([H, W, 3] each, float32): pixel
    (x, y) maps to the camera-space direction ((x-cx)/fx, (y-cy)/fy, 1),
    rotated by c2w."""
    K = np.asarray(intrinsic, np.float64)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)
    dirs = np.stack([(gx - cx) / fx, (gy - cy) / fy, np.ones_like(gx)], axis=-1)
    R = np.asarray(c2w, np.float64)[:3, :3]
    t = np.asarray(c2w, np.float64)[:3, 3]
    world_dirs = dirs @ R.T
    origins = np.broadcast_to(t, world_dirs.shape)
    return origins.astype(np.float32), world_dirs.astype(np.float32)


def point_cloud_from_depth(
    rgbs: np.ndarray,  # [B, H, W, 3] in [0, 1]
    depths: np.ndarray,  # [B, H, W]
    alphas: np.ndarray,  # [B, H, W]
    intrinsics: np.ndarray,  # [B, 3, 3] or [B, 4, 4]
    c2ws: np.ndarray,  # [B, 4, 4]
) -> PointCloud:
    """Back-project every view's depth map where alpha == 1; colours 0..255."""
    pts, cols = [], []
    for b in range(rgbs.shape[0]):
        h, w = depths[b].shape
        origins, dirs = rays_from_camera(h, w, intrinsics[b][:3, :3], c2ws[b])
        mask = alphas[b] >= 1.0
        pts.append(origins[mask] + dirs[mask] * depths[b][mask][:, None])
        cols.append(rgbs[b][mask] * 255.0)
    return PointCloud(
        coords=np.concatenate(pts, axis=0).astype(np.float32),
        colors=np.concatenate(cols, axis=0).astype(np.float32),
    )
