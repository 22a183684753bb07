"""Point-cloud container (numpy only; the port's copy of the JAX package's
``utils/point_cloud.py`` ``PointCloud``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

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
