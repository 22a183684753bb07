"""Port projection (torch) vs the JAX package's project_gaussians, forward,
on the cases of tests/test_projection.py.

means2d, depths, conic and colors at rtol 1e-5 / atol 1e-5; radii and the
screen rects exactly equal, culled rows included (they feed binning, whose
tile bounds must not move).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import to_numpy, to_torch

from gaussiansplattingmlx_tpu.ops import projection as jax_projection
from gaussiansplattingmlx_tpu.utils import camera as jax_camera
from gaussiansplattingmlx_tpu_torch.ops import projection
from gaussiansplattingmlx_tpu_torch.utils import camera


def _cameras(width, height, focal, z):
    c2w = np.eye(4)
    c2w[2, 3] = z
    return (
        jax_camera.Camera.from_c2w(width, height, focal, focal, c2w),
        camera.Camera.from_c2w(width, height, focal, focal, c2w),
    )


def _both(means, scales, quats, shs, degree, width=64, height=48, focal=60.0, z=0.0):
    jc, tc = _cameras(width, height, focal, z)
    t = jc.tensors()
    want = jax_projection.project_gaussians(
        *(jnp.asarray(a) for a in (means, scales, quats, shs, t["view"],
                                    t["proj"], t["camera_center"])),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
        width, height, degree,
    )
    u = tc.tensors()
    got = projection.project_gaussians(
        *(to_torch(a) for a in (means, scales, quats, shs, u["view"],
                                 u["proj"], u["camera_center"])),
        u["fov_x"], u["fov_y"], u["focal_x"], u["focal_y"],
        width, height, degree,
    )
    return got, want


def _assert_parity(got, want):
    for name in ("means2d", "depths", "conic", "colors"):
        np.testing.assert_allclose(
            to_numpy(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=1e-5, atol=1e-5, err_msg=name,
        )
    for name in ("radii", "rect_min", "rect_max"):
        np.testing.assert_array_equal(
            to_numpy(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name,
        )


def _default_gaussians(n, rng, degree=0, z_range=(2.0, 6.0)):
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    means[:, 2] = rng.uniform(*z_range, size=n)
    scales = rng.uniform(0.05, 0.2, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    shs = rng.normal(size=(n, (degree + 1) ** 2, 3)).astype(np.float32)
    return means, scales, quats, shs


@pytest.mark.parametrize("degree", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_projection_matches_jax(seed, degree):
    rng = np.random.default_rng(seed)
    means, scales, quats, shs = _default_gaussians(64, rng, degree)
    got, want = _both(means, scales, quats, shs, degree)
    assert (np.asarray(want.radii) > 0).all()
    _assert_parity(got, want)


def test_projection_culled_rows_match_jax():
    """Behind-camera, too-near and exactly-at-camera rows: radius 0, finite
    outputs, identical rects (the NaN-safe culled rows)."""
    rng = np.random.default_rng(2)
    means = np.array(
        [[0.0, 0.0, -3.0], [0.0, 0.0, 0.1], [0.0, 0.0, 0.0],
         [0.0, 0.0, 1e-8], [0.0, 0.0, 3.0], [0.4, -0.2, 3.0]],
        np.float32,
    )
    scales = np.full((6, 3), 0.1, np.float32)
    quats = np.tile(np.array([0.9, 0.1, -0.2, 0.3], np.float32), (6, 1))
    shs = rng.normal(size=(6, 1, 3)).astype(np.float32)
    got, want = _both(means, scales, quats, shs, 0)
    np.testing.assert_array_equal(to_numpy(got.radii)[:4], 0.0)
    assert (to_numpy(got.radii)[4:] > 0).all()
    for name in ("means2d", "conic", "colors", "cov2d"):
        assert np.isfinite(to_numpy(getattr(got, name))).all(), name
    _assert_parity(got, want)


def test_projection_bench_camera_matches_jax():
    """The bench camera (800x800, focal 1111, z = -4) at SH degree 3."""
    rng = np.random.default_rng(5)
    n = 256
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    scales = rng.uniform(0.004, 0.02, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.2).astype(np.float32)
    got, want = _both(means, scales, quats, shs, 3, width=800, height=800,
                      focal=1111.0, z=-4.0)
    _assert_parity(got, want)
