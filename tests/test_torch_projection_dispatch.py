"""``project_gaussians`` on the CPU: the plain path, unchanged, and what the
CUDA path packs for its kernels.

On CPU tensors ``project_gaussians`` must return exactly what
``project_gaussians_plain`` returns, forward and gradients, and launch no
kernel; the kernels themselves are held to the plain path on the card
(``tests/test_torch_projection_cuda.py``).  The CUDA path's camera constants,
cotangent strides and argument checks are plain Python, tested here.
"""

import ctypes

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from gaussiansplattingmlx_tpu_torch.ops import _kernels, projection, projection_cuda
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

LEAVES = ("means3d", "scales", "quats", "shs")


def _inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    means[:, 2] = rng.uniform(-0.5, 5.0, size=n)
    leaves = {"means3d": means,
              "scales": rng.uniform(0.02, 0.3, size=(n, 3)).astype(np.float32),
              "quats": rng.normal(size=(n, 4)).astype(np.float32),
              "shs": (rng.normal(size=(n, k, 3)) * 0.5).astype(np.float32)}
    active = (rng.uniform(size=n) > 0.2).astype(np.float32)
    cam = Camera.from_c2w(64, 48, 55.0, 55.0, np.eye(4)).tensors()
    return leaves, active, cam


def _outputs_and_grads(fn, leaves, active, cam, degree):
    x = {k: torch.tensor(v, requires_grad=True) for k, v in leaves.items()}
    out = fn(x["means3d"], x["scales"], x["quats"], x["shs"],
             *(torch.as_tensor(np.asarray(cam[k])) for k in ("view", "proj", "camera_center")),
             cam["fov_x"], cam["fov_y"], cam["focal_x"], cam["focal_y"], 64, 48, degree,
             active=torch.tensor(active))
    gen = torch.Generator().manual_seed(degree)
    loss = sum((t * torch.randn(t.shape, generator=gen)).sum()
               for t in (out.means2d, out.depths, out.colors, out.cov2d, out.conic))
    return out, torch.autograd.grad(loss, [x[k] for k in LEAVES])


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_project_gaussians_on_cpu_is_the_plain_path(degree):
    """Forward outputs and every leaf's gradient bit for bit, culled and
    inactive rows and coefficient rows above the degree included; no kernel
    launched."""
    leaves, active, cam = _inputs(300, (degree + 1) ** 2 + 1, seed=degree)
    before = _kernels.launch_counts()
    got, got_g = _outputs_and_grads(projection.project_gaussians, leaves, active, cam, degree)
    want, want_g = _outputs_and_grads(projection.project_gaussians_plain, leaves, active, cam,
                                      degree)
    assert _kernels.launch_counts() == before
    assert int((got.radii == 0).sum()) > 0 and int((got.radii > 0).sum()) > 0
    for name in projection.ProjectionOutputs._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)


def test_projection_camera_packs_constants_as_the_plain_path_rounds_them():
    """Numbers become float32 as the plain path's scalar tensors do (the
    quaternion eps squared in double first); device scalars stay on the
    device, numbers and CPU scalars travel by value."""
    dev = torch.device("cpu")
    view, proj = torch.eye(4, dtype=torch.float64), torch.eye(4)
    fov_y = torch.tensor(0.7, dtype=torch.float64)
    cam = projection_cuda.Camera(
        view, proj, torch.zeros(3), 0.9, fov_y, 1111.0, torch.tensor(1111.0), 800, 600,
        z_cull=0.2, ndc_w_eps=1e-6, tanfov_clip=1.3, cov2d_dilation=0.3,
        radius_eigen_eps=1e-5, quat_norm_eps=1e-8, device=dev)
    want = np.array([800, 600, 0.2, 1e-6, 1.3, 0.3, 1e-5, 1e-16, 0.9, 0.0, 1111.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(np.ctypeslib.as_array(cam.consts), want)
    assert cam.view.dtype == torch.float32 and cam.view.is_contiguous()
    assert cam.scalars[0] is None and cam.scalars[2] is None
    assert cam.scalars[1].dtype == torch.float32 and float(cam.scalars[1]) == np.float32(0.7)
    assert float(cam.scalars[3]) == 1111.0
    args = cam.args()
    assert args[2] is None and args[3] == cam.scalars[1].data_ptr()
    assert isinstance(args[-1], ctypes.Array) and len(args[-1]) == 12


def test_projection_cotangents_pass_as_strided_rows():
    """Column slices of the packed [N, 11] cotangent reach the kernels as
    pointers into it with row stride 11; a cotangent whose columns are not
    contiguous is copied, a missing one is a null pointer."""
    g = torch.randn(5, 11)
    for cols, view in ((2, g[:, 0:2]), (4, g[:, 2:6]), (1, g[:, 10])):
        t, stride = projection_cuda._cotangent(view, cols)
        assert t.data_ptr() == view.data_ptr() and stride == 11
    t, stride = projection_cuda._cotangent(g[:, 0:8:2], 4)
    assert stride == 4 and torch.equal(t, g[:, 0:8:2])
    assert projection_cuda._cotangent(None, 4) == (None, 0)


def test_projection_kernel_path_refuses_what_the_kernels_do_not_take():
    """Each refusal comes before any launch: an SH degree past 4, too few
    coefficient rows, a camera that wants a gradient, another device."""
    dev = torch.device("cpu")
    consts = dict(z_cull=0.2, ndc_w_eps=1e-6, tanfov_clip=1.3, cov2d_dilation=0.3,
                  radius_eigen_eps=1e-5, quat_norm_eps=1e-8)
    cam = projection_cuda.Camera(torch.eye(4), torch.eye(4), torch.zeros(3), 0.9, 0.9, 60.0,
                                 60.0, 64, 48, device=dev, **consts)
    means = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="SH degree 5"):
        projection_cuda.sh_color(5, torch.zeros(4, 36, 3), means, cam)
    with pytest.raises(ValueError, match="shs must be"):
        projection_cuda.sh_color(3, torch.zeros(4, 9, 3), means, cam)
    with pytest.raises(ValueError, match="no gradient"):
        projection_cuda.Camera(torch.eye(4, requires_grad=True), torch.eye(4), torch.zeros(3),
                               0.9, 0.9, 60.0, 60.0, 64, 48, device=dev, **consts)
    with pytest.raises(ValueError, match="quats must be"):
        projection_cuda.project(means, torch.ones(4, 3), torch.ones(4, 3), None, cam)
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        projection.project_gaussians(meta, meta, torch.empty(4, 4, device="meta"),
                                     torch.empty(4, 1, 3, device="meta"), torch.eye(4),
                                     torch.eye(4), torch.zeros(3), 0.9, 0.9, 60.0, 60.0, 64, 48, 0)
