"""The projection and the SH colour as CUDA kernels, forward and backward
(``csrc/project.cu``).

No TPU kernel: these replace, on CUDA tensors, the plain PyTorch
``projection.project_gaussians_plain`` and ``utils/sh.sh_to_color``, whose
~100 small ops and their autograd nodes each read and write whole [N]
tensors.  Two ``autograd.Function``s, one a span (``project``, ``sh``), so
that each span and its ``.bwd`` keep meaning what they measure:

* ``_ProjectFn``: means3d, activated scales, raw quats and the optional
  ``active`` mask through one camera -> means2d, depths, cov2d, conic,
  radii and the screen rects (``project_fwd_kernel``).  Its backward
  (``project_bwd_kernel``) recomputes the forward from the same inputs and
  takes the cotangents of means2d, depths, cov2d and conic as column slices
  of whatever holds them (row strides, no copies).
* ``_ShColorFn``: shs [N, K, 3] at ``sh_degree`` (0-4, a template argument
  of the kernels), means3d and the camera centre -> colours
  (``sh_color_fwd_kernel``); the backward (``sh_color_bwd_kernel``) writes
  all K rows of d shs (zeros above the degree) and d means3d.

Radii and rects are detached, as the plain path detaches them.  The camera
(view, proj, centre, and fov and focal where they are tensors) is read from
device memory; Python numbers travel as kernel arguments.  Nothing here
copies to or from the host.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_CONSTS = ctypes.POINTER(ctypes.c_float)
_CAMERA = [_P, _P, _P, _P, _P, _P, _CONSTS]  # view, proj, fov_x, fov_y, focal_x, focal_y

PROJECT_KERNEL = _kernels.Kernel(
    "gsplat_project_fwd", [_P, _P, _P, _P, _I64, *_CAMERA] + [_P] * 8)
PROJECT_BWD_KERNEL = _kernels.Kernel(
    "gsplat_project_bwd",
    [_P, _P, _P, _P, _I64, *_CAMERA, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P])
SH_KERNEL = _kernels.Kernel(
    "gsplat_sh_color_fwd", [_P, ctypes.c_int32, ctypes.c_int32, _P, _P, _I64, _P, _P])
SH_BWD_KERNEL = _kernels.Kernel(
    "gsplat_sh_color_bwd",
    [_P, ctypes.c_int32, ctypes.c_int32, _P, _P, _P, _I64, _I64, _P, _P, _P])
MAX_SH_DEGREE = 4


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _rows(t: torch.Tensor, shape: tuple, name: str, device) -> torch.Tensor:
    """``t`` as contiguous float32 of ``shape`` on ``device``, else raise."""
    _kernels.check(tuple(t.shape) == shape and t.dtype == torch.float32
                   and t.device == device,
                   f"{name} must be float32 {shape} on {device}, got {t.dtype} "
                   f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _camera_tensor(t: torch.Tensor, numel: int, name: str, device) -> torch.Tensor:
    _kernels.check(isinstance(t, torch.Tensor) and t.numel() == numel and t.device == device,
                   f"{name} must be a tensor of {numel} values on {device}")
    _kernels.check(not t.requires_grad, f"{name}: the kernels give no gradient for the camera")
    return t.to(torch.float32).contiguous()


def _camera_scalar(v, name: str, device):
    """(a float32 0-d tensor on ``device``, None) for a device tensor, (None,
    the value) for a number or a CPU tensor."""
    if isinstance(v, torch.Tensor):
        _kernels.check(v.numel() == 1, f"{name} must hold one value, got {tuple(v.shape)}")
        _kernels.check(not v.requires_grad, f"{name}: the kernels give no gradient for it")
        if v.device == device:
            return v.to(torch.float32).reshape(()), 0.0
        _kernels.check(v.device.type == "cpu", f"{name} on {v.device}, not {device}")
        return None, float(v)
    return None, float(v)


class Camera:
    """One camera as the kernels read it: the matrices and centre on the
    device, fov and focal as device scalars or numbers, the constants."""

    def __init__(self, view, proj, camera_center, fov_x, fov_y, focal_x, focal_y,
                 image_width: int, image_height: int, *, z_cull: float, ndc_w_eps: float,
                 tanfov_clip: float, cov2d_dilation: float, radius_eigen_eps: float,
                 quat_norm_eps: float, device):
        self.view = _camera_tensor(view, 16, "view", device)
        self.proj = _camera_tensor(proj, 16, "proj", device)
        self.center = _camera_tensor(camera_center, 3, "camera_center", device)
        scalars = [_camera_scalar(v, name, device) for v, name in
                   ((fov_x, "fov_x"), (fov_y, "fov_y"), (focal_x, "focal_x"),
                    (focal_y, "focal_y"))]
        self.scalars = [t for t, _ in scalars]
        # ProjectConsts (csrc/project.cu), each rounded to float32 as the
        # plain path rounds the same Python number (eps squared in double).
        self.consts = (ctypes.c_float * 12)(
            float(image_width), float(image_height), z_cull, ndc_w_eps, tanfov_clip,
            cov2d_dilation, radius_eigen_eps, quat_norm_eps * quat_norm_eps,
            *(v for _, v in scalars))

    def args(self) -> list:
        return [self.view.data_ptr(), self.proj.data_ptr(), *map(_ptr, self.scalars),
                self.consts]


def _cotangent(g: torch.Tensor | None, cols: int):
    """(pointer, row stride) of a cotangent whose columns are contiguous, or
    (None, 0) where there is none."""
    if g is None:
        return None, 0
    g = g.reshape(g.shape[0], cols)
    if cols > 1 and g.stride(1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


class _ProjectFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means3d, scales, quats, active, cam: Camera):
        n = means3d.shape[0]
        dev = means3d.device
        out = [torch.empty(shape, dtype=torch.float32, device=dev) for shape in
               ((n, 2), (n,), (n, 4), (n, 4), (n,), (n, 2), (n, 2))]
        if n:
            with torch.cuda.device(dev):
                PROJECT_KERNEL.launch(means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                                      _ptr(active), n, *cam.args(), *map(_ptr, out),
                                      _kernels.stream_of(means3d))
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*out[4:])
        ctx.save_for_backward(means3d, scales, quats, active)
        ctx.cam = cam
        return tuple(out)

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_cov2d, g_conic, *_detached):
        means3d, scales, quats, active = ctx.saved_tensors
        n = means3d.shape[0]
        if n == 0 or all(g is None for g in (g_means2d, g_depths, g_cov2d, g_conic)):
            return None, None, None, None, None
        cots = [_cotangent(g, cols) for g, cols in
                ((g_means2d, 2), (g_depths, 1), (g_cov2d, 4), (g_conic, 4))]
        d_means = torch.empty_like(means3d)
        d_scales = torch.empty_like(scales)
        d_quats = torch.empty_like(quats)
        with torch.cuda.device(means3d.device):
            PROJECT_BWD_KERNEL.launch(
                means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), _ptr(active), n,
                *ctx.cam.args(), *[x for g, stride in cots for x in (_ptr(g), stride)],
                d_means.data_ptr(), d_scales.data_ptr(), d_quats.data_ptr(),
                _kernels.stream_of(means3d))
        need = ctx.needs_input_grad
        return (d_means if need[0] else None, d_scales if need[1] else None,
                d_quats if need[2] else None, None, None)


class _ShColorFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shs, means3d, center, degree: int):
        n = shs.shape[0]
        colors = torch.empty((n, 3), dtype=torch.float32, device=shs.device)
        if n:
            with torch.cuda.device(shs.device):
                SH_KERNEL.launch(shs.data_ptr(), shs.shape[1], degree, means3d.data_ptr(),
                                 center.data_ptr(), n, colors.data_ptr(),
                                 _kernels.stream_of(shs))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(shs, means3d, center)
        ctx.degree = degree
        return colors

    @staticmethod
    def backward(ctx, d_colors):
        shs, means3d, center = ctx.saved_tensors
        n = shs.shape[0]
        if n == 0 or d_colors is None:
            return None, None, None, None
        d_colors, stride = _cotangent(d_colors, 3)
        d_shs = torch.empty_like(shs)
        d_means = torch.empty_like(means3d)
        with torch.cuda.device(shs.device):
            SH_BWD_KERNEL.launch(shs.data_ptr(), shs.shape[1], ctx.degree, means3d.data_ptr(),
                                 center.data_ptr(), d_colors.data_ptr(), stride, n,
                                 d_shs.data_ptr(), d_means.data_ptr(), _kernels.stream_of(shs))
        need = ctx.needs_input_grad
        return d_shs if need[0] else None, d_means if need[1] else None, None, None


def project(means3d, scales, quats, active, cam: Camera):
    """(means2d [N, 2], depths [N], cov2d [N, 4], conic [N, 4], radii [N],
    rect_min [N, 2], rect_max [N, 2]) of N Gaussians on the card; ``active``
    [N] or None (rows with active <= 0 are culled)."""
    dev = means3d.device
    n = means3d.shape[0]
    means3d = _rows(means3d, (n, 3), "means3d", dev)
    scales = _rows(scales, (n, 3), "scales", dev)
    quats = _rows(quats, (n, 4), "quats", dev)
    if active is not None:
        _kernels.check(tuple(active.shape) == (n,) and active.device == dev,
                       f"active must be [{n}] on {dev}, got {tuple(active.shape)}")
        active = active.detach().to(torch.float32).contiguous()
    return _ProjectFn.apply(means3d, scales, quats, active, cam)


def sh_color(degree: int, shs, means3d, cam: Camera):
    """Colours [N, 3] of shs [N, K, 3] at ``degree`` (K >= (degree + 1)^2),
    seen from the camera's centre: the plain ``sh_to_color`` of the
    unnormalised direction means3d - centre."""
    n = means3d.shape[0]
    _kernels.check(0 <= degree <= MAX_SH_DEGREE, f"SH degree {degree} outside 0-{MAX_SH_DEGREE}")
    _kernels.check(shs.dim() == 3 and shs.shape[0] == n and shs.shape[2] == 3
                   and shs.shape[1] >= (degree + 1) ** 2,
                   f"shs must be [{n}, >= {(degree + 1) ** 2}, 3], got {tuple(shs.shape)}")
    shs = _rows(shs, tuple(shs.shape), "shs", means3d.device)
    means3d = _rows(means3d, (n, 3), "means3d", means3d.device)
    return _ShColorFn.apply(shs, means3d, cam.center, degree)
