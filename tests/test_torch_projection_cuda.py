"""The projection and SH colour kernels (``csrc/project.cu``) against the
plain path, on the card.

Imports no JAX.  Every test is marked ``cuda`` and skips when no CUDA device
is present; on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_projection_cuda.py

Each case runs ``project_gaussians`` on CUDA tensors (the kernels) and
``project_gaussians_plain`` on the same inputs twice:

* on the card, where every forward output is bit-equal: the kernels repeat
  the plain path's correctly rounded operations in its order;
* on CPU copies, where radii, rects, means2d, depths and colours are
  bit-equal, and cov2d and conic within 1e-4 of each row's larger diagonal
  entry: the CPU's plain path is not the card's, for PyTorch's CPU
  reductions add left to right where its CUDA ones add (a0 + a2) + a1, and
  its vectorised CPU square root is not correctly rounded (the plain paths
  of the two devices differ by up to ~3e-6 in cov2d and ~1.5e-5 in the
  conic, which the determinant's cancellation amplifies).

Gradients of every leaf, against both: the benchmark's ``grad_gap`` (the
worst leaf's norm gap over the larger of its and the median leaf's norm)
and each leaf's norm of the difference over its norm, both at most 1e-5.
The cotangents reach the kernels as autograd hands them in training: column
slices of the packed [N, 11] records' cotangent (cov2d's contiguous).
"""

import statistics

import numpy as np
import pytest
import torch

from torch_port_helpers import require_cuda, scene_numpy

from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
from gaussiansplattingmlx_tpu_torch.ops import projection, projection_cuda, rasterize_ref
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils import sh as sh_utils
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

pytestmark = pytest.mark.cuda

FORWARD = ("means2d", "depths", "cov2d", "conic", "colors", "radii", "rect_min", "rect_max")
LEAVES = ("means3d", "scales", "quats", "shs")
FWD_KERNELS = (projection_cuda.PROJECT_KERNEL, projection_cuda.SH_KERNEL)
BWD_KERNELS = (projection_cuda.PROJECT_BWD_KERNEL, projection_cuda.SH_BWD_KERNEL)


def _scene(n, k, seed):
    """n Gaussians with k coefficient rows: in front of the camera, the
    first six behind it, at it, or about z_cull, ~10% with active <= 0."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    means[:, 2] = rng.uniform(0.1, 6.0, size=n)
    means[:6, 2] = [-3.0, 0.0, 1e-8, 0.1, 0.19, 0.2]
    leaves = {"means3d": means,
              "scales": rng.uniform(0.01, 0.3, size=(n, 3)).astype(np.float32),
              "quats": rng.normal(size=(n, 4)).astype(np.float32),
              "shs": (rng.normal(size=(n, k, 3)) * 0.5).astype(np.float32)}
    active = np.where(rng.uniform(size=n) < 0.1, rng.choice([0.0, -1.0], size=n), 1.0)
    c2w = np.eye(4)
    c2w[:3, 3] = rng.normal(size=3) * 0.1
    return leaves, active.astype(np.float32), c2w


def _camera(cam: Camera, device, scalars_on_device: bool):
    t = cam.tensors()
    mats = [torch.as_tensor(np.asarray(t[k], np.float32)).to(device)
            for k in ("view", "proj", "camera_center")]
    scalars = [float(t[k]) for k in ("fov_x", "fov_y", "focal_x", "focal_y")]
    if scalars_on_device:
        scalars = [torch.tensor(v, dtype=torch.float32, device=device) for v in scalars]
    return mats + scalars


def _run(fn, leaves, active, cam, degree, device, scalars_on_device=False, cot=None,
         **constants):
    """fn's outputs on ``device`` and, where ``cot`` is given, the leaves'
    gradients at it (``cot``: the packed records' [N, 11] cotangent and
    cov2d's [N, 4])."""
    x = {k: torch.tensor(v, device=device, requires_grad=True) for k, v in leaves.items()}
    out = fn(x["means3d"], x["scales"], x["quats"], x["shs"],
             *_camera(cam, device, scalars_on_device), cam.width, cam.height, degree,
             active=None if active is None else torch.tensor(active, device=device),
             **constants)
    grads = None
    if cot is not None:
        n = x["means3d"].shape[0]
        packed = rasterize_ref.pack_gaussians(out.means2d, out.conic, out.colors,
                                              torch.ones((n, 1), device=device), out.depths)
        loss = ((packed * cot[0].to(device)).sum()
                + (out.cov2d * cot[1].to(device)).sum())
        grads = dict(zip(LEAVES, torch.autograd.grad(loss, [x[k] for k in LEAVES])))
    return out, grads


def _cotangents(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, 11), generator=gen), torch.randn((n, 4), generator=gen)


def _same_bits(a, b) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def _close_by_row(got, want, name):
    """|got - want| within 1e-4 of each row's larger diagonal entry
    (cov2d's c00, c11; the conic's likewise)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    scale = torch.maximum(want[:, 0].abs(), want[:, 3].abs())[:, None]
    gap = ((got - want).abs() / scale).nan_to_num(0.0)
    assert float(gap.max()) <= 1e-4, (name, float(gap.max()))


def _grad_checks(got: dict, want: dict, what: str, leaves=LEAVES):
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in leaves}
    med = statistics.median(norms.values())
    for k in leaves:
        g, w = got[k].detach().cpu().double(), want[k].detach().cpu().double()
        gap = abs(float(torch.linalg.vector_norm(g)) - norms[k]) / max(norms[k], med)
        diff = float(torch.linalg.vector_norm(g - w)) / max(norms[k], 1e-30)
        assert gap <= 1e-5 and diff <= 1e-5, (what, k, gap, diff)


def _launches(kernels):
    return [k.launches for k in kernels]


@pytest.mark.parametrize("extra_rows", [0, 2])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_projection_kernels_match_plain(degree, extra_rows):
    """2,000 Gaussians (16 blocks, a ragged last one) at SH ``degree`` with
    ``extra_rows`` coefficient rows above it, fov and focal as device
    scalars at even degrees and as numbers at odd ones."""
    require_cuda()
    n, k = 2000, (degree + 1) ** 2 + extra_rows
    leaves, active, c2w = _scene(n, k, seed=10 * degree + extra_rows)
    cam = Camera.from_c2w(96, 64, 70.0, 70.0, c2w)
    cot = _cotangents(n, degree)
    fwd, bwd = _launches(FWD_KERNELS), _launches(BWD_KERNELS)
    got, got_g = _run(projection.project_gaussians, leaves, active, cam, degree, "cuda",
                      scalars_on_device=degree % 2 == 0, cot=cot)
    torch.cuda.synchronize()
    assert _launches(FWD_KERNELS) == [c + 1 for c in fwd]
    assert _launches(BWD_KERNELS) == [c + 1 for c in bwd]
    card, card_g = _run(projection.project_gaussians_plain, leaves, active, cam, degree, "cuda",
                        cot=cot)
    cpu, cpu_g = _run(projection.project_gaussians_plain, leaves, active, cam, degree, "cpu",
                      cot=cot)
    assert int((got.radii > 0).sum()) > n // 2 and int((got.radii == 0).sum()) >= 6
    for name in FORWARD:
        assert _same_bits(getattr(got, name), getattr(card, name)), name
        if name in ("cov2d", "conic"):
            _close_by_row(getattr(got, name), getattr(cpu, name), name)
        else:
            assert _same_bits(getattr(got, name), getattr(cpu, name)), name
    assert not got.radii.requires_grad and not got.rect_min.requires_grad
    _grad_checks(got_g, card_g, "against the card's plain path")
    _grad_checks(got_g, cpu_g, "against the CPU's plain path")
    assert bool((got_g["shs"][:, (degree + 1) ** 2:] == 0).all())


def test_projection_kernels_unaligned_and_strided_inputs():
    """shs 4 bytes off a 16-byte boundary (the coefficient rows move as
    floats, not float4s) and means3d a strided view: the same outputs and
    gradients as aligned, contiguous copies."""
    require_cuda()
    n, degree = 1000, 3
    leaves, active, c2w = _scene(n, 16, seed=7)
    cam = Camera.from_c2w(96, 64, 70.0, 70.0, c2w)
    base, base_g = _run(projection.project_gaussians, leaves, active, cam, degree, "cuda",
                        cot=_cotangents(n, 1))
    shs_src = torch.tensor(leaves["shs"], device="cuda", requires_grad=True)
    means_src = torch.tensor(leaves["means3d"], device="cuda", requires_grad=True)
    shs = torch.cat([torch.zeros(1, device="cuda"), shs_src.reshape(-1)])[1:].view(n, 16, 3)
    pad = torch.zeros((n, 1), device="cuda")
    means = torch.cat([pad, means_src, pad], dim=1)[:, 1:4]
    assert shs.data_ptr() % 16 == 4 and shs.is_contiguous() and not means.is_contiguous()
    x = [means, torch.tensor(leaves["scales"], device="cuda"),
         torch.tensor(leaves["quats"], device="cuda"), shs]
    out = projection.project_gaussians(*x, *_camera(cam, "cuda", False), cam.width, cam.height,
                                       degree, active=torch.tensor(active, device="cuda"))
    cot = _cotangents(n, 1)
    packed = rasterize_ref.pack_gaussians(out.means2d, out.conic, out.colors,
                                          torch.ones((n, 1), device="cuda"), out.depths)
    loss = (packed * cot[0].cuda()).sum() + (out.cov2d * cot[1].cuda()).sum()
    g_means, g_shs = torch.autograd.grad(loss, [means_src, shs_src])
    for name in FORWARD:
        assert _same_bits(getattr(out, name), getattr(base, name)), name
    assert _same_bits(g_shs, base_g["shs"]) and _same_bits(g_means, base_g["means3d"])


def test_projection_kernels_give_spheres_no_rotation_gradient():
    """Identity quaternions and isotropic scales, as training starts from a
    point cloud: rotating a sphere changes nothing, and the plain path's
    rotation gradient is exactly 0; so is the kernels'."""
    require_cuda()
    n = 500
    leaves, active, c2w = _scene(n, 16, seed=21)
    leaves["scales"] = np.repeat(leaves["scales"][:, :1], 3, axis=1)
    leaves["quats"] = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1))
    cam = Camera.from_c2w(96, 64, 70.0, 70.0, c2w)
    cot = _cotangents(n, 2)
    got, got_g = _run(projection.project_gaussians, leaves, active, cam, 3, "cuda", cot=cot)
    card, card_g = _run(projection.project_gaussians_plain, leaves, active, cam, 3, "cuda",
                        cot=cot)
    assert bool((card_g["quats"] == 0).all()) and bool((got_g["quats"] == 0).all())
    _grad_checks(got_g, card_g, "spheres", ("means3d", "scales", "shs"))


def _colour_tie_coefficient() -> np.float32:
    """A float32 s with C0 * s == -0.5 in float32: the colour's clamp at 0
    ties exactly."""
    c0 = np.float32(sh_utils.C0)
    s = np.float32(-0.5 / float(c0))
    for _ in range(8):
        if c0 * s == np.float32(-0.5):
            return s
        s = np.nextafter(s, np.float32(0.0) if c0 * s < -0.5 else np.float32(-1.0))
    raise AssertionError("no float32 coefficient ties the colour clamp")


def test_projection_kernels_split_ties():
    """Rows whose colour is exactly 0 before the clamp and rows whose view
    depth equals the EWA clamp's limit 1.3 tan(fov_x / 2): torch.maximum /
    torch.minimum give each side half the gradient there, and so do the
    kernels, entry for entry."""
    require_cuda()
    width = height = 64
    for focal in np.linspace(50.0, 90.0, 41):
        cam = Camera.from_c2w(width, height, float(focal), float(focal), np.eye(4))
        fov = torch.tensor(cam.fov_x, dtype=torch.float32)
        lims = [torch.tan(fov.to(d) * 0.5) * 1.3 for d in ("cpu", "cuda")]
        if _same_bits(lims[0], lims[1]):
            break
    else:
        raise AssertionError("no focal length whose clamp limit the CPU and card agree on")
    lim = float(lims[0])
    n, degree = 256, 3
    rng = np.random.default_rng(3)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    means[:, 2] = rng.uniform(0.5, 4.0, size=n)
    means[:64, 2] = np.float32(lim)  # the t clamp ties
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    shs[64:128] = 0.0
    shs[64:128, 0, :] = _colour_tie_coefficient()  # the colour clamp ties
    leaves = {"means3d": means,
              "scales": rng.uniform(0.02, 0.2, size=(n, 3)).astype(np.float32),
              "quats": rng.normal(size=(n, 4)).astype(np.float32), "shs": shs}
    cot = _cotangents(n, 5)
    got, got_g = _run(projection.project_gaussians, leaves, None, cam, degree, "cuda", cot=cot)
    card, card_g = _run(projection.project_gaussians_plain, leaves, None, cam, degree, "cuda",
                        cot=cot)
    assert bool((got.depths[:64] == lim).all()) and bool((got.colors[64:128] == 0).all())
    for name in FORWARD:
        assert _same_bits(getattr(got, name), getattr(card, name)), name
    for k in LEAVES:  # half against all of a tie's gradient would be a 50% gap
        want = card_g[k].cpu()
        torch.testing.assert_close(got_g[k].cpu(), want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()), msg=k)
    # d sh at a tied colour is C0 times half the colour's cotangent.
    half = np.float32(sh_utils.C0) * (0.5 * cot[0][64:128, 6:9].numpy())
    np.testing.assert_array_equal(got_g["shs"][64:128, 0].cpu().numpy(), half)


def test_projection_kernels_needle():
    """Needles as ROADMAP C.5 found one: just past z_cull, 10^7 times longer
    than wide and diagonal on the screen, so cov2d's four entries round to
    one value and its determinant to 0.  The guard then leaves the conic as
    cov2d's adjugate.  Every value on the way is exact or correctly rounded
    (a unit quaternion, the long axis clear of the t clamp), so the CPU, the
    card's plain path and the kernels take that branch with the same bits;
    a fourth, ordinary row beside them."""
    require_cuda()
    r = float(np.float32(np.sqrt(0.5)))
    view = np.eye(4, dtype=np.float32)
    view[:2, :2] = [[r, r], [-r, r]]  # world x on the screen's diagonal
    cam = Camera.from_c2w(64, 48, 60.0, 60.0, np.eye(4))
    proj = np.asarray(cam.tensors()["proj"], np.float32)
    leaves = {"means3d": np.array([[0.0, 0.0, 0.25], [0.02, -0.01, 0.25], [0.01, 0.02, 0.25],
                                   [0.1, 0.1, 2.0]], np.float32),
              "scales": np.array([[1000.0, 1e-4, 1e-4], [1500.0, 1e-4, 1e-4],
                                  [600.0, 1e-4, 1e-4], [0.1, 0.05, 0.02]], np.float32),
              "quats": np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (4, 1)),
              "shs": np.random.default_rng(0).normal(size=(4, 16, 3)).astype(np.float32)}
    cot = _cotangents(4, 9)

    def run(fn, device):
        x = {k: torch.tensor(v, device=device, requires_grad=True) for k, v in leaves.items()}
        out = fn(x["means3d"], x["scales"], x["quats"], x["shs"], torch.tensor(view, device=device),
                 torch.tensor(proj, device=device), torch.zeros(3, device=device), cam.fov_x,
                 cam.fov_y, cam.focal_x, cam.focal_y, 64, 48, 3)
        packed = rasterize_ref.pack_gaussians(out.means2d, out.conic, out.colors,
                                              torch.ones((4, 1), device=device), out.depths)
        loss = (packed * cot[0].to(device)).sum() + (out.cov2d * cot[1].to(device)).sum()
        return out, dict(zip(LEAVES, torch.autograd.grad(loss, [x[k] for k in LEAVES])))

    got, got_g = run(projection.project_gaussians, "cuda")
    card, card_g = run(projection.project_gaussians_plain, "cuda")
    cpu, cpu_g = run(projection.project_gaussians_plain, "cpu")
    c = got.cov2d[:3]
    assert bool((c[:, 0] * c[:, 3] - c[:, 1] * c[:, 2] <= 1e-12).all())
    assert _same_bits(got.conic[:3], torch.stack([c[:, 3], -c[:, 1], -c[:, 2], c[:, 0]], 1))
    assert bool((got.radii > 0).all())
    for name in FORWARD:
        assert _same_bits(getattr(got, name), getattr(card, name)), name
        assert _same_bits(getattr(got, name), getattr(cpu, name)), name
    for k in LEAVES:
        assert bool(torch.isfinite(got_g[k]).all()), k
    _grad_checks(got_g, card_g, "against the card's plain path")
    _grad_checks(got_g, cpu_g, "against the CPU's plain path")


def test_projection_kernels_launch_once_a_render_and_a_step():
    """A render through ``render.render`` launches each forward kernel once
    and, without gradients, no backward; its loss's backward launches each
    backward kernel once."""
    require_cuda()
    params, c2w = scene_numpy(n=300, seed=13, sh_degree=3, sh_rest_scale=0.1)
    gp = params_from_numpy(params, "cuda")
    cam = Camera.from_c2w(100, 72, 60.0, 60.0, c2w)
    cfg = RasterizerConfig(max_pairs=8192, tile_w=16, tile_h=16, chunk_size=32)
    for inference in (True, False):
        leaves = {k: v.detach().clone().requires_grad_(not inference)
                  for k, v in gp.tensors().items()}
        fwd, bwd = _launches(FWD_KERNELS), _launches(BWD_KERNELS)
        out, aux = render(*activations(leaves), *_camera(cam, "cuda", True), 100, 72, 3,
                          raster_cfg=cfg, inference=inference)
        assert _launches(FWD_KERNELS) == [c + 1 for c in fwd]
        if not inference:
            out.color.square().sum().backward()
            assert all(torch.isfinite(v.grad).all() for v in leaves.values())
        torch.cuda.synchronize()
        assert int(aux.overflow_pairs) == 0 and int(aux.num_pairs) > 0
        assert _launches(BWD_KERNELS) == [c + (not inference) for c in bwd]
