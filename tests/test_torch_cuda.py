"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs on a GPU machine without it.  Every test is
marked ``cuda`` and skips when no CUDA device is present; on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import require_cuda, scene_numpy, to_numpy

from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
from gaussiansplattingmlx_tpu_torch.ops import binning, merge_cuda, projection
from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, rasterize_ref, staging
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

pytestmark = pytest.mark.cuda


def _camera_tensors(width, height, focal, c2w, device):
    t = Camera.from_c2w(width, height, focal, focal, c2w).tensors()
    return [torch.as_tensor(np.asarray(t[k])).to(device) for k in
            ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")]


def _staged(n, seed, width, height, tile, max_pairs, device):
    params, c2w = scene_numpy(n=n, seed=seed, sh_degree=3, sh_rest_scale=0.1)
    gp = params_from_numpy(params, device)
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(gp)
        view, proj, center, fovx, fovy, fx, fy = _camera_tensors(width, height, 60.0, c2w, device)
        p = projection.project_gaussians(means, scales, rots, shs, view, proj, center,
                                         fovx, fovy, fx, fy, width, height, 3)
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity, p.depths)
        st = staging.StagingStatic(width, height, tile, tile, max_pairs, 32)
        args = (packed, p.rect_min, p.rect_max, p.radii, p.depths)
        return st, args, staging.stage_pairs_sorted(st, *args)


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("budget_delta", [-777, 0, 1001])
def test_merge_gather_kernel_matches_plain(budget_delta):
    require_cuda()
    gen = torch.Generator().manual_seed(11)
    n = 5000
    foot = torch.randint(1, 9, (n,), generator=gen)
    foot[3000] = 2 ** 31 - 1  # saturated tail
    cum = binning._saturating_cumsum(foot)
    cum[-500:] = binning._CUM_CLAMP + 1  # compacted-away gaussians
    total = int(cum[2999])
    table = torch.randn((merge_cuda.TBL_ROWS, n), generator=gen)
    for c in (cum, cum[:3000].contiguous()):
        tb = table[:, :c.shape[0]].contiguous().cuda()
        c = c.cuda()
        before = merge_cuda.KERNEL.launches
        got = merge_cuda.merge_gather(c, tb, total + budget_delta)
        torch.cuda.synchronize()
        assert merge_cuda.KERNEL.launches == before + 1
        want = merge_cuda.merge_gather_plain(c, tb, total + budget_delta)
        assert _bit_equal(got, want)
    if budget_delta > 0:
        assert bool((got[:, total:] == 0).all())


@pytest.mark.parametrize("tile", [16, 32])
def test_raster_fwd_kernel_matches_plain(tile):
    require_cuda()
    width, height = 100, 72
    st, _, sp = _staged(300, 13, width, height, tile, 8192, "cuda")
    assert int(sp.overflow_pairs) == 0 and int(sp.num_pairs) > 0
    grid_w, grid_h = -(-width // tile), -(-height // tile)
    args = (sp.records_cm, sp.tile_start, sp.tile_count, grid_w, grid_h, tile, tile)
    before = rasterize_cuda.KERNEL.launches
    got = rasterize_cuda.raster_fwd(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.KERNEL.launches == before + 1
    want = rasterize_cuda.raster_fwd_plain(*args)
    torch.testing.assert_close(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[:, 4], want[:, 4], rtol=1e-4, atol=1e-5)
    assert float((got[:, 5] != want[:, 5]).float().mean()) <= 0.003


def test_raster_fwd_kernel_include_rule():
    """Same buffer as tests/test_torch_rasterize.py's include-rule test."""
    require_cuda()
    n = 6
    records = torch.zeros((16, n + 32))
    records[0:2, :n] = 5.0
    records[2, :n] = records[5, :n] = 2.0
    records[6:9, :n] = torch.linspace(0.1, 0.9, 3 * n).reshape(3, n)
    records[9, :n] = torch.arange(1, n + 1)
    records[10, :5] = 0.95
    start = torch.zeros(1, dtype=torch.int32)
    count = torch.full((1,), n, dtype=torch.int32)
    out = rasterize_cuda.rasterize_staged(records.cuda(), start.cuda(), count.cuda(),
                                          16, 16, 16, 16)
    assert int(out.n_contrib[5, 5]) == 4 and int(out.n_contrib[15, 15]) == n
    assert abs(float(out.alpha[5, 5]) - (1 - 0.05 ** 4)) < 1e-6
    assert bool(torch.isfinite(out.color).all())


def test_staging_on_card_matches_cpu():
    """Index machinery on the card (merge-gather kernel, sort, searchsorted)
    gives the CPU's bit-exact staged buffer."""
    require_cuda()
    _, _, cpu = _staged(300, 3, 100, 72, 16, 8192, "cpu")
    _, _, gpu = _staged(300, 3, 100, 72, 16, 8192, "cuda")
    for name in cpu._fields:
        a, b = getattr(cpu, name), getattr(gpu, name).cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:
            # Projection runs on each device; records may differ in the last
            # bits, the pair order may not.
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b), name


def test_render_card_matches_cpu():
    require_cuda()
    params, c2w = scene_numpy(n=300, seed=7, sh_degree=3, sh_rest_scale=0.1)
    cfg = RasterizerConfig(max_pairs=8192)
    outs = []
    for device in ("cpu", "cuda"):
        gp = params_from_numpy(params, device)
        with torch.no_grad():
            means, shs, opacity, scales, rots = activations(gp)
        cam = _camera_tensors(100, 72, 60.0, c2w, device)
        outs.append(render(means, shs, opacity, scales, rots, *cam, 100, 72, 3,
                           raster_cfg=cfg, inference=True))
    (c, ca), (g, ga) = outs
    assert int(ca.num_pairs) == int(ga.num_pairs) > 0
    np.testing.assert_allclose(to_numpy(g.color), to_numpy(c.color), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_numpy(g.depth), to_numpy(c.depth), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_numpy(g.alpha), to_numpy(c.alpha), rtol=1e-4, atol=1e-5)


def test_projection_full_f32_with_tf32_allowed():
    """Projection uses no matmul, so allowing TF32 on the card changes
    nothing: it still matches the CPU at the float32 parity tolerance."""
    require_cuda()
    params, c2w = scene_numpy(n=300, seed=9, sh_degree=3, sh_rest_scale=0.1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        outs = []
        for device in ("cpu", "cuda"):
            gp = params_from_numpy(params, device)
            with torch.no_grad():
                means, shs, opacity, scales, rots = activations(gp)
                cam = _camera_tensors(100, 72, 60.0, c2w, device)
                outs.append(projection.project_gaussians(
                    means, scales, rots, shs, *cam, 100, 72, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu, gpu = outs
    for name in ("means2d", "depths", "conic", "colors"):
        np.testing.assert_allclose(to_numpy(getattr(gpu, name)), to_numpy(getattr(cpu, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(to_numpy(gpu.radii), to_numpy(cpu.radii))
