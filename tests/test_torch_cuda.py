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


def _fwd_edge_buffer(tile, layout, device):
    """K1's arguments on a 200x144 record buffer (no multiple of any tile)
    that holds its edge cases: the scene's tiles, with empty ones and ones
    past the image edge, in the sorted layout (unaligned starts) or the
    chunk-aligned one (chunk 32: zero-padded columns after each tile's
    records); then tiles 0-2 rewritten: tile 0 takes 601 faint records
    (several batches of any block, no multiple of one, all taken by every
    pixel), tile 1 300 opaque, broad ones (every pixel stops after 4, within
    the first batch), tile 2 none.  Their columns follow the buffer from an
    odd offset."""
    width, height = 200, 144
    st, args, sp = _staged(300, 13, width, height, tile, 16384, device)
    start = sp.tile_start
    if layout == "aligned":
        sp, _ = staging._stage_impl(st, *args)
        start = sp.aligned_start
    start, count = start.cpu().clone(), sp.tile_count.cpu().clone()
    assert int((count == 0).sum()) > 1
    gen = torch.Generator().manual_seed(tile)
    grid_w, grid_h = -(-width // tile), -(-height // tile)

    def tile_records(t, n, opacity, conic):
        r = torch.zeros((16, n))
        r[0] = (t % grid_w) * tile + torch.rand(n, generator=gen) * tile
        r[1] = (t // grid_w) * tile + torch.rand(n, generator=gen) * tile
        r[2] = r[5] = conic
        r[3] = r[4] = 0.1 * conic
        r[6:9] = torch.rand((3, n), generator=gen)
        r[9] = torch.linspace(1.0, 2.0, n)
        r[10] = opacity
        return r

    cols = sp.records_cm.shape[1]
    records = torch.cat([sp.records_cm.cpu(), torch.zeros((16, 1)),
                         tile_records(0, 601, 0.01, 0.02),
                         tile_records(1, 300, 0.95, 1e-6)], dim=1)
    start[0], count[0] = cols + 1, 601
    start[1], count[1] = cols + 1 + 601, 300
    count[2] = 0
    return (records.to(device), start.to(device), count.to(device), grid_w, grid_h, tile, tile)


def _assert_fwd_close(got, want):
    """K1's tolerances against its plain version (the JAX package's
    Pallas-vs-oracle image tolerances)."""
    torch.testing.assert_close(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[:, 4], want[:, 4], rtol=1e-4, atol=1e-5)
    assert float((got[:, 5] != want[:, 5]).float().mean()) <= 0.003


@pytest.mark.parametrize("layout", ["sorted", "aligned"])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_raster_fwd_kernel_edge_cases(tile, layout):
    """K1 at each of its block shapes (one block of 64 pixels a tile at tile
    8, two of 128 at tile 16, eight at tile 32) on _fwd_edge_buffer: within
    tolerance of the plain version, bit-identical over two launches, one
    launch counted a call; the long tile takes all 601 records, the opaque
    one stops at 4, the empty one is clear; the cropped image equals the
    plain version's crop."""
    require_cuda()
    args = _fwd_edge_buffer(tile, layout, "cuda")
    before = rasterize_cuda.KERNEL.launches
    got = rasterize_cuda.raster_fwd(*args)
    again = rasterize_cuda.raster_fwd(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.KERNEL.launches == before + 2
    assert _bit_equal(got, again), "two launches differ"
    assert bool(torch.isfinite(got).all())
    want = rasterize_cuda.raster_fwd_plain(*args)
    _assert_fwd_close(got, want)
    assert bool((got[0, 5] == 601).all()) and bool((got[1, 5] == 4).all())
    assert bool((got[2] == 0).all())
    img = rasterize_cuda.rasterize_staged(*args[:3], 200, 144, tile, tile)
    crop = rasterize_cuda._untile(want, *args[3:], 200, 144)
    assert img.color.shape == (144, 200, 3)
    torch.testing.assert_close(img.color, crop.color, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(img.alpha, crop.alpha, rtol=1e-4, atol=1e-5)


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


def _train_staged(n, seed, width, height, tile, max_pairs, device):
    """Training staging of a scene with a random output cotangent block:
    (static, staged, cotangent block)."""
    from gaussiansplattingmlx_tpu_torch.ops import staging as st_mod

    st, args, _ = _staged(n, seed, width, height, tile, max_pairs, device)
    sp, gid = st_mod._stage_train_impl(st, *args)
    grid_w, grid_h = -(-width // tile), -(-height // tile)
    fwd = rasterize_cuda.raster_fwd(sp.records_cm, sp.tile_start, sp.tile_count,
                                    grid_w, grid_h, tile, tile)
    gen = torch.Generator().manual_seed(seed)
    cot = torch.randn(fwd.shape, generator=gen).to(device)
    return st, sp, gid, rasterize_cuda.cotangent_block(cot, fwd[:, 4:6])


def _assert_rows_close(got, want, rtol=2e-3, atol=2e-4):
    """The JAX package's Pallas-vs-oracle gradient tolerance, atol scaled by
    each row's largest magnitude."""
    for r in range(want.shape[0]):
        scale = max(float(want[r].abs().max()), 1e-30)
        torch.testing.assert_close(got[r], want[r], rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("tile", [16, 32])
def test_raster_bwd_kernel_matches_plain(tile):
    require_cuda()
    width, height = 100, 72
    st, sp, _, block = _train_staged(300, 13, width, height, tile, 8192, "cuda")
    grid_w, grid_h = -(-width // tile), -(-height // tile)
    args = (sp.records_cm, sp.tile_start, sp.tile_count, block, grid_w, grid_h, tile, tile)
    before = rasterize_cuda.BWD_KERNEL.launches
    got = rasterize_cuda.raster_bwd(*args)
    again = rasterize_cuda.raster_bwd(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.BWD_KERNEL.launches == before + 2
    assert _bit_equal(got, again), "two launches differ"
    want = rasterize_cuda.raster_bwd_plain(*args)
    assert bool(torch.isfinite(got).all())
    _assert_rows_close(got, want)
    assert bool((got[11:] == 0).all()) and torch.equal(got[3], got[4])


def _segsum_span(segsum_cuda) -> int:
    """Path steps (columns and segment ends) a stretch of K4 takes:
    carries(c, 0) = ceil(c / span) first exceeds 1 at c = span + 1."""
    carries = segsum_cuda._carries_fn()
    return next(c for c in range(1, 1 << 16) if carries(c + 1, 0) > 1)


def _segsum_case(case, segsum_cuda):
    """(rows_s [10, P], offsets [num_rec + 1]) on the card for one of K4's
    cases.  "staged" draws its rows N(0, 1); the others draw integers in
    [-8, 8], whose partial sums are all exact in float32, so that any order
    of the adds gives the same bits."""
    gen = torch.Generator().manual_seed(3)

    def integers(shape):
        return torch.randint(-8, 9, shape, generator=gen).float().cuda()

    def hand_built(lengths, extra=7):
        offsets = torch.zeros(len(lengths) + 1, dtype=torch.int32)
        offsets[1:] = torch.cumsum(torch.as_tensor(lengths, dtype=torch.int64), 0)
        return integers((10, int(offsets[-1]) + extra)), offsets.cuda()

    if case == "staged":  # a staged scene's gid
        _, _, gid, _ = _train_staged(300, 7, 100, 72, 16, 8192, "cuda")
        rows = torch.randn((16, gid.shape[0]), generator=gen).cuda()
        return segsum_cuda.sort_by_gid(rows, gid, 300)
    span = _segsum_span(segsum_cuda)
    if case == "long":  # one segment across many stretches, short ones around it
        return hand_built([3, 0, 5] + [20_000] + [1, 0, 2] * 10)
    if case == "empty_runs":  # runs of empty segments longer than a stretch
        return hand_built([0] * (3 * span) + [4] + [0] * 1000 + [9, 0, 0, 1] + [0] * span)
    if case == "no_pairs":  # nothing used: every Gaussian gets exactly zero
        return hand_built([0] * 5000, extra=4096)
    if case == "one_gaussian":
        return hand_built([10_007], extra=0)
    if case == "block_starts":  # every segment starts on a stretch boundary
        # (segment g begins at path step offsets[g] + g = g * span)
        return hand_built([span - 1] * 40 + [2 * span - 1] + [span - 1] * 3)
    # "mixed": a staged gid with one Gaussian given 20,000 more columns, 513
    # columns of no Gaussian and 1,000 Gaussians with no pair appended,
    # through sort_by_gid
    _, _, gid, _ = _train_staged(300, 7, 100, 72, 16, 8192, "cuda")
    gid = torch.cat([gid, torch.full((20_000,), 5, dtype=torch.int32, device="cuda"),
                     torch.full((513,), 1300, dtype=torch.int32, device="cuda")])
    return segsum_cuda.sort_by_gid(integers((16, gid.shape[0])), gid, 1300)


@pytest.mark.parametrize("case", ["staged", "long", "empty_runs", "no_pairs", "one_gaussian",
                                  "block_starts", "mixed"])
def test_segsum_kernel_matches_plain(case):
    require_cuda()
    from gaussiansplattingmlx_tpu_torch.ops import segsum_cuda

    rows_s, offsets = _segsum_case(case, segsum_cuda)
    before = segsum_cuda.KERNEL.launches
    got = segsum_cuda.segment_sum_sorted(rows_s, offsets)
    again = segsum_cuda.segment_sum_sorted(rows_s, offsets)
    torch.cuda.synchronize()
    assert segsum_cuda.KERNEL.launches == before + 2
    assert _bit_equal(got, again), "two launches differ"
    want = segsum_cuda.segment_sum_sorted_plain(rows_s, offsets)
    # Another summation order than index_add_'s: rtol 1e-5, atol 1e-6 of
    # the largest sum for segments that cancel.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    if case != "staged":  # exact partial sums: the same bits
        assert torch.equal(got, want)
    assert torch.equal(got[:, 4], got[:, 3]) and bool((got[:, 11:] == 0).all())
    empty = (offsets[1:] == offsets[:-1]).cpu()
    assert bool((got.cpu()[empty] == 0).all()), "a Gaussian with no pair must get zeros"


def test_train_step_card_matches_cpu():
    """One training step from the same state on the card (K1-K4) and on the
    CPU (their plain versions): the same loss and, where the gradient is
    not tiny, the same updated parameters."""
    require_cuda()
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.train import trainer

    params, c2w = scene_numpy(n=300, seed=5, sh_degree=3, sh_rest_scale=0.1)
    images = np.random.default_rng(1).uniform(size=(1, 72, 100, 3)).astype(np.float32)
    data = TrainData([Camera.from_c2w(100, 72, 60.0, 60.0, c2w)], images)
    cfg = config.TrainConfig(iterations=10, model=config.ModelConfig(sh_degree=3),
                             raster=config.RasterizerConfig(max_pairs=8192))
    raw = {f"param_{k}": v for k, v in params.items()}
    raw.update({f"adam_{m}_{k}": np.zeros_like(v) for k, v in params.items() for m in "mv"})
    raw.update(adam_count=0, num_active=300, grad_accum=np.zeros(300), grad_denom=0.0,
               step=0, overflow_acc=np.zeros(2))
    results = []
    for device in ("cpu", "cuda"):
        state = trainer.state_from_numpy(raw, device)
        step = trainer.make_train_step(cfg, 100, 72, 3, 10)
        state, metrics, _ = step(state, trainer.stack_views(data, device), 0)
        results.append((state, {k: float(v) for k, v in metrics.items()}))
    (cs, cm), (gs, gm) = results
    assert gm["num_pairs"] == cm["num_pairs"] > 0 and gm["overflow_pairs"] == 0
    np.testing.assert_allclose(gm["loss"], cm["loss"], rtol=1e-4)
    assert gm["grad_coverage"] > 0
    for name in ("xyz", "features_dc", "scales", "opacity"):
        g = 10.0 * cs.m[name]  # m = 0.1 g after one step
        big = (g.abs() > 1e-3 * g.abs().max()).numpy()
        got = to_numpy(getattr(gs.params, name))
        want = to_numpy(getattr(cs.params, name))
        np.testing.assert_allclose(got[big], want[big], rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", ["saturated", "dense", "repeated", "small", "single"])
def test_merge_ranks_kernel_matches_plain(case):
    """K5 bit-exact against its plain version and torch.searchsorted.  Its
    blocks take merge_cuda.RANKS_BLOCK_SLOTS (B) slots; beside the
    compacted cumsum of binning (saturated and padding entries; footprint 1,
    whose owner windows hold B - 1 entries), the cases hold repeated values
    below the budget (one block's owner window longer than its shared
    buffer), n < B, a single entry, and budgets that are no multiple of B."""
    require_cuda()
    gen = torch.Generator().manual_seed(13)
    blk = merge_cuda.RANKS_BLOCK_SLOTS
    if case == "saturated":
        n = 5000
        foot = torch.randint(1, 9, (n,), generator=gen)
        foot[3000] = 2 ** 31 - 1
        cum = binning._saturating_cumsum(foot)
        cum[-500:] = binning._CUM_CLAMP + 1
        budgets = (int(cum[2999]) - 777, int(cum[2999]) + 1001)
    elif case == "dense":
        cum = torch.arange(1, 3 * blk + 7, dtype=torch.int32)
        budgets = (512, 2 * blk, 3 * blk + 100)
    elif case == "repeated":
        cum = torch.sort(torch.randint(0, 3000, (3 * blk,), generator=gen)).values.int()
        cum[blk:blk + 1500] = 1700  # one value repeated across a block edge
        budgets = (1, 4001, 2 * blk)
    elif case == "small":
        cum = torch.cumsum(torch.randint(1, 4, (300,), generator=gen), 0).int()
        budgets = (blk - 1, 5000)
    else:
        cum = torch.tensor([5], dtype=torch.int32)
        budgets = (3, 6, blk + 1)
    for budget in budgets:
        before = merge_cuda.RANKS_KERNEL.launches
        got = merge_cuda.merge_ranks(cum.cuda(), budget)
        torch.cuda.synchronize()
        assert merge_cuda.RANKS_KERNEL.launches == before + 1
        want = merge_cuda.merge_ranks_plain(cum, budget)
        assert torch.equal(got.cpu(), want), budget
        slots = torch.arange(budget, dtype=torch.int32)
        assert torch.equal(want, torch.searchsorted(cum, slots, right=True, out_int32=True))


@pytest.mark.parametrize("chunk", [32, 128])
def test_relayout_kernel_matches_plain(chunk):
    """Aligned staging on the card (K6) against K6's plain version on the
    same sorted records and plan, bit for bit: rows 0-11 (row 11 the
    gaussian id) and the zero columns."""
    require_cuda()
    from gaussiansplattingmlx_tpu_torch.ops import relayout_cuda

    st, args, _ = _staged(300, 3, 100, 72, 16, 8192, "cuda")
    st = st._replace(chunk=chunk)
    rec_rows, gid, start, count, _ = staging._sorted_pairs(st, *args)
    num_aligned = staging._num_aligned(st)
    _, owner, rank0 = rasterize_cuda.aligned_chunk_plan(count, chunk, num_aligned)
    sorted_cm = torch.cat([rec_rows, gid.to(torch.float32)[None]]).contiguous()
    before = relayout_cuda.KERNEL.launches
    got = relayout_cuda.relayout(sorted_cm, start, count, owner, rank0, chunk, num_aligned)
    torch.cuda.synchronize()
    assert relayout_cuda.KERNEL.launches == before + 1
    want = relayout_cuda.relayout_plain(sorted_cm, start, count, owner, rank0, chunk,
                                        num_aligned)
    assert _bit_equal(got, want)
    sp, gid_aligned = staging._stage_impl(st, *args)
    assert _bit_equal(sp.records_cm, want)
    assert int((gid_aligned < 300).sum()) == int(sp.num_pairs) > 0


@pytest.mark.parametrize("tile,chunk", [(16, 32), (16, 128), (32, 128)])
def test_raster_bwd_aligned_kernel_matches_plain(tile, chunk):
    """K7 on an aligned training buffer: bit-identical over two launches,
    within the gradient tolerance of its plain version, zero in every column
    it does not replay, and bit-equal to K3 run over the same buffer with the
    aligned starts (the two share their device code)."""
    require_cuda()
    width, height = 100, 72
    st, args, _ = _staged(300, 13, width, height, tile, 8192, "cuda")
    st = st._replace(chunk=chunk)
    sp, _ = staging._stage_impl(st, *args)
    grid_w, grid_h = -(-width // tile), -(-height // tile)
    fwd = rasterize_cuda.raster_fwd(sp.records_cm, sp.aligned_start, sp.tile_count,
                                    grid_w, grid_h, tile, tile)
    cot = torch.randn(fwd.shape, generator=torch.Generator().manual_seed(tile)).cuda()
    block = rasterize_cuda.cotangent_block(cot, fwd[:, 4:6])
    args = (sp.records_cm, sp.aligned_start, sp.tile_count, block, grid_w, grid_h, tile, tile)
    # Garbage in a reused allocation must not survive: K7 writes every column.
    torch.full((16, sp.records_cm.shape[1]), float("nan"), device="cuda")
    before = rasterize_cuda.BWD_ALIGNED_KERNEL.launches
    got = rasterize_cuda.raster_bwd_aligned(*args, chunk)
    again = rasterize_cuda.raster_bwd_aligned(*args, chunk)
    torch.cuda.synchronize()
    assert rasterize_cuda.BWD_ALIGNED_KERNEL.launches == before + 2
    assert _bit_equal(got, again), "two launches differ"
    assert bool(torch.isfinite(got).all())
    assert _bit_equal(got, rasterize_cuda.raster_bwd(*args))
    # A random cotangent on alpha reaches pixels that end near T = 1e-6,
    # where rebuilding T from the stored alpha loses a few percent (ROADMAP.md
    # §C): the JAX package's early-exit tolerance, rtol 5e-3 / atol 5e-4.
    _assert_rows_close(got, rasterize_cuda.raster_bwd_plain(*args),
                       rtol=5e-3, atol=5e-4)
    valid = torch.zeros(got.shape[1], dtype=torch.bool)
    for s, c in zip(sp.aligned_start.tolist(), sp.tile_count.tolist()):
        valid[s:s + c] = True
    assert bool((got[:, ~valid.cuda()] == 0).all()) and bool((got[11:] == 0).all())


def _replay_edge_buffer(tile, device):
    """An aligned training buffer at 200x144 (no multiple of either tile)
    whose cotangent block holds the replay's edge cases: tiles with count 0,
    tiles longer than a shared-memory batch whose count is no multiple of
    the record group (3), pixels with n_contrib 0, and one tile whose every
    pixel stops before its count.  The block's alpha is the forward's under
    that n_contrib, so it stays consistent with the replay.  Returns the
    (K3, K7 without chunk) argument tuple and the chunk."""
    width, height, chunk = 200, 144, 32
    st, args, _ = _staged(300, 13, width, height, tile, 16384, device)
    st = st._replace(chunk=chunk)
    sp, _ = staging._stage_impl(st, *args)
    count = sp.tile_count
    assert bool((count == 0).any()) and bool(((count > 96) & (count % 3 != 0)).any())
    grid_w, grid_h = -(-width // tile), -(-height // tile)
    fwd = rasterize_cuda.raster_fwd(sp.records_cm, sp.aligned_start, count, grid_w, grid_h,
                                    tile, tile)
    gen = torch.Generator().manual_seed(tile)
    ncon = fwd[:, 5].cpu()
    ncon[torch.rand(ncon.shape, generator=gen) < 0.1] = 0.0
    short = int(torch.nonzero(count.cpu() > 20)[0])
    ncon[short] = torch.minimum(ncon[short], torch.tensor(5.0))
    ncon = ncon.to(device)
    alpha = torch.zeros_like(fwd[:, 4])
    rec = sp.records_cm[:11]
    for ts, idx, valid in rasterize_cuda._tile_batches(sp.records_cm, sp.aligned_start, count,
                                                       tile * tile, 2 ** 22):
        alpha[ts] = rasterize_cuda._composite(rec[:, idx], valid, ts, grid_w, tile, tile, 0.99,
                                              1e-4, ncon=ncon[ts])[:, 4]
    cot = torch.randn(fwd.shape, generator=gen).to(device)
    block = rasterize_cuda.cotangent_block(cot, torch.stack([alpha, ncon], dim=1))
    return (sp.records_cm, sp.aligned_start, count, block, grid_w, grid_h, tile, tile), chunk


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_raster_bwd_replay_edge_cases(tile):
    """K3 and K7 at each of their block shapes (one pixel a thread in 64
    threads at tile 8, two in 128 at tile 16, four in 256 at tile 32) on
    _replay_edge_buffer: within tolerance of the plain version,
    bit-identical over two launches, K7 bit-equal to K3 on the same
    buffer."""
    require_cuda()
    args, chunk = _replay_edge_buffer(tile, "cuda")
    got = rasterize_cuda.raster_bwd(*args)
    again = rasterize_cuda.raster_bwd(*args)
    k7 = rasterize_cuda.raster_bwd_aligned(*args, chunk)
    k7_again = rasterize_cuda.raster_bwd_aligned(*args, chunk)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _bit_equal(got, again) and _bit_equal(k7, k7_again), "two launches differ"
    assert _bit_equal(k7, got)
    # A random cotangent on alpha: the early-exit tolerance, as in
    # test_raster_bwd_aligned_kernel_matches_plain (ROADMAP.md §C).
    _assert_rows_close(got, rasterize_cuda.raster_bwd_plain(*args), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("layout", ["aligned", "split"])
def test_train_step_layout_card_matches_cpu(layout):
    """One training step per non-default layout on the card (K5 or K6, K7)
    and on the CPU: the same loss and pair count, and K7 launched once."""
    require_cuda()
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.train import trainer

    params, c2w = scene_numpy(n=300, seed=5, sh_degree=3, sh_rest_scale=0.1)
    images = np.random.default_rng(1).uniform(size=(1, 72, 100, 3)).astype(np.float32)
    data = TrainData([Camera.from_c2w(100, 72, 60.0, 60.0, c2w)], images)
    cfg = config.TrainConfig(iterations=10, model=config.ModelConfig(sh_degree=3),
                             raster=config.RasterizerConfig(max_pairs=8192,
                                                            **config.LAYOUTS[layout]))
    raw = {f"param_{k}": v for k, v in params.items()}
    raw.update({f"adam_{m}_{k}": np.zeros_like(v) for k, v in params.items() for m in "mv"})
    raw.update(adam_count=0, num_active=300, grad_accum=np.zeros(300), grad_denom=0.0,
               step=0, overflow_acc=np.zeros(2))
    results = []
    for device in ("cpu", "cuda"):
        before = rasterize_cuda.BWD_ALIGNED_KERNEL.launches
        state = trainer.state_from_numpy(raw, device)
        step = trainer.make_train_step(cfg, 100, 72, 3, 10)
        _, metrics, _ = step(state, trainer.stack_views(data, device), 0)
        results.append({k: float(v) for k, v in metrics.items()})
    assert rasterize_cuda.BWD_ALIGNED_KERNEL.launches == before + 1
    cm, gm = results
    assert gm["num_pairs"] == cm["num_pairs"] > 0 and gm["overflow_pairs"] == 0
    np.testing.assert_allclose(gm["loss"], cm["loss"], rtol=1e-4)
    assert gm["grad_coverage"] > 0
