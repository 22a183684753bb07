"""The training slice's staging and kernels' plain versions against the JAX
package, on the same inputs: training staging (bit-exact), the per-pair
backward rows (K3's plain version vs the VJP of the JAX rasterizer core in
Pallas interpret mode) and the per-Gaussian segment sum (K4's plain version
vs the JAX segment-sum kernel in interpret mode)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (
    CHUNK, H, MAX_PAIRS, TILE, W, jax_geometry, scene_numpy, to_numpy, to_torch,
)
from test_torch_rasterize import CASES as RASTER_CASES
from test_torch_staging import CASES, assert_bit_equal

from gaussiansplattingmlx_tpu.ops import rasterize_pallas as jax_rp
from gaussiansplattingmlx_tpu.ops import staging as jax_staging
from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, segsum_cuda, staging


def _statics(max_pairs, n, grad_reduce="scatter"):
    jst = jax_staging.StagingStatic(
        image_width=W, image_height=H, tile_w=TILE, tile_h=TILE,
        max_pairs=max_pairs, chunk=CHUNK, num_rec=n, grad_reduce=grad_reduce,
        interpret=True,
    )
    tst = staging.StagingStatic(W, H, TILE, TILE, max_pairs, CHUNK)
    return jst, tst


def _geometry(seed, n):
    params, c2w = scene_numpy(n=n, seed=seed)
    return jax_geometry(params, c2w)


def assert_rows_close(got, want, rtol=2e-3, atol=2e-4):
    """The JAX package's Pallas-vs-oracle gradient tolerance
    (tests/test_rasterize_pallas.py), with atol scaled by each row's largest
    magnitude: the rows differ in scale by orders of magnitude (a conic
    gradient is ~pixels^2 times a colour gradient)."""
    for r in range(want.shape[0]):
        scale = max(float(np.abs(want[r]).max()), 1e-30)
        np.testing.assert_allclose(got[r], want[r], rtol=rtol, atol=atol * scale,
                                   err_msg=f"row {r}")


@pytest.mark.parametrize("seed,n,max_pairs", CASES)
def test_stage_pairs_train_matches_jax(seed, n, max_pairs):
    args = _geometry(seed, n)
    jst, tst = _statics(max_pairs, n)
    want, want_gid = jax_staging._stage_train_impl(jst, *(jnp.asarray(a) for a in args))
    got, got_gid = staging._stage_train_impl(tst, *(to_torch(a) for a in args))
    assert got.records_cm.shape == (16, max_pairs + staging._train_pad(tst))
    assert got.records_cm.shape[1] % 512 == 0
    for name in got._fields:
        assert_bit_equal(to_numpy(getattr(got, name)), getattr(want, name), name)
    assert_bit_equal(to_numpy(got_gid), want_gid, "gid")
    assert int(got.num_pairs) > 0
    # The autograd wrapper stages the same buffer.
    via_fn = staging.stage_pairs_train(tst, *(to_torch(a) for a in args))
    assert_bit_equal(to_numpy(via_fn.records_cm), want.records_cm, "records via Function")


@pytest.mark.parametrize("seed,n,max_pairs", [(3, 80, MAX_PAIRS), (3, 240, 512)])
def test_stage_pairs_train_backward_matches_jax(seed, n, max_pairs):
    """d packed from a random record cotangent: the sort + K4 (plain) +
    layout permutation against the JAX staging VJP (sort + segment-sum
    kernel, interpret mode).  rtol 1e-5: the two sum each segment in another
    order; atol 1e-6 of the largest entry covers sums that cancel."""
    args = _geometry(seed, n)
    jst, tst = _statics(max_pairs, n, grad_reduce="segsum")
    total = max_pairs + staging._train_pad(tst)
    cot = np.random.default_rng(seed).normal(size=(16, total)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]

    def f(packed):
        return jax_staging.stage_pairs_train(jst, packed, *jargs[1:]).records_cm

    _, vjp = jax.vjp(f, jargs[0])
    (want,) = vjp(jnp.asarray(cot))
    packed = to_torch(args[0]).requires_grad_()
    sp = staging.stage_pairs_train(tst, packed, *(to_torch(a) for a in args[1:]))
    sp.records_cm.backward(to_torch(cot))
    got = to_numpy(packed.grad)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    # Gaussians with no pair get exactly zero.
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


@pytest.mark.parametrize("seed,skewed", [(3, False), (13, False), (3, True)],
                         ids=["3", "13", "skewed"])
def test_segment_sum_plain_matches_jax_segsum(seed, skewed):
    """K4's plain version against `_segment_reduce_pallas` on the real gid of
    a staged scene and random rows (rtol 1e-5, see above).  ``skewed``: one
    Gaussian takes 80% of the used columns, as one that covers most tiles
    does, and the JAX kernel sweeps chunks of 128 columns, so its segment
    spans several of them."""
    n = 80
    args = _geometry(seed, n)
    jst, tst = _statics(MAX_PAIRS, n)
    _, gid = staging._stage_train_impl(tst, *(to_torch(a) for a in args))
    if skewed:
        g = to_numpy(gid).copy()
        used = np.flatnonzero(g < n)
        g[used[: len(used) * 4 // 5]] = 7
        gid = to_torch(g)
        counts = np.bincount(g[g < n], minlength=n)
        assert counts[7] > 2 * 128 and counts[7] > 0.8 * counts.sum() - 1
    total = gid.shape[0]
    rows = np.random.default_rng(seed).normal(size=(16, total)).astype(np.float32)
    rows[4] = rows[3]  # the backward writes d_cs to both rows
    sst = jax_rp.SegsumStatic(num_rec=n, num_aligned=total, chunk=128 if skewed else 512,
                              block_b=128, interpret=True, live_rows=jax_rp.RASTER_LIVE_ROWS)
    want = np.array(jax_rp._segment_reduce_pallas(sst, jnp.asarray(rows),
                                                    jnp.asarray(to_numpy(gid))))
    want[:, 4] = want[:, 3]
    got = to_numpy(segsum_cuda.segment_reduce(to_torch(rows), gid, n))
    assert got.shape == (n, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got[:, 11:], 0.0)
    rows_s, offsets = segsum_cuda.sort_by_gid(to_torch(rows), gid, n)
    assert int(offsets[-1]) == int((gid < n).sum())
    np.testing.assert_array_equal(
        to_numpy(segsum_cuda.segment_sum_sorted_plain(rows_s, offsets)), got)


@pytest.mark.parametrize("seed", [3, 13])
def test_sort_by_gid_gathers_like_one_gather(seed):
    """``sort_by_gid`` takes the live rows through the gid permutation (two
    gathers: the rows, then the columns); it must give the bits of one
    two-index gather and of the list-indexed form it had before, the stable
    sort's offsets, and a contiguous result."""
    n = 80
    args = _geometry(seed, n)
    _, tst = _statics(MAX_PAIRS, n)
    _, gid = staging._stage_train_impl(tst, *(to_torch(a) for a in args))
    rows = to_torch(np.random.default_rng(seed).normal(size=(16, gid.shape[0])).astype(np.float32))
    rows_s, offsets = segsum_cuda.sort_by_gid(rows, gid, n)
    _, perm = torch.sort(torch.clamp(gid, max=n), stable=True)
    assert rows_s.is_contiguous() and rows_s.shape == (10, gid.shape[0])
    live = torch.tensor(segsum_cuda.LIVE_ROWS)
    assert_bit_equal(to_numpy(rows_s), to_numpy(rows[live[:, None], perm]), "one gather")
    assert_bit_equal(to_numpy(rows_s), to_numpy(rows[list(segsum_cuda.LIVE_ROWS)][:, perm]),
                     "list-indexed gathers")
    g = to_numpy(gid)
    want = np.searchsorted(np.sort(np.minimum(g, n), kind="stable"), np.arange(n + 1))
    np.testing.assert_array_equal(to_numpy(offsets), want)


def _raster_jax_vjp(records, start, count, width, height, cot):
    grid_w, grid_h = -(-width // TILE), -(-height // TILE)
    st = jax_rp.RasterStatic(
        chunk=CHUNK, tile_h=TILE, tile_w=TILE, grid_h=grid_h, grid_w=grid_w,
        num_aligned=records.shape[1], alpha_clamp=0.99, transmittance_eps=1e-4,
        undo_denom_floor=1e-6, interpret=True, sorted_mode=True,
    )
    s, c = jnp.asarray(start), jnp.asarray(count)
    out, vjp = jax.vjp(lambda r: jax_rp._raster_core(st, r, s, c), jnp.asarray(records))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("case", sorted(RASTER_CASES) + ["scene"])
def test_raster_bwd_plain_matches_jax_vjp(case):
    """Per-pair gradient rows of K3's plain version against the VJP of the
    JAX package's rasterizer core (sorted mode, interpret) on the same
    staged buffer and a random output cotangent."""
    if case == "scene":
        width, height, args = W, H, _geometry(13, 80)
    else:
        width, height, build = RASTER_CASES[case]
        args = build()
    jst = jax_staging.StagingStatic(
        image_width=width, image_height=height, tile_w=TILE, tile_h=TILE,
        max_pairs=MAX_PAIRS, chunk=CHUNK, num_rec=args[0].shape[0],
        grad_reduce="scatter", interpret=True,
    )
    sp, _ = jax_staging._stage_train_impl(jst, *(jnp.asarray(a) for a in args))
    records, start, count = (np.asarray(x) for x in (sp.records_cm, sp.tile_start,
                                                      sp.tile_count))
    grid_w, grid_h = -(-width // TILE), -(-height // TILE)
    cot = np.random.default_rng(5).normal(
        size=(grid_w * grid_h, 6, TILE * TILE)).astype(np.float32)
    out, want = _raster_jax_vjp(records, start, count, width, height, cot)
    alpha_ncon = to_torch(out[:, 4:6])
    block = rasterize_cuda.cotangent_block(to_torch(cot), alpha_ncon)
    got = to_numpy(rasterize_cuda.raster_bwd(
        to_torch(records), to_torch(start), to_torch(count), block,
        grid_w, grid_h, TILE, TILE))
    assert got.shape == want.shape == records.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    if case == "occlusion":
        # The JAX kernel rebuilds each pixel's transmittances from the stored
        # alpha (T_final = 1 - alpha): where a pixel ends near T = 1e-6 that
        # loses a few percent of T_final, which autograd of the plain forward
        # does not.  The JAX package's own tolerance for its early-exit
        # gradient (tests/test_rasterize_pallas.py:171) applies.
        assert_rows_close(got, want, rtol=5e-3, atol=5e-4)
    else:
        assert_rows_close(got, want)
    np.testing.assert_array_equal(got[11:], 0.0)
    np.testing.assert_array_equal(got[3], got[4])
    # Columns no tile replays (past the pairs, the pad) stay exactly zero.
    np.testing.assert_array_equal(got[:, int(sp.num_pairs):], 0.0)


def test_raster_autograd_function_routes_to_the_backward():
    """rasterize_staged on records that require grad: the cotangent that
    reaches the records is raster_bwd of the output cotangent."""
    args = _geometry(3, 80)
    _, tst = _statics(MAX_PAIRS, 80)
    sp, _ = staging._stage_train_impl(tst, *(to_torch(a) for a in args))
    records = sp.records_cm.clone().requires_grad_()
    out = rasterize_cuda.rasterize_staged(records, sp.tile_start, sp.tile_count,
                                          W, H, TILE, TILE)
    target = torch.as_tensor(np.random.default_rng(2).uniform(size=(H, W, 3)),
                             dtype=torch.float32)
    loss = torch.sum((out.color - target) ** 2) + torch.sum(out.depth) + torch.sum(out.alpha)
    loss.backward()
    grid = -(-W // TILE)
    fwd = rasterize_cuda.raster_fwd(sp.records_cm, sp.tile_start, sp.tile_count,
                                    grid, grid, TILE, TILE)
    cot = torch.zeros_like(fwd)
    tiles = 2 * (out.color.detach() - target)  # [H, W, 3] -> per-tile layout
    tiles = tiles.permute(2, 0, 1).reshape(3, grid, TILE, grid, TILE)
    cot[:, 0:3] = tiles.permute(1, 3, 0, 2, 4).reshape(grid * grid, 3, TILE * TILE)
    cot[:, 3:5] = 1.0
    want = rasterize_cuda.raster_bwd(
        sp.records_cm, sp.tile_start, sp.tile_count,
        rasterize_cuda.cotangent_block(cot, fwd[:, 4:6]), grid, grid, TILE, TILE)
    torch.testing.assert_close(records.grad, want, rtol=1e-6, atol=1e-6)


def test_raster_bwd_rejects_unsupported_device():
    rec = torch.zeros((16, 64), device="meta")
    i32 = torch.zeros(9, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rasterize_cuda.raster_bwd(rec, i32, i32, torch.zeros((9, 256, 8), device="meta"),
                                  3, 3, 16, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        segsum_cuda.segment_sum_sorted(torch.zeros((10, 64), device="meta"),
                                       torch.zeros(5, dtype=torch.int32, device="meta"))
