"""Port forward compositing (raster_fwd_plain, what the CPU runs) vs the JAX
package's rasterize_staged in Pallas interpret mode, on the same staged
sorted-order record buffer (built by the JAX staging), at the JAX package's
own Pallas-vs-oracle tolerances."""

import numpy as np
import jax.numpy as jnp
import pytest
from torch_port_helpers import (
    CHUNK, TILE, assert_images_close, outputs_numpy, to_torch,
)

from gaussiansplattingmlx_tpu.ops import rasterize_pallas as jax_rp
from gaussiansplattingmlx_tpu.ops import rasterize_ref as jax_ref
from gaussiansplattingmlx_tpu.ops import staging as jax_staging
from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, rasterize_ref


def _synthetic(rng, n, width, height, opacity_range=(0.2, 0.9), corner=False,
               zero_opacity_every=0):
    """Screen-space gaussians as in tests/test_rasterize_pallas.py:make_scene,
    as the JAX staging's inputs (packed, rect_min, rect_max, radii, depths)."""
    extent = 12.0 if corner else max(width, height) - 2
    means2d = rng.uniform(2, extent, size=(n, 2)).astype(np.float32)
    if not corner:
        means2d[:, 0] *= width / max(width, height)
        means2d[:, 1] *= height / max(width, height)
    sigma = rng.uniform(1.0, 4.0, size=n).astype(np.float32)
    conic = np.zeros((n, 4), np.float32)
    conic[:, 0] = conic[:, 3] = 1.0 / sigma ** 2
    off = rng.uniform(-0.02, 0.02, size=n).astype(np.float32)
    conic[:, 1] = conic[:, 2] = off
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(*opacity_range, size=(n, 1)).astype(np.float32)
    if zero_opacity_every:
        opacity[::zero_opacity_every] = 0.0
    depths = rng.uniform(1.0, 10.0, size=n).astype(np.float32)
    radii = (3 * sigma).astype(np.float32)
    rect_min = np.maximum(means2d - radii[:, None], 0.0)
    rect_max = np.minimum(means2d + radii[:, None],
                          np.array([width - 1, height - 1], np.float32))
    packed = np.concatenate([means2d, conic, colors, opacity, depths[:, None]], axis=1)
    return packed, rect_min, rect_max, radii, depths


def _occluded_stack(n=96, size=32):
    """Near-opaque wide gaussians stacked over the whole image: pixels near
    the centre stop after a few records (the early exit)."""
    rng = np.random.default_rng(17)
    means2d = np.full((n, 2), size / 2, np.float32)
    conic = np.zeros((n, 4), np.float32)
    conic[:, 0] = conic[:, 3] = 0.01
    colors = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    opacity = np.full((n, 1), 0.98, np.float32)
    depths = np.arange(1, n + 1, dtype=np.float32)
    radii = np.full((n,), size / 2, np.float32)
    rect_min = np.zeros((n, 2), np.float32)
    rect_max = np.full((n, 2), size - 1, np.float32)
    packed = np.concatenate([means2d, conic, colors, opacity, depths[:, None]], axis=1)
    return packed, rect_min, rect_max, radii, depths


def _stage_jax(args, width, height, max_pairs=4096):
    st = jax_staging.StagingStatic(
        image_width=width, image_height=height, tile_w=TILE, tile_h=TILE,
        max_pairs=max_pairs, chunk=CHUNK, num_rec=args[0].shape[0],
        grad_reduce="scatter", interpret=True,
    )
    sp = jax_staging.stage_pairs_sorted(st, *(jnp.asarray(a) for a in args))
    assert int(sp.overflow_pairs) == 0
    return np.asarray(sp.records_cm), np.asarray(sp.tile_start), np.asarray(sp.tile_count)


def _both(records_cm, tile_start, tile_count, width, height, white=False):
    want = jax_rp.rasterize_staged(
        jnp.asarray(records_cm), jnp.asarray(tile_start), jnp.asarray(tile_count),
        width, height, TILE, TILE, chunk_size=CHUNK, interpret=True,
    )
    got = rasterize_cuda.rasterize_staged(
        to_torch(records_cm), to_torch(tile_start), to_torch(tile_count),
        width, height, TILE, TILE,
    )
    want = want._replace(color=jax_ref.apply_background(want.color, want.alpha, white))
    got = got._replace(color=rasterize_ref.apply_background(got.color, got.alpha, white))
    return outputs_numpy(got), outputs_numpy(want)


CASES = {
    # name: (width, height, function making the scene)
    "occlusion": (32, 32, lambda: _occluded_stack()),
    "empty_tiles": (64, 64, lambda: _synthetic(np.random.default_rng(1), 6, 64, 64,
                                               corner=True)),
    "non_tile_multiple": (50, 40, lambda: _synthetic(np.random.default_rng(2), 30, 50, 40)),
    "zero_opacity": (48, 40, lambda: _synthetic(np.random.default_rng(3), 30, 48, 40,
                                                zero_opacity_every=3)),
}


@pytest.mark.parametrize("case,white", [
    ("occlusion", False), ("empty_tiles", False), ("non_tile_multiple", False),
    ("non_tile_multiple", True), ("zero_opacity", False),
])
def test_raster_plain_matches_jax_interpret(case, white):
    width, height, build = CASES[case]
    staged = _stage_jax(build(), width, height)
    got, want = _both(*staged, width, height, white=white)
    assert got["color"].shape == (height, width, 3)
    assert np.isfinite(got["color"]).all() and np.isfinite(got["alpha"]).all()
    assert_images_close(got, want)
    counts = staged[2]
    if case == "occlusion":
        # Pixels near the centre stop after a few of their tile's records.
        assert got["n_contrib"].min() < counts.max() // 8, "early exit did not bite"
    if case == "empty_tiles":
        assert (counts == 0).sum() > counts.size // 2
        assert (got["alpha"][32:, 32:] == 0).all()


def test_include_rule_and_integer_pixel_centres():
    """Five records centred exactly on pixel (5, 5), alpha 0.95 there: the
    transmittance before records 1..5 is 1, .05, .0025, 1.25e-4, 6.25e-6, so
    the rule "T before the record >= 1e-4" takes four (INRIA's
    "T * (1 - a) < 1e-4 -> break" would take three).  Pixel coordinates are
    integers: a +0.5 offset would put the pixel 0.7 sigma off every centre.
    Far pixels take every record, however tiny its alpha, and a zero-opacity
    record gives alpha 0, not NaN.  Checked against the JAX kernel too."""
    n = 6
    records = np.zeros((16, n + CHUNK), np.float32)
    records[0:2, :n] = 5.0  # mean (5, 5)
    records[2, :n] = records[5, :n] = 2.0  # c00 = c11 = 2: narrow
    records[6:9, :n] = np.linspace(0.1, 0.9, 3 * n).reshape(3, n)
    records[9, :n] = np.arange(1, n + 1)  # depth
    records[10, :5] = 0.95
    records[10, 5] = 0.0  # zero opacity, taken while T >= 1e-4
    start = np.zeros(1, np.int32)
    count = np.full(1, n, np.int32)
    got, want = _both(records, start, count, TILE, TILE)
    assert got["n_contrib"][5, 5] == 4
    np.testing.assert_allclose(got["alpha"][5, 5], 1 - 0.05 ** 4, rtol=1e-6)
    assert got["n_contrib"][15, 15] == n
    assert np.isfinite(got["color"]).all()
    assert_images_close(got, want, ncon_slack=0.0)
