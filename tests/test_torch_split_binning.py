"""The split layout (RasterizerConfig.staging="split") against the JAX
package, on the same inputs: the owner ranks (K5's plain version vs the JAX
merge kernel in Pallas interpret mode), ``bin_gaussians`` (bit-exact), the
split rasterizer's chunk-aligned records against the port's own aligned
staging (bit-exact, as tests/test_staging.py holds the JAX package's two
layouts), and the layout end to end: render() images and gradients, the
inference render, and three Trainer steps."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (
    CHUNK, H, MAX_PAIRS, TILE, W, scene_numpy, to_numpy, to_torch,
)
from test_torch_aligned_staging import check_render_layout, check_train_steps_layout
from test_torch_staging import CASES, assert_bit_equal
from test_torch_train_staging import _geometry

from gaussiansplattingmlx_tpu.ops import binning as jax_binning
from gaussiansplattingmlx_tpu.ops import merge_pallas
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import binning, merge_cuda, rasterize_cuda, staging
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera


def _jax_ranks(cum, max_pairs):
    return np.asarray(merge_pallas.merge_ranks(jnp.asarray(cum, jnp.int32), max_pairs,
                                               interpret=True))


def _port_ranks(cum, max_pairs):
    cum = torch.as_tensor(np.asarray(cum, np.int32))
    got = merge_cuda.merge_ranks_plain(cum, max_pairs)
    # The dispatching wrapper takes the plain version for CPU tensors.
    assert torch.equal(merge_cuda.merge_ranks(cum, max_pairs), got)
    return to_numpy(got)


@pytest.mark.parametrize("case", ["random", "dense_boundaries", "saturated", "single",
                                  "small", "port_block_edges", "port_block_shifted"])
def test_merge_ranks_plain_matches_jax_interpret(case):
    """tests/test_binning.py's two cases (strictly increasing cumsums over
    block edges; footprint 1 everywhere, owners filling the kernel's window
    bound), a compacted cumsum with saturated and padding entries, and the
    edges of K5's blocks of merge_cuda.RANKS_BLOCK_SLOTS (B) slots that lie
    inside the JAX kernel's contract (strictly increasing below the clamp, a
    budget that is a multiple of its 512-slot block): one entry, n < B, and
    footprint-1 cumsums whose owner windows hold B - 1 entries, the most a
    block can have, starting at slot 1 and at slot B."""
    rng = np.random.default_rng(0)
    mp = 2 * merge_pallas.BLOCK
    blk = merge_cuda.RANKS_BLOCK_SLOTS
    if case == "random":
        cum = np.cumsum(rng.integers(1, 7, size=400))
    elif case == "dense_boundaries":
        mp = merge_pallas.BLOCK
        cum = np.arange(1, mp + 200)
    elif case == "single":
        cum = np.array([5])
    elif case == "small":
        mp = blk
        cum = np.cumsum(rng.integers(1, 4, size=300))
    elif case == "port_block_edges":
        mp = 2 * blk
        cum = np.arange(1, 2 * blk + 300)
    elif case == "port_block_shifted":
        mp = 2 * blk
        cum = np.arange(blk, 3 * blk + 1)
    else:
        foot = rng.integers(1, 6, size=300)
        foot[200] = 2 ** 31 - 1
        cum = to_numpy(binning._saturating_cumsum(torch.as_tensor(foot)))
        cum[-40:] = binning._CUM_CLAMP + 1
    got = _port_ranks(cum, mp)
    assert got.dtype == np.int32
    assert_bit_equal(got, _jax_ranks(cum, mp))
    np.testing.assert_array_equal(got, np.searchsorted(cum, np.arange(mp), side="right"))


@pytest.mark.parametrize("seed,n,max_pairs", CASES)
def test_merge_ranks_on_staging_cumsum_matches_jax(seed, n, max_pairs):
    """The compacted cumsum of a real scene, under a roomy and an
    overflowing budget."""
    _, rect_min, rect_max, radii, _ = _geometry(seed, n)
    e = binning.expand_pairs(to_torch(rect_min), to_torch(rect_max), to_torch(radii),
                             W, H, TILE, TILE, max_pairs)
    want = _jax_ranks(to_numpy(e.cum_keep), max_pairs)
    assert_bit_equal(_port_ranks(to_numpy(e.cum_keep), max_pairs), want)


def _bin_both(rect_min, rect_max, radii, depths, width, height, max_pairs):
    want = jax_binning.bin_gaussians(
        *(jnp.asarray(a) for a in (rect_min, rect_max, radii, depths)),
        width, height, TILE, TILE, max_pairs)
    got = binning.bin_gaussians(
        *(to_torch(a) for a in (rect_min, rect_max, radii, depths)),
        width, height, TILE, TILE, max_pairs)
    for name in got._fields:
        assert_bit_equal(to_numpy(getattr(got, name)), getattr(want, name), name)
    return got


@pytest.mark.parametrize("seed,n,max_pairs", CASES)
def test_bin_gaussians_matches_jax(seed, n, max_pairs):
    _, rect_min, rect_max, radii, depths = _geometry(seed, n)
    got = _bin_both(rect_min, rect_max, radii, depths, W, H, max_pairs)
    assert int(got.num_pairs) > 0
    if max_pairs == 512:
        assert int(got.overflow_pairs) > 0 and int(got.overflow_gaussians) > 0


def test_bin_gaussians_all_culled_and_depth_ties():
    """Every gaussian culled (radius 0): no pairs, empty tiles.  Then equal
    depths: the stable sort keeps gaussian order within a tile."""
    n = 10
    rect_min = np.zeros((n, 2), np.float32)
    rect_max = np.ones((n, 2), np.float32)
    got = _bin_both(rect_min, rect_max, np.zeros(n, np.float32), np.ones(n, np.float32),
                    64, 64, 256)
    assert int(got.num_pairs) == 0 and not bool(got.pair_valid.any())
    assert bool((got.tile_count == 0).all())
    rect_max = np.full((n, 2), 40.0, np.float32)
    got = _bin_both(rect_min, rect_max, np.ones(n, np.float32), np.full(n, 2.0, np.float32),
                    64, 64, 256)
    assert int(got.num_pairs) == 9 * n
    assert to_numpy(got.sorted_gauss_idx)[:n].tolist() == list(range(n))


@pytest.mark.parametrize("seed", [3, 13])
def test_split_records_match_aligned_staging(seed):
    """The split rasterizer's gathered records == the fused aligned
    staging's relaid-out records, bit for bit (rows 0-10), with the same
    aligned starts, tile counts and per-column gaussian ids."""
    args = _geometry(seed, 80)
    targs = [to_torch(a) for a in args]
    st = staging.StagingStatic(W, H, TILE, TILE, MAX_PAIRS, CHUNK)
    fused, gid = staging._stage_impl(st, *targs)
    b = binning.bin_gaussians(*targs[1:], W, H, TILE, TILE, MAX_PAIRS)
    num_aligned = staging._num_aligned(st)
    aligned_start, src, within = rasterize_cuda.aligned_relayout(
        b.tile_start, b.tile_count, CHUNK, num_aligned)
    aligned_idx = torch.where(within, b.sorted_gauss_idx[src].long(), 0)
    split = rasterize_cuda._GatherRecords.apply(targs[0], aligned_idx, within, "segsum")
    assert_bit_equal(to_numpy(split[:11]), to_numpy(fused.records_cm[:11]), "records")
    assert_bit_equal(to_numpy(split[11:]), np.zeros((5, num_aligned), np.float32))
    assert_bit_equal(to_numpy(aligned_start), to_numpy(fused.aligned_start), "aligned_start")
    assert_bit_equal(to_numpy(b.tile_count), to_numpy(fused.tile_count), "tile_count")
    assert_bit_equal(to_numpy(torch.where(within, aligned_idx, 80).to(torch.int32)),
                     to_numpy(gid), "gid")
    assert int(b.num_pairs) == int(fused.num_pairs) > 0


def test_render_split_matches_jax():
    check_render_layout("split", "scene_sh1")


def test_train_steps_split_match_jax(tmp_path):
    check_train_steps_layout("split", tmp_path)


def test_split_inference_render_matches_default():
    """render(inference=True) under staging="split" composites the same
    records as the default sorted inference path: the same image, bit for
    bit on the CPU, and no gradient state."""
    params, c2w = scene_numpy(seed=5, sh_degree=1, sh_rest_scale=0.2)
    gp = gaussians.params_from_numpy(params, "cpu")
    t = Camera.from_c2w(W, H, 60.0, 60.0, c2w).tensors()
    outs = []
    for layout in ({}, {"staging": "split"}):
        cfg = config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=MAX_PAIRS,
                                      chunk_size=CHUNK, **layout)
        with torch.no_grad():
            means, shs, opacity, scales, rots = gaussians.activations(gp)
        out, aux = render(means, shs, opacity, scales, rots,
                          to_torch(t["view"]), to_torch(t["proj"]),
                          to_torch(t["camera_center"]), t["fov_x"], t["fov_y"],
                          t["focal_x"], t["focal_y"], W, H, 1, raster_cfg=cfg,
                          inference=True)
        assert not out.color.requires_grad and int(aux.num_pairs) > 0
        outs.append(out)
    for name in ("color", "depth", "alpha", "n_contrib"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), name
