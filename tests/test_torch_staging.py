"""Port pair staging vs the JAX package, fed the same JAX projection
outputs: pair expansion, merge-gather and sorted staging are index machinery
and must agree bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (
    CHUNK, H, MAX_PAIRS, TILE, W, jax_geometry, scene_numpy,
    to_numpy, to_torch,
)

from gaussiansplattingmlx_tpu.ops import binning as jax_binning
from gaussiansplattingmlx_tpu.ops import merge_pallas
from gaussiansplattingmlx_tpu.ops import staging as jax_staging
from gaussiansplattingmlx_tpu_torch.ops import binning, merge_cuda, staging


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def assert_bit_equal(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _geometry(seed, n=80):
    params, c2w = scene_numpy(n=n, seed=seed)
    return jax_geometry(params, c2w)


# (seed, gaussians, pair budget): the two staging scenes with a roomy budget,
# and a denser scene whose ~1300 pairs overflow a 512-slot budget.
CASES = [(3, 80, MAX_PAIRS), (13, 80, MAX_PAIRS), (3, 240, 512)]


def _statics(max_pairs):
    jst = jax_staging.StagingStatic(
        image_width=W, image_height=H, tile_w=TILE, tile_h=TILE,
        max_pairs=max_pairs, chunk=CHUNK, num_rec=0, grad_reduce="scatter",
        interpret=True,
    )
    tst = staging.StagingStatic(
        image_width=W, image_height=H, tile_w=TILE, tile_h=TILE,
        max_pairs=max_pairs, chunk=CHUNK,
    )
    return jst, tst


@pytest.mark.parametrize("seed,n,max_pairs", CASES)
def test_expand_pairs_matches_jax(seed, n, max_pairs):
    packed, rect_min, rect_max, radii, depths = _geometry(seed, n)
    want = jax_binning.expand_pairs(
        jnp.asarray(rect_min), jnp.asarray(rect_max), jnp.asarray(radii),
        jnp.asarray(depths), W, H, TILE, TILE, max_pairs, need_rank=False,
    )
    got = binning.expand_pairs(
        to_torch(rect_min), to_torch(rect_max), to_torch(radii),
        W, H, TILE, TILE, max_pairs,
    )
    for name in got._fields:
        assert_bit_equal(to_numpy(getattr(got, name)), getattr(want, name), name)
    assert int(got.num_pairs) > 0
    if max_pairs == 512:
        assert int(got.overflow_pairs) > 0 and int(got.overflow_gaussians) > 0


@pytest.mark.parametrize("seed,n,max_pairs", CASES)
def test_merge_gather_plain_matches_jax_interpret(seed, n, max_pairs):
    """The real staging table, under roomy and overflowing budgets."""
    packed, rect_min, rect_max, radii, depths = _geometry(seed, n)
    _, tst = _statics(max_pairs)
    e, tbl = staging.merge_table(
        tst, *(to_torch(a) for a in (packed, rect_min, rect_max, radii, depths))
    )
    got = merge_cuda.merge_gather_plain(e.cum_keep, tbl, max_pairs)
    want = merge_pallas.merge_gather(
        jnp.asarray(to_numpy(e.cum_keep)), jnp.asarray(to_numpy(tbl)), max_pairs,
        interpret=True,
    )
    assert_bit_equal(to_numpy(got), want)
    # The dispatching wrapper takes the plain version for CPU tensors.
    assert_bit_equal(to_numpy(merge_cuda.merge_gather(e.cum_keep, tbl, max_pairs)), want)


def test_merge_gather_plain_rank_n_columns_are_zero():
    """Slots past the last pair (rank == n) select the zero column, and
    saturated cumsum entries never own a real slot: against the JAX kernel."""
    rng = np.random.default_rng(7)
    n = 300
    foot = rng.integers(1, 6, size=n)
    foot[200] = 2 ** 31 - 1
    cum = to_numpy(binning._saturating_cumsum(torch.as_tensor(foot)))
    table = rng.normal(size=(merge_cuda.TBL_ROWS, n)).astype(np.float32)
    for c, budget in ((cum, 1024), (cum[:200], 1024)):
        got = merge_cuda.merge_gather_plain(
            torch.as_tensor(c), torch.as_tensor(table[:, :len(c)]).contiguous(), budget
        )
        want = merge_pallas.merge_gather(
            jnp.asarray(c), jnp.asarray(table[:, :len(c)]), budget, interpret=True
        )
        assert_bit_equal(to_numpy(got), want)
    total = int(cum[199])
    assert total < 1024
    np.testing.assert_array_equal(to_numpy(got)[:, total:], 0.0)


@pytest.mark.parametrize("seed,n,max_pairs", CASES)
def test_stage_pairs_sorted_matches_jax(seed, n, max_pairs):
    args = _geometry(seed, n)
    jst, tst = _statics(max_pairs)
    jst = jst._replace(num_rec=args[0].shape[0])
    want = jax_staging.stage_pairs_sorted(jst, *(jnp.asarray(a) for a in args))
    got = staging.stage_pairs_sorted(tst, *(to_torch(a) for a in args))
    for name in ("records_cm", "tile_start", "tile_count", "num_pairs",
                 "overflow_gaussians", "overflow_pairs"):
        assert_bit_equal(to_numpy(getattr(got, name)), getattr(want, name), name)
    assert int(got.num_pairs) > 0
    assert (int(got.overflow_pairs) > 0) == (max_pairs == 512)


def test_sorted_staging_has_unaligned_tile_starts():
    """The parity scene must exercise unaligned tile starts (the compositing
    kernel reads them directly)."""
    args = _geometry(13)
    _, tst = _statics(MAX_PAIRS)
    sp = staging.stage_pairs_sorted(tst, *(to_torch(a) for a in args))
    starts = to_numpy(sp.tile_start)
    counts = to_numpy(sp.tile_count)
    assert ((starts[counts > 0] % CHUNK) != 0).any()


def test_merge_gather_rejects_unsupported_device():
    cum = torch.zeros(4, dtype=torch.int32, device="meta")
    tbl = torch.zeros((8, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        merge_cuda.merge_gather(cum, tbl, 16)

