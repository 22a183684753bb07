"""The scatter gradient reduction (RasterizerConfig.grad_reduce="scatter")
against the JAX package's, on the same inputs: the backward of the sorted
and aligned training stagings and of the split layout's record gather,
each against the JAX VJP with grad_reduce="scatter" (rtol 1e-5 / atol 1e-6
x the largest entry: both add the columns one by one, possibly in another
order); the split gather at a width where the JAX package falls back to the
scatter on its own, against the port's K4 path; row 4 summed as the
compositing backward wrote it, not copied from row 3; the port's scatter
against its segment sum; and the layout end to end through render()."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import CHUNK, H, MAX_PAIRS, TILE, W, to_numpy, to_torch
from test_torch_staging import assert_bit_equal
from test_torch_train_staging import _geometry

from gaussiansplattingmlx_tpu.ops import binning as jax_binning
from gaussiansplattingmlx_tpu.ops import rasterize_pallas as jax_rp
from gaussiansplattingmlx_tpu.ops import staging as jax_staging
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, staging

N = 80
PERM = list(rasterize_cuda.PERM)


def _assert_sums_close(got, want):
    """rtol 1e-5; atol 1e-6 of the largest entry covers sums that cancel."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def _cotangent(shape, seed):
    """A random record cotangent whose rows 3 and 4 differ (the kernels
    write d_cs into both; here they differ, so a copy of row 3 shows)."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("layout", ["sorted", "aligned"])
def test_staging_scatter_backward_matches_jax(layout):
    """d packed of the training staging with grad_reduce="scatter": the
    port's scatter-add against the JAX staging VJP's .at[].add."""
    args = _geometry(3, N)
    jst = jax_staging.StagingStatic(
        image_width=W, image_height=H, tile_w=TILE, tile_h=TILE, max_pairs=MAX_PAIRS,
        chunk=CHUNK, num_rec=N, grad_reduce="scatter", interpret=True)
    tst = staging.StagingStatic(W, H, TILE, TILE, MAX_PAIRS, CHUNK, grad_reduce="scatter")
    jstage, tstage = {"sorted": (jax_staging.stage_pairs_train, staging.stage_pairs_train),
                      "aligned": (jax_staging.stage_pairs, staging.stage_pairs)}[layout]
    jargs = [jnp.asarray(a) for a in args]
    records, vjp = jax.vjp(lambda p: jstage(jst, p, *jargs[1:]).records_cm, jargs[0])
    cot = _cotangent(records.shape, 4)
    (want,) = vjp(jnp.asarray(cot))
    packed = to_torch(args[0]).requires_grad_()
    sp = tstage(tst, packed, *(to_torch(a) for a in args[1:]))
    assert tuple(sp.records_cm.shape) == records.shape
    sp.records_cm.backward(to_torch(cot))
    got, want = to_numpy(packed.grad), np.asarray(want)
    _assert_sums_close(got, want)
    # Row 4 (c10) is its own sum, not row 3's (c01).
    assert not np.array_equal(got[:, 3], got[:, 4])


def _split_inputs(max_pairs, seed=3):
    """The JAX binning of a test scene and the chunk-aligned gather indices
    the split rasterizer builds from it, as numpy."""
    args = _geometry(seed, N)
    b = jax_binning.bin_gaussians(*(jnp.asarray(a) for a in args[1:]), W, H, TILE, TILE,
                                  max_pairs)
    num_tiles = -(-W // TILE) * -(-H // TILE)
    num_aligned = max_pairs + num_tiles * CHUNK
    _, src, within = jax_rp.aligned_relayout(b.tile_start, b.tile_count, num_tiles, CHUNK,
                                             num_aligned)
    aligned_idx = jnp.where(within, b.sorted_gauss_idx[src], 0)
    return args[0], b, aligned_idx, within, num_aligned


def _jax_gather_grad(packed, aligned_idx, within, num_aligned, cot):
    """d packed of the JAX split gather with grad_reduce="scatter"."""
    gst = jax_rp.GatherStatic(num_rec=N, num_aligned=num_aligned, chunk=CHUNK, block_b=128,
                              grad_reduce="scatter", interpret=True)

    def f(p):
        rec = jnp.concatenate([p[:, jnp.asarray(PERM)], jnp.zeros((N, 5), p.dtype)], axis=1)
        return jax_rp._gather_records(gst, rec, aligned_idx, within)

    _, vjp = jax.vjp(f, jnp.asarray(packed))
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _port_gather_grad(packed, b, cot, max_pairs, grad_reduce):
    num_tiles = -(-W // TILE) * -(-H // TILE)
    p = to_torch(packed).requires_grad_()
    records, _ = rasterize_cuda.split_records(
        p, to_torch(b.sorted_gauss_idx), to_torch(b.tile_start), to_torch(b.tile_count),
        num_tiles, CHUNK, grad_reduce)
    records.backward(to_torch(cot))
    return to_numpy(p.grad)


@pytest.mark.parametrize("max_pairs,grad_reduce", [(MAX_PAIRS, "scatter"), (1000, "segsum")],
                         ids=["scatter", "jax_fallback_width"])
def test_split_gather_backward_matches_jax_scatter(max_pairs, grad_reduce):
    """The split layout's record gather: its backward with grad_reduce
    "scatter" against the JAX gather's scatter VJP; and at 1,000 pairs,
    where no segment-sum chunk divides the aligned width and the JAX split
    path takes the scatter whatever grad_reduce says, the port's K4 path
    (no width constraint) against that scatter."""
    packed, b, aligned_idx, within, num_aligned = _split_inputs(max_pairs)
    if max_pairs == 1000:
        assert jax_rp.pick_seg_chunk(num_aligned, CHUNK) == 0
    cot = _cotangent((16, within.shape[0]), 5)  # whole chunks of the aligned width
    if grad_reduce == "segsum":
        cot[4] = cot[3]  # as the compositing backward writes them
    want = _jax_gather_grad(packed, aligned_idx, within, num_aligned, cot)
    got = _port_gather_grad(packed, b, cot, max_pairs, grad_reduce)
    _assert_sums_close(got, want)


def test_scatter_row_four_is_summed_not_copied():
    """With rows 3 and 4 equal (as K3, K7 and their plain versions write
    them), scatter and segment sum agree; with them unequal, the segment
    sum copies row 3's sum into row 4 and the scatter sums row 4."""
    gid = np.random.default_rng(6).integers(0, N + 1, size=700).astype(np.int32)
    g = _cotangent((16, 700), 7)
    g[11:] = 0.0
    scatter = to_numpy(rasterize_cuda.reduce_record_cotangent(to_torch(g), to_torch(gid), N,
                                                              "scatter"))
    segsum = to_numpy(rasterize_cuda.reduce_record_cotangent(to_torch(g), to_torch(gid), N))
    sums = np.zeros((N, 16), np.float32)
    valid = gid < N
    np.add.at(sums, gid[valid], g[:, valid].T)
    np.testing.assert_allclose(scatter[:, 4], sums[:, 4], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(segsum[:, 4], sums[:, 3], rtol=1e-5, atol=1e-5)
    g[4] = g[3]
    scatter = to_numpy(rasterize_cuda.reduce_record_cotangent(to_torch(g), to_torch(gid), N,
                                                              "scatter"))
    segsum = to_numpy(rasterize_cuda.reduce_record_cotangent(to_torch(g), to_torch(gid), N))
    _assert_sums_close(scatter, segsum)
    again = rasterize_cuda.scatter_reduce(to_torch(g), to_torch(gid), N)
    assert_bit_equal(to_numpy(again)[:, PERM], scatter, "scatter, second call")
    with pytest.raises(ValueError, match="grad_reduce"):
        rasterize_cuda.reduce_record_cotangent(to_torch(g), to_torch(gid), N, "atomic")


@pytest.mark.parametrize("layout", list(config.LAYOUTS))
def test_render_scatter_matches_segsum(layout):
    """render() gradients with grad_reduce="scatter" against the default
    segment sum, every layout (rtol 1e-5 / atol 1e-6 x each parameter's
    largest gradient: only the order of the per-Gaussian sums differs)."""
    from test_torch_aligned_staging import render_grads_port
    from torch_port_helpers import scene_numpy

    params, c2w = scene_numpy(seed=7, sh_degree=1, sh_rest_scale=0.2)
    target = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)
    results = [render_grads_port(params, c2w, 1, MAX_PAIRS, target, False, layout,
                                 grad_reduce=gr) for gr in ("segsum", "scatter")]
    (loss_a, color_a, grads_a), (loss_b, color_b, grads_b) = results
    assert loss_a == loss_b
    np.testing.assert_array_equal(color_a, color_b)
    for x, y in zip(grads_b, grads_a):
        if y.size:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6 * np.abs(y).max())
    assert any(np.abs(g).max() > 0 for g in grads_b if g.size)
