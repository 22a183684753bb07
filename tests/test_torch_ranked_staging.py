"""The staging route for budgets above ``staging.K2_MAX_SLOTS`` (2^24 slots):
K5's int32 ranks, the integer columns gathered as int32 and one gather of
the record rows in sorted order.  Forced at a small size by lowering the
module's limit, it must give exactly what the fused merge-gather (K2)
route gives, and its valid columns must equal the JAX package's own
fallback (``GSPLAT_MERGE=sort``: ranks and one row gather of its f32
table).  That fallback clamps the rank to n - 1 and writes gid 0 on slots
past the last pair, so those slots are held to the K2 route only."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import CHUNK, H, W, jax_geometry, scene_numpy, to_numpy, to_torch
from test_torch_staging import assert_bit_equal

from gaussiansplattingmlx_tpu.ops import staging as jax_staging
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import merge_cuda, staging
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

# (seed, gaussians, budget, tile_w, tile_h): roomy and overflowing budgets
# (the 512- and 768-slot ones overflow), square and oblong tiles.  Seed 7
# culls every fifth gaussian, so that slots past the last pair select the
# first culled gaussian's column (rank < n) rather than the zero column.
CASES = [
    (3, 80, 4096, 16, 16),
    (13, 80, 4096, 8, 16),
    (5, 160, 4096, 8, 8),
    (7, 120, 4096, 16, 16),
    (3, 240, 512, 16, 16),
    (21, 240, 768, 32, 16),
]


def _geometry(seed, n):
    params, c2w = scene_numpy(n=n, seed=seed)
    packed, rect_min, rect_max, radii, depths = jax_geometry(params, c2w)
    if seed == 7:
        radii = radii.copy()
        radii[::5] = 0.0  # what the projection gives a culled gaussian
    return packed, rect_min, rect_max, radii, depths


def _static(max_pairs, tile_w, tile_h):
    return staging.StagingStatic(image_width=W, image_height=H, tile_w=tile_w,
                                 tile_h=tile_h, max_pairs=max_pairs, chunk=CHUNK)


def _both_routes(monkeypatch, fn, *args):
    """``fn(*args)`` through the K2 route and through the ranked route (the
    limit lowered below every budget here), with the launches of each
    route's merge recorded."""
    calls = []
    for name in ("merge_gather", "merge_ranks"):
        real = getattr(merge_cuda, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(merge_cuda, name, spy)
    k2 = fn(*args)
    assert calls and set(calls) == {"merge_gather"}, calls
    calls.clear()
    monkeypatch.setattr(staging, "K2_MAX_SLOTS", 256)
    ranked = fn(*args)
    assert calls and set(calls) == {"merge_ranks"}, calls
    monkeypatch.setattr(staging, "K2_MAX_SLOTS", 2 ** 24)
    return k2, ranked


@pytest.mark.parametrize("seed,n,max_pairs,tile_w,tile_h", CASES)
def test_ranked_sorted_pairs_equal_the_k2_route(monkeypatch, seed, n, max_pairs,
                                                tile_w, tile_h):
    args = tuple(to_torch(a) for a in _geometry(seed, n))
    st = _static(max_pairs, tile_w, tile_h)
    k2, ranked = _both_routes(monkeypatch, staging._sorted_pairs, st, *args)
    for name, a, b in zip(("records", "gid", "tile_start", "tile_count"), ranked[:4], k2[:4]):
        assert_bit_equal(to_numpy(a), to_numpy(b), name)
    for name in ranked[4]._fields:
        assert_bit_equal(to_numpy(getattr(ranked[4], name)), to_numpy(getattr(k2[4], name)),
                         name)
    num_pairs = int(k2[4].num_pairs)
    assert 0 < num_pairs <= max_pairs
    assert (int(k2[4].overflow_pairs) > 0) == (max_pairs < 1024)
    # Slots past the last pair: zero records but for the tail of inactive
    # gaussians' columns, gid num_rec.
    assert (to_numpy(ranked[1])[num_pairs:] == n).all()


@pytest.mark.parametrize("seed,n,max_pairs,tile_w,tile_h", CASES)
def test_ranked_sorted_pairs_valid_columns_equal_jax_fallback(monkeypatch, seed, n,
                                                              max_pairs, tile_w, tile_h):
    args = _geometry(seed, n)
    monkeypatch.setenv("GSPLAT_MERGE", "sort")
    jst = jax_staging.StagingStatic(
        image_width=W, image_height=H, tile_w=tile_w, tile_h=tile_h,
        max_pairs=max_pairs, chunk=CHUNK, num_rec=n, grad_reduce="segsum",
        interpret=True,
    )
    cols, j_start, j_count, _ = jax_staging._sorted_pairs(
        jst, *(jnp.asarray(a) for a in args))
    monkeypatch.setattr(staging, "K2_MAX_SLOTS", 256)
    rec, gid, start, count, e = staging._sorted_pairs(
        _static(max_pairs, tile_w, tile_h), *(to_torch(a) for a in args))
    k = int(e.num_pairs)
    want_rec = np.stack([np.asarray(c) for c in cols[2:13]])
    assert_bit_equal(to_numpy(rec)[:, :k], want_rec[:, :k], "records")
    assert_bit_equal(to_numpy(gid)[:k], np.asarray(cols[13])[:k], "gid")
    assert_bit_equal(to_numpy(start), j_start, "tile_start")
    assert_bit_equal(to_numpy(count), j_count, "tile_count")


@pytest.mark.parametrize("seed,n,max_pairs,tile_w,tile_h", [CASES[1], CASES[3]])
def test_ranked_training_stagings_equal_the_k2_route(monkeypatch, seed, n, max_pairs,
                                                     tile_w, tile_h):
    """Sorted and aligned training staging through both routes: buffers,
    tile ranges and the packed records' gradient (K4's plain version)."""
    geo = _geometry(seed, n)
    st = _static(max_pairs, tile_w, tile_h)
    cot = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(16, max_pairs + staging._num_aligned(st))).astype(np.float32))

    def run(fn):
        def go():
            packed = to_torch(geo[0]).requires_grad_()
            out = fn(st, packed, *(to_torch(a) for a in geo[1:]))
            (out.records_cm * cot[:, :out.records_cm.shape[1]]).sum().backward()
            return out, packed.grad
        return go

    for fn in (staging.stage_pairs_train, staging.stage_pairs):
        (k2, k2_grad), (ranked, ranked_grad) = _both_routes(monkeypatch, run(fn))
        for name in k2._fields:
            assert_bit_equal(to_numpy(getattr(ranked, name)), to_numpy(getattr(k2, name)),
                             f"{fn.__name__}.{name}")
        assert_bit_equal(to_numpy(ranked_grad), to_numpy(k2_grad), f"{fn.__name__} grad")


@pytest.mark.parametrize("train_staging", ["sorted", "aligned"])
def test_ranked_route_renders_and_trains_like_the_k2_route(monkeypatch, train_staging):
    """The slice as a whole: render() for serving and for training through
    both routes gives the same images and the same parameter gradients."""
    params_np, c2w = scene_numpy(n=120, seed=17, sh_degree=1, sh_rest_scale=0.2)
    t = Camera.from_c2w(W, H, 60.0, 60.0, c2w).tensors()
    rc = config.RasterizerConfig(tile_h=16, tile_w=16, max_pairs=2048, chunk_size=CHUNK,
                                 train_staging=train_staging)
    cam = (to_torch(t["view"]), to_torch(t["proj"]), to_torch(t["camera_center"]),
           t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, 1)

    def run():
        params = gaussians.params_from_numpy(params_np, "cpu")
        act = gaussians.activations(params)
        serve, _ = render(*act, *cam, raster_cfg=rc, inference=True)
        out, _ = render(*act, *cam, raster_cfg=rc)
        (out.color.square().sum() + out.depth.sum() + out.alpha.sum()).backward()
        return serve, out, {k: v.grad for k, v in params.tensors().items()}

    (s_k2, o_k2, g_k2), (s_r, o_r, g_r) = _both_routes(monkeypatch, run)
    for name in ("color", "depth", "alpha", "n_contrib"):
        assert_bit_equal(to_numpy(getattr(s_r, name)), to_numpy(getattr(s_k2, name)), name)
        assert_bit_equal(to_numpy(getattr(o_r, name)), to_numpy(getattr(o_k2, name)), name)
    assert float(s_k2.alpha.max()) > 0.5
    for name in g_k2:
        assert g_k2[name] is not None and torch.count_nonzero(g_k2[name]) > 0, name
        assert_bit_equal(to_numpy(g_r[name]), to_numpy(g_k2[name]), name)
