"""The chunk-aligned training layout (RasterizerConfig.train_staging="aligned")
against the JAX package, on the same inputs: the chunk plan and aligned
staging (K6's plain version vs the JAX relayout kernel in Pallas interpret
mode, bit-exact), the aligned backward rows (K7's plain version vs the VJP
of the JAX rasterizer core over aligned records, `_bwd_kernel` in interpret
mode), and the layout end to end: render() gradients and three Trainer
steps.  The end-to-end helpers are shared with tests/test_torch_split_binning.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (
    CHUNK, H, MAX_PAIRS, TILE, W, scene_numpy, to_numpy, to_torch,
)
from test_torch_rasterize import CASES as RASTER_CASES
from test_torch_staging import CASES, assert_bit_equal
from test_torch_train_grads import FOCAL, _loss_terms, _tiny_tiles_scene
from test_torch_train_staging import _geometry, assert_rows_close
from test_torch_train_step import ITERS, N, RASTER, SH, _carry, _jax_state, _views

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu import render as jax_render
from gaussiansplattingmlx_tpu.data.dataset import TrainData as JaxTrainData
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.ops import rasterize_pallas as jax_rp
from gaussiansplattingmlx_tpu.ops import staging as jax_staging
from gaussiansplattingmlx_tpu.train import trainer as jax_trainer
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, relayout_cuda, staging
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import trainer
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera


def _statics(max_pairs, n, chunk=CHUNK, width=W, height=H):
    jst = jax_staging.StagingStatic(
        image_width=width, image_height=height, tile_w=TILE, tile_h=TILE,
        max_pairs=max_pairs, chunk=chunk, num_rec=n, grad_reduce="segsum",
        interpret=True,
    )
    tst = staging.StagingStatic(width, height, TILE, TILE, max_pairs, chunk)
    return jst, tst


@pytest.mark.parametrize("seed,n,max_pairs", [CASES[0], CASES[2]])
def test_aligned_chunk_plan_matches_jax(seed, n, max_pairs):
    args = _geometry(seed, n)
    jst, tst = _statics(max_pairs, n)
    _, _, start, count, _ = staging._sorted_pairs(tst, *(to_torch(a) for a in args))
    num_tiles = count.shape[0]
    num_aligned = staging._num_aligned(tst)
    assert num_aligned == jax_staging._num_aligned(jst)
    want = jax_rp.aligned_relayout(jnp.asarray(to_numpy(start)), jnp.asarray(to_numpy(count)),
                                   num_tiles, CHUNK, num_aligned)
    got = rasterize_cuda.aligned_relayout(start, count, CHUNK, num_aligned)
    for name, g, w in zip(("aligned_start", "src", "within"), got, want):
        assert_bit_equal(to_numpy(g).astype(np.asarray(w).dtype), w, name)
    want_plan = jax_rp.aligned_chunk_plan(jnp.asarray(to_numpy(start)),
                                          jnp.asarray(to_numpy(count)), num_tiles, CHUNK,
                                          num_aligned)
    for name, g, w in zip(("aligned_start", "owner", "rank0"),
                          rasterize_cuda.aligned_chunk_plan(count, CHUNK, num_aligned),
                          want_plan):
        assert_bit_equal(to_numpy(g), w, name)


@pytest.mark.parametrize("seed,n,max_pairs,chunk", [c + (CHUNK,) for c in CASES]
                         + [(13, 80, MAX_PAIRS, 128)])
def test_stage_pairs_matches_jax(seed, n, max_pairs, chunk):
    """The JAX side runs its relayout kernel (K6) in interpret mode."""
    args = _geometry(seed, n)
    jst, tst = _statics(max_pairs, n, chunk)
    assert jax_staging._use_relayout_kernel(jst)
    want, want_gid = jax_staging._stage_impl(jst, *(jnp.asarray(a) for a in args))
    got, got_gid = staging._stage_impl(tst, *(to_torch(a) for a in args))
    assert got.records_cm.shape == (16, staging._num_aligned(tst))
    # Rows 0-10 the records, row 11 the gaussian id as a float value.
    assert_bit_equal(to_numpy(got.records_cm[:12]), np.asarray(want.records_cm)[:12], "records")
    assert_bit_equal(to_numpy(got.records_cm[12:]), np.zeros_like(want.records_cm[12:]))
    for name in got._fields[1:]:
        assert_bit_equal(to_numpy(getattr(got, name)), getattr(want, name), name)
    assert_bit_equal(to_numpy(got_gid), want_gid, "gid_aligned")
    assert int(got.num_pairs) > 0
    assert (int(got.overflow_pairs) > 0) == (max_pairs == 512)
    # Tile starts are chunk multiples; the dispatching relayout takes the
    # plain version on the CPU; the autograd wrapper stages the same buffer.
    assert bool((got.aligned_start % chunk == 0).all())
    via_fn = staging.stage_pairs(tst, *(to_torch(a) for a in args))
    assert_bit_equal(to_numpy(via_fn.records_cm), to_numpy(got.records_cm), "via Function")


def test_relayout_plain_zeros_and_rows():
    """K6's plain version on a hand-made plan: a tile whose pairs fill its
    chunk exactly, one that pads, an empty tile, and the tail chunks owned by
    no pairs; rows past the input's are zero."""
    rows = torch.arange(3 * 24, dtype=torch.float32).reshape(3, 24) + 1.0
    start = torch.tensor([0, 8, 13, 13], dtype=torch.int32)
    count = torch.tensor([8, 5, 0, 7], dtype=torch.int32)
    chunk, num_aligned = 8, 24 + 4 * 8
    aligned_start, owner, rank0 = rasterize_cuda.aligned_chunk_plan(count, chunk, num_aligned)
    assert aligned_start.tolist() == [0, 8, 16, 16]
    out = relayout_cuda.relayout(rows, start, count, owner, rank0, chunk, num_aligned)
    assert out.shape == (16, num_aligned)
    want = torch.zeros((16, num_aligned))
    want[:3, 0:8] = rows[:, 0:8]
    want[:3, 8:13] = rows[:, 8:13]
    want[:3, 16:23] = rows[:, 13:20]
    assert torch.equal(out, want)


def _raster_vjp_aligned(records, start, count, width, height, cot, chunk):
    grid_w, grid_h = -(-width // TILE), -(-height // TILE)
    st = jax_rp.RasterStatic(
        chunk=chunk, tile_h=TILE, tile_w=TILE, grid_h=grid_h, grid_w=grid_w,
        num_aligned=records.shape[1], alpha_clamp=0.99, transmittance_eps=1e-4,
        undo_denom_floor=1e-6, interpret=True, sorted_mode=False,
    )
    s, c = jnp.asarray(start), jnp.asarray(count)
    out, vjp = jax.vjp(lambda r: jax_rp._raster_core(st, r, s, c), jnp.asarray(records))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("case,chunk", [("occlusion", CHUNK), ("zero_opacity", CHUNK),
                                        ("scene", CHUNK), ("scene", 128)])
def test_raster_bwd_aligned_plain_matches_jax_vjp(case, chunk):
    """Per-column gradient rows of K7's plain version against the VJP of the
    JAX rasterizer core over the JAX aligned staging's buffer (`_bwd_kernel`,
    interpret mode), with a random output cotangent."""
    if case == "scene":
        width, height, args = W, H, _geometry(13, 80)
    else:
        width, height, build = RASTER_CASES[case]
        args = build()
    jst, _ = _statics(MAX_PAIRS, args[0].shape[0], chunk, width, height)
    sp, _ = jax_staging._stage_impl(jst, *(jnp.asarray(a) for a in args))
    records, start, count = (np.asarray(x) for x in (sp.records_cm, sp.aligned_start,
                                                      sp.tile_count))
    grid_w, grid_h = -(-width // TILE), -(-height // TILE)
    cot = np.random.default_rng(5).normal(
        size=(grid_w * grid_h, 6, TILE * TILE)).astype(np.float32)
    out, want = _raster_vjp_aligned(records, start, count, width, height, cot, chunk)
    block = rasterize_cuda.cotangent_block(to_torch(cot), to_torch(out[:, 4:6]))
    got = to_numpy(rasterize_cuda.raster_bwd_aligned(
        to_torch(records), to_torch(start), to_torch(count), block,
        grid_w, grid_h, TILE, TILE, chunk))
    assert got.shape == want.shape == records.shape
    # The JAX kernel writes only the columns a tile owns (the others hold
    # what the interpreter left there, NaN); K7 writes zeros in the rest.
    owned = np.zeros(records.shape[1], bool)
    valid = np.zeros(records.shape[1], bool)
    for s, c in zip(start, count):
        owned[s:s + -(-c // chunk) * chunk] = True
        valid[s:s + c] = True
    assert np.isfinite(got).all() and np.abs(want[:, owned]).max() > 0
    if case == "occlusion":
        # tests/test_torch_train_staging.py gives the reason (ROADMAP.md §C).
        assert_rows_close(got[:, owned], want[:, owned], rtol=5e-3, atol=5e-4)
    else:
        assert_rows_close(got[:, owned], want[:, owned])
    np.testing.assert_array_equal(got[11:], 0.0)
    np.testing.assert_array_equal(got[3], got[4])
    # Pad lanes, the dead tail and the columns no tile owns: exact zeros.
    np.testing.assert_array_equal(got[:, ~valid], 0.0)
    np.testing.assert_array_equal(want[:, owned & ~valid], 0.0)


# --- the layouts end to end (shared with tests/test_torch_split_binning.py) ----


def render_grads_jax(params, c2w, sh_degree, max_pairs, target, white, layout):
    t = JaxCamera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = jax_config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=max_pairs,
                                      chunk_size=CHUNK, **config.LAYOUTS[layout])

    def f(ptuple):
        gp = jax_gaussians.GaussianParams.from_tuple(ptuple)
        means, shs, opacity, scales, rots = jax_gaussians.activations(gp)
        out, _ = jax_render.render(
            means, shs, opacity, scales, rots,
            jnp.asarray(t["view"]), jnp.asarray(t["proj"]), jnp.asarray(t["camera_center"]),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
            raster_cfg=cfg, white_background=white, backend="pallas_interpret",
        )
        return _loss_terms(out.color, out.depth, out.alpha, jnp.asarray(target), jnp), out.color

    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    (loss, color), grads = jax.value_and_grad(f, has_aux=True)(gp.as_tuple())
    return float(loss), np.asarray(color), [np.asarray(g) for g in grads]


def render_grads_port(params, c2w, sh_degree, max_pairs, target, white, layout,
                      grad_reduce="segsum"):
    gp = gaussians.params_from_numpy(params, "cpu")
    means, shs, opacity, scales, rots = gaussians.activations(gp)
    t = Camera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=max_pairs,
                                  chunk_size=CHUNK, grad_reduce=grad_reduce,
                                  **config.LAYOUTS[layout])
    out, aux = render(
        means, shs, opacity, scales, rots,
        to_torch(t["view"]), to_torch(t["proj"]), to_torch(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
        raster_cfg=cfg, white_background=white, inference=False,
    )
    assert int(aux.overflow_pairs) == 0 and int(aux.num_pairs) > 0
    loss = _loss_terms(out.color, out.depth, out.alpha, to_torch(target), torch)
    loss.backward()
    grads = [to_numpy(getattr(gp, n).grad) for n in gaussians.PARAM_NAMES]
    return float(loss.detach()), to_numpy(out.color), grads


def check_render_layout(layout, case):
    """Image, loss and all six parameter gradients of the port's training
    render under ``layout`` against jax.grad of the JAX render with the same
    config (tests/test_torch_train_grads.py's tolerances)."""
    if case == "scene_sh1":
        (params, c2w), sh_degree, max_pairs, white = (
            scene_numpy(seed=7, sh_degree=1, sh_rest_scale=0.2), 1, MAX_PAIRS, False)
    else:
        (params, c2w), sh_degree, max_pairs, white = _tiny_tiles_scene(), 0, 256, True
    target = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)
    want_loss, want_color, want = render_grads_jax(params, c2w, sh_degree, max_pairs,
                                                   target, white, layout)
    got_loss, got_color, got = render_grads_port(params, c2w, sh_degree, max_pairs,
                                                 target, white, layout)
    np.testing.assert_allclose(got_color, want_color, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for name, x, y in zip(gaussians.PARAM_NAMES, got, want):
        assert x.shape == y.shape, name
        if y.size == 0:
            continue
        assert np.isfinite(x).all(), name
        scale = max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x, y, rtol=2e-3, atol=2e-4 * scale, err_msg=name)
        np.testing.assert_array_equal(x == 0.0, y == 0.0, err_msg=name)
    assert any(np.abs(g).max() > 0 for g in got if g.size)


def check_train_steps_layout(layout, tmp_path):
    """Three steps of the port's make_train_step under ``layout`` against the
    JAX step with the same config (losses within rtol 1e-4, as
    tests/test_torch_train_step.py)."""
    c2ws, images = _views()
    jcfg = jax_config.TrainConfig(
        iterations=ITERS, model=jax_config.ModelConfig(sh_degree=SH),
        raster=jax_config.RasterizerConfig(**RASTER, **config.LAYOUTS[layout],
                                           backend="pallas_interpret"))
    tcfg = config.TrainConfig(iterations=ITERS, model=config.ModelConfig(sh_degree=SH),
                              raster=config.RasterizerConfig(**RASTER, **config.LAYOUTS[layout]))
    jdata = JaxTrainData([JaxCamera.from_c2w(W, H, 60.0, 60.0, c) for c in c2ws], images)
    tdata = TrainData([Camera.from_c2w(W, H, 60.0, 60.0, c) for c in c2ws], images)
    jstate = _jax_state()
    tstate = _carry(jstate, tmp_path)
    jstep = jax_trainer.make_train_step(jcfg, W, H, SH, ITERS, backend="pallas_interpret")
    tstep = trainer.make_train_step(tcfg, W, H, SH, ITERS)
    jviews, tviews = jax_trainer.stack_views(jdata), trainer.stack_views(tdata, "cpu")
    for view in (0, 1, 0):
        jstate, jm, _ = jstep(jstate, jviews, jnp.int32(view))
        tstate, tm, _ = tstep(tstate, tviews, view)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        for key in ("num_pairs", "overflow_pairs", "grad_coverage"):
            assert float(tm[key]) == float(jm[key]), key
        assert float(tm["grad_coverage"]) > 0
    assert int(tstate.step) == 3 and 0 < int(tm["num_pairs"]) and N == int(tstate.num_active)


def test_render_aligned_matches_jax():
    check_render_layout("aligned", "tiny_tiles_white")


def test_train_steps_aligned_match_jax(tmp_path):
    check_train_steps_layout("aligned", tmp_path)


def test_aligned_backward_routes_to_k7():
    """rasterize_staged(sorted_mode=False) on aligned records that require
    grad: the records' cotangent is raster_bwd_aligned of the output
    cotangent."""
    args = _geometry(3, 80)
    _, tst = _statics(MAX_PAIRS, 80)
    sp, _ = staging._stage_impl(tst, *(to_torch(a) for a in args))
    records = sp.records_cm.clone().requires_grad_()
    out = rasterize_cuda.rasterize_staged(records, sp.aligned_start, sp.tile_count, W, H,
                                          TILE, TILE, chunk_size=CHUNK, sorted_mode=False)
    (torch.sum(out.color) + torch.sum(out.depth)).backward()
    grid = -(-W // TILE)
    fwd = rasterize_cuda.raster_fwd(sp.records_cm, sp.aligned_start, sp.tile_count,
                                    grid, grid, TILE, TILE)
    cot = torch.zeros_like(fwd)
    cot[:, 0:4] = 1.0
    want = rasterize_cuda.raster_bwd_aligned(
        sp.records_cm, sp.aligned_start, sp.tile_count,
        rasterize_cuda.cotangent_block(cot, fwd[:, 4:6]), grid, grid, TILE, TILE, CHUNK)
    torch.testing.assert_close(records.grad, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("field,value,error", [
    ("staging", "bogus", ValueError), ("train_staging", "chunked", ValueError),
    ("backend", "triton", ValueError), ("grad_reduce", "atomic", ValueError),
    # These two raised NotImplementedError until the oracle backend and the
    # scatter reduction were ported; they keep their ids and now build.
    pytest.param("backend", "reference", None, id="backend-reference-NotImplementedError"),
    pytest.param("grad_reduce", "scatter", None,
                 id="grad_reduce-scatter-NotImplementedError"),
])
def test_unknown_layout_selectors_raise(field, value, error):
    """Unknown selector values raise ValueError naming the field; every
    value of the JAX package's builds."""
    if error is None:
        assert getattr(config.RasterizerConfig(**{field: value}), field) == value
    else:
        with pytest.raises(error, match=field):
            config.RasterizerConfig(**{field: value})
    for ok in ("auto", "pallas", "pallas_interpret", "reference"):
        assert config.RasterizerConfig(backend=ok).backend == ok
