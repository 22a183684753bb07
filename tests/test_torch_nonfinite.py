"""ROADMAP C.5 on the CPU: the step of seed 2's run (b) that first leaves a
Gaussian non-finite, held against the JAX package from the card's record.

``tests/fixtures/c5_nonfinite.npz`` is what ``scripts/torch_find_nonfinite.py
--fixture`` wrote on the H100 (card ``c5`` of ``scripts/torch_c4_cards.sh``;
step 23,621, view 14, row 32,917 of 136,244): the row's parameters and Adam
moments before the step, its gradient, the cotangent that the segment sum
(K4) handed its projection, the camera, and the records and cotangent
blocks of eight of the 2,500 tiles the row touches, those where K3 gave it
non-finite rows.  The row is a needle just past z_cull whose screen
footprint's determinant is below float32's resolution: on the card it
rounded to zero, the reference's guard left the conic as cov2d's adjugate
(entries ~3e7), and the compositing exponent of its pairs, three terms of
~1e15 that cancel, overflowed at some pixels into 0 * inf.  The same inputs
go through the JAX package and the port, stage by stage:

* the projection of the row: the well-posed outputs equal, the conic
  rounding noise in both packages (one ulp of the input moves it >10%);
* the compositing backward on the recorded tiles (the JAX rasterizer core,
  ``_bwd_kernel_sorted`` in interpret mode, against K3's plain version on
  JAX's forward): the row's means2d, conic and opacity cotangents
  non-finite and its colour finite in JAX, the plain version and the card's
  K3 alike; every other record's rows equal without the row's record;
* the projection's VJP at the recorded cotangent and Adam's update: the
  same non-finite parameters as the card's step, equal finite values.

Patterns are NaN, +inf and -inf apart.  Bars: gradients rtol 2e-3 / atol
2e-4 of each parameter's largest magnitude, the JAX package's
Pallas-vs-oracle bar (ROADMAP), and its early-exit bar 5e-3 / 5e-4 on tiles
whose pixels end near full opacity; Adam rtol 1e-5 / atol 1e-7
(``tests/test_torch_train_step.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.ops import projection as jax_projection
from gaussiansplattingmlx_tpu.ops import rasterize_pallas as jax_rp
from gaussiansplattingmlx_tpu.ops import rasterize_ref as jax_ref
from gaussiansplattingmlx_tpu.train import optimizer as jax_optimizer
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.models.gaussians import PARAM_NAMES
from gaussiansplattingmlx_tpu_torch.ops import (projection, rasterize_cuda, rasterize_ref,
                                                segsum_cuda)
from gaussiansplattingmlx_tpu_torch.train import optimizer

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "c5_nonfinite.npz"
PROJECTION_KW = ("z_cull", "ndc_w_eps", "tanfov_clip", "cov2d_dilation", "radius_eigen_eps",
                 "quat_norm_eps")
CHUNK = 128  # RasterizerConfig.chunk_size, the run's


@pytest.fixture(scope="module")
def rec():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def assert_same(got, want, rtol, atol, name):
    """The same finite / non-finite pattern (NaN, +inf and -inf apart), and
    finite values within rtol and ``atol`` times the largest finite
    magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want), err_msg=f"{name}: {test.__name__}")
    fin = np.isfinite(want)
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-30)
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol * scale,
                                   err_msg=name)


def _camera(rec):
    """(view, proj, camera_center, fov_x, fov_y, focal_x, focal_y), W, H,
    sh_degree and the projection's constants, as the step used them."""
    cam = [rec["view_matrix"], rec["proj_matrix"], rec["camera_center"]]
    cam += [float(rec[k]) for k in ("fov_x", "fov_y", "focal_x", "focal_y")]
    kw = {k: float(rec[f"projection_{k}"]) for k in PROJECTION_KW}
    return cam, int(rec["image_width"]), int(rec["image_height"]), int(rec["sh_degree"]), kw


def _row_params(rec):
    return {n: np.asarray(rec[f"pre_param_{n}"], np.float32)[None] for n in PARAM_NAMES}


def port_row(rec, row, d_packed):
    """The port: pack(project(activations(warm-up(row)))) [11] and its VJP
    at ``d_packed`` [11] by autograd, per parameter."""
    cam, w, h, deg, kw = _camera(rec)
    leaves = {n: torch.tensor(v, requires_grad=True) for n, v in row.items()}
    active = torch.ones(1)
    p = gaussians.apply_sh_warmup(leaves, torch.tensor(int(rec["step"]) - 1, dtype=torch.int32),
                                  int(rec["sh_warmup"]), deg)
    means3d, shs, opacity, scales, rots = gaussians.activations(p, active)
    out = projection.project_gaussians(
        means3d, scales, rots, shs, *(torch.tensor(a) for a in cam[:3]), *cam[3:], w, h, deg,
        active=active, **kw)
    packed = rasterize_ref.pack_gaussians(out.means2d, out.conic, out.colors, opacity,
                                          out.depths)
    grads = torch.autograd.grad(packed, [leaves[n] for n in PARAM_NAMES],
                                grad_outputs=torch.tensor(np.asarray(d_packed, np.float32))[None])
    return packed.detach().numpy()[0], {n: g[0].numpy() for n, g in zip(PARAM_NAMES, grads)}


@pytest.fixture(scope="module")
def jax_row(rec):
    """The JAX package's counterpart of ``port_row``, compiled once:
    ``jax.vjp`` of the same composition."""
    cam, w, h, deg, kw = _camera(rec)
    active = jnp.ones(1)
    step = jnp.int32(int(rec["step"]) - 1)

    def f(*values):
        p = jax_gaussians.GaussianParams.from_tuple(values)
        p = jax_gaussians.apply_sh_warmup(p, step, int(rec["sh_warmup"]), deg)
        means3d, shs, opacity, scales, rots = jax_gaussians.activations(p, active)
        out = jax_projection.project_gaussians(
            means3d, scales, rots, shs, *(jnp.asarray(a) for a in cam[:3]), *cam[3:], w, h,
            deg, active=active, **kw)
        return jax_ref.pack_gaussians(out.means2d, out.conic, out.colors, opacity, out.depths)

    @jax.jit
    def primal_and_vjp(values, ct):
        packed, vjp = jax.vjp(f, *values)
        return packed, vjp(ct)

    def run(row, d_packed):
        packed, grads = primal_and_vjp(tuple(jnp.asarray(row[n]) for n in PARAM_NAMES),
                                       jnp.asarray(np.asarray(d_packed, np.float32))[None])
        return np.asarray(packed)[0], {n: np.asarray(g)[0] for n, g in zip(PARAM_NAMES, grads)}
    return run


@pytest.fixture(scope="module")
def rows(rec, jax_row):
    """Both packages' (packed, gradients) of the row at the cotangent K4
    handed its projection on the card."""
    row = _row_params(rec)
    return {"port": port_row(rec, row, rec["d_packed"]), "jax": jax_row(row, rec["d_packed"])}


def test_projection_vjp_matches_jax(rec, rows):
    """The row's parameter gradients from the cotangent K4 handed its
    projection on the card: the port against JAX, and the port on the CPU
    against the gradient the card's step took."""
    got, want = rows["port"][1], rows["jax"][1]
    for n in PARAM_NAMES:
        assert_same(got[n], want[n], 2e-3, 2e-4, f"port vs JAX: {n}")
        assert_same(rec[f"grad_{n}"], got[n], 2e-3, 2e-4, f"card vs CPU: {n}")


def _tiles(rec):
    """The fixture's tiles as one sorted-order buffer: (records [16, P],
    tile_start, tile_count, grid, the output cotangent [T, 6, TT] with the
    card's image cotangents in the fixture's tiles, the card's block
    [T, TT, 8], each fixture tile's id and first column).

    The grid is the narrowest that keeps every fixture tile's column and
    row: a tile's pixels follow from its id by id % grid_w and id // grid_w
    alone, in the JAX kernel and in the plain version, so they are the
    run's own pixels, while JAX's kernel steps over fewer empty tiles
    (~4 ms each in interpret mode)."""
    run_grid_w, _, tile_w, tile_h = (int(v) for v in rec["grid"])
    run_ids = np.asarray(rec["tile_ids"], np.int64)
    kept = np.asarray(rec["tile_kept"], np.int64)
    tx, ty = run_ids % run_grid_w, run_ids // run_grid_w
    grid_w, grid_h = int(tx.max()) + 1, int(ty.max()) + 1
    ids = ty * grid_w + tx
    num_tiles, tt = grid_w * grid_h, tile_w * tile_h
    first = np.concatenate([[0], np.cumsum(kept)[:-1]]).astype(np.int64)
    width = -(-(int(kept.sum()) + CHUNK) // 512) * 512
    records = np.zeros((16, width), np.float32)
    records[:11, :kept.sum()] = rec["tile_records"]
    start = np.zeros(num_tiles, np.int32)
    count = np.zeros(num_tiles, np.int32)
    cot = np.zeros((num_tiles, 6, tt), np.float32)
    block = np.zeros((num_tiles, tt, 8), np.float32)
    for i, t in enumerate(ids):
        start[t], count[t] = first[i], kept[i]
        block[t] = rec["tile_blocks"][i]
        cot[t, 0:5] = block[t, :, 0:5].T
    return records, start, count, (grid_w, grid_h, tile_w, tile_h), cot, block, ids, first


def _jax_raster_vjp(records, start, count, geom, cot, rec):
    grid_w, grid_h, tile_w, tile_h = geom
    st = jax_rp.RasterStatic(
        chunk=CHUNK, tile_h=tile_h, tile_w=tile_w, grid_h=grid_h, grid_w=grid_w,
        num_aligned=records.shape[1], alpha_clamp=float(rec["raster_alpha_clamp"]),
        transmittance_eps=float(rec["raster_transmittance_eps"]),
        undo_denom_floor=float(rec["raster_undo_denom_floor"]), interpret=True,
        sorted_mode=True)
    s, c = jnp.asarray(start), jnp.asarray(count)
    out, vjp = jax.vjp(lambda r: jax_rp._raster_core(st, r, s, c), jnp.asarray(records))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _consts(rec):
    return dict(alpha_clamp=float(rec["raster_alpha_clamp"]),
                transmittance_eps=float(rec["raster_transmittance_eps"]),
                undo_denom_floor=float(rec["raster_undo_denom_floor"]))


def _row_columns(rec, first):
    """The row's pair columns in the fixture's tiles: (their index among the
    record's pair columns, their column in the fixture buffer), in tile
    order."""
    where = {int(t): i for i, t in enumerate(rec["tile_ids"])}
    starts, kept = np.asarray(rec["tile_starts"]), np.asarray(rec["tile_kept"])
    pick, cols = [], []
    for j, (col, t) in enumerate(zip(rec["cols"], rec["col_tiles"])):
        i = where.get(int(t))
        if i is not None and col - starts[i] < kept[i]:
            pick.append(j)
            cols.append(first[i] + col - starts[i])
    return np.asarray(pick, np.int64), np.asarray(cols, np.int64)


def _backward_both(records, start, count, geom, cot, rec):
    """JAX's VJP of its rasterizer core (its own forward), and K3's plain
    version on that forward's alpha and n_contrib."""
    out, want = _jax_raster_vjp(records, start, count, geom, cot, rec)
    port = rasterize_cuda.raster_bwd(
        torch.tensor(records), torch.tensor(start), torch.tensor(count),
        rasterize_cuda.cotangent_block(torch.tensor(cot), torch.tensor(out[:, 4:6])),
        *geom, **_consts(rec)).numpy()
    return out, want, port


def _segment_sum(rows, cols):
    """The row's packed cotangent [11] from per-pair rows [16, P]: its
    columns added in order over the live rows, as the segment sum adds them
    (row 4 repeats row 3), then the kernel layout's permutation."""
    live = list(segsum_cuda.LIVE_ROWS)
    g = np.zeros(16, np.float32)
    with np.errstate(invalid="ignore"):
        for c in cols:
            g[live] += rows[live, c]
    g[4] = g[3]
    return g[list(rasterize_cuda.PERM)]


def test_projection_conic_is_rounding_noise_in_both_packages(rec, rows, jax_row):
    """The row's footprint: a needle (scales e^-1.3, e^-7.3, e^-7.8) at depth
    0.2119, just past z_cull, whose cov2d entries are ~3e7 and whose exact
    determinant is ~4 float32 ulps of the products it is the difference of.
    On the card it rounded to zero: the reference's guard (det <= 1e-12 ->
    1) left the conic as cov2d's adjugate, entries ~3e7.  The well-posed
    outputs (means2d, depth, colour) agree between the card, the port and
    JAX; the conic does not, in either package: one float32 ulp of the
    row's x position (a relative change of 1e-7) moves it by more than 10%
    in the port and in JAX."""
    c = rec["proj_cov2d"]
    assert np.float32(c[0] * c[3]) - np.float32(c[1] * c[2]) == 0.0
    assert float(c[0]) * float(c[3]) - float(c[1]) * float(c[2]) > 0.0
    np.testing.assert_array_equal(rec["proj_conic"], [c[3], -c[1], -c[2], c[0]])
    np.testing.assert_array_equal(rec["packed_row"][2:6], rec["proj_conic"])
    well_posed = [0, 1, 6, 7, 8, 9, 10]  # means2d, colour, opacity, depth
    for side in ("port", "jax"):
        np.testing.assert_allclose(rows[side][0][well_posed], rec["packed_row"][well_posed],
                                   rtol=1e-5, atol=1e-5, err_msg=side)
    row = _row_params(rec)
    nudged = {**row, "xyz": row["xyz"].copy()}
    nudged["xyz"][0, 0] = np.nextafter(row["xyz"][0, 0], np.float32(np.inf))
    for side, fn in (("port", lambda r: port_row(rec, r, rec["d_packed"])[0]),
                     ("jax", lambda r: jax_row(r, rec["d_packed"])[0])):
        base, moved = fn(row)[2:6], fn(nudged)[2:6]
        assert np.max(np.abs(moved - base)) > 0.1 * np.max(np.abs(base)), side


@pytest.fixture(scope="module")
def raster(rec):
    """The recorded tiles' backward, JAX's and K3's plain version on the same
    forward: as recorded, and with the row's own record taken out of them
    (the buffer keeps its width, so JAX compiles its kernel once)."""
    records, start, count, geom, cot, block, ids, first = _tiles(rec)
    pick, cols = _row_columns(rec, first)
    with_row = _backward_both(records, start, count, geom, cot, rec)
    keep = np.ones(records.shape[1], bool)
    keep[cols] = False
    dropped = np.zeros_like(records)
    dropped[:, :keep.sum()] = records[:, keep]
    start_d = start - np.searchsorted(cols, start).astype(np.int32)
    count_d = count.copy()
    count_d[ids] -= 1
    without = _backward_both(dropped, start_d, count_d, geom, cot, rec)
    n = int(np.sum(rec["tile_kept"]))
    return dict(with_row=with_row, without=without, pick=pick, cols=cols, ids=ids,
                block=block, n_without=n - len(cols))


def test_compositing_turns_the_row_nonfinite_as_jax(rec, raster):
    """On the recorded tiles the row's exponent is float32 noise: its exact
    value (float64 over the stored inputs) is below -1e7 at every pixel, but
    its three terms, of ~1e15, cancel, and rounded it overflows exp at some
    pixels, where every formulation then makes 0 * inf.  JAX's compositing
    backward, K3's plain version and K3 on the card all leave the row's
    means2d, conic and opacity cotangents non-finite and its colour
    cotangents finite, the card's summed cotangent (d_packed) too; K3 on the
    card and JAX give non-finite rows on the same tiles."""
    _, want, port = raster["with_row"]
    cols, pick = raster["cols"], raster["pick"]
    expect = ~np.isfinite(rec["d_packed"])
    np.testing.assert_array_equal(expect, [True] * 6 + [False] * 3 + [True, False])
    for name, rows in (("JAX", want), ("plain", port)):
        np.testing.assert_array_equal(~np.isfinite(_segment_sum(rows, cols)), expect,
                                      err_msg=name)
    card = np.asarray(rec["k3_rows"])[:, pick]
    np.testing.assert_array_equal(~np.isfinite(_segment_sum(card, range(len(pick)))), expect)
    np.testing.assert_array_equal(np.isfinite(card[:11]), np.isfinite(want[:11, cols]))
    # The exact exponent of the row's record at each pixel of its tiles.
    grid_w, _, tile_w, tile_h = (int(v) for v in rec["grid"])
    mx, my, c00, c01, c10, c11 = (float(v) for v in rec["packed_row"][:6])
    pix = np.arange(tile_w * tile_h)
    for t in rec["tile_ids"]:
        dx = (t % grid_w) * tile_w + pix % tile_w - mx
        dy = (t // grid_w) * tile_h + pix // tile_w - my
        assert np.max(-0.5 * (dx * dx * c00 + dy * dy * c11 + dx * dy * (c01 + c10))) < -1e7


def test_compositing_matches_jax_without_the_row(rec, raster):
    """The recorded tiles with the row's record taken out (~2,400-3,200
    records each, pixels ending near full opacity): a finite forward, and
    every record's gradient rows of K3's plain version within the JAX early
    exit's bar of JAX's VJP (rtol 5e-3 / atol 5e-4 of each row's largest:
    the kernel rebuilds T from 1 - alpha, which loses a few percent near
    T = 1e-4; ROADMAP "Differences that are not faults")."""
    out, want, port = raster["without"]
    n = raster["n_without"]
    np.testing.assert_array_equal(np.isfinite(out), True)
    for r in range(11):
        assert_same(port[r, :n], want[r, :n], 5e-3, 5e-4, f"row {r}")


def test_chain_from_the_recorded_cotangent_matches_jax(rec, rows):
    """From the cotangent K4 handed the projection on the card: the row's
    VJP and Adam step through the JAX package and through the port leave the
    same non-finite parameters as the card's step (position, scales,
    rotation, opacity; not the colour), and equal finite ones."""
    new = {side: adam_steps(rec, rows[side][1])[side][0] for side in ("port", "jax")}
    for n in PARAM_NAMES:
        assert_same(new["port"][n], new["jax"][n], 1e-5, 1e-7, f"new {n}")
        assert_same(rec[f"post_param_{n}"], new["port"][n], 1e-5, 1e-7, f"card: new {n}")
        assert np.isfinite(rec[f"post_param_{n}"]).all() == (n in ("features_dc",
                                                                   "features_rest")), n


def adam_steps(rec, grads):
    """Adam's update of the row at the recorded moments and learning rates,
    from ``grads``: {"port": (p, m, v), "jax": (p, m, v)}, each a dict by
    parameter name."""
    opts = {k: rec[f"adam_{k}"].item() for k in ("beta1", "beta2", "eps", "bias_correction")}
    pre = {n: np.asarray(rec[f"pre_param_{n}"], np.float32) for n in PARAM_NAMES}
    m = {n: np.asarray(rec[f"pre_m_{n}"], np.float32) for n in PARAM_NAMES}
    v = {n: np.asarray(rec[f"pre_v_{n}"], np.float32) for n in PARAM_NAMES}
    lrs = {n: np.float32(rec[f"lr_{n}"]) for n in PARAM_NAMES}
    g = {n: np.asarray(grads[n], np.float32) for n in PARAM_NAMES}
    count = int(rec["adam_count"])

    tp = {n: torch.tensor(pre[n]) for n in PARAM_NAMES}
    state = optimizer.AdamState(m={n: torch.tensor(m[n]) for n in PARAM_NAMES},
                                v={n: torch.tensor(v[n]) for n in PARAM_NAMES},
                                count=torch.tensor(count, dtype=torch.int32))
    with np.errstate(all="ignore"):
        optimizer.update(tp, {n: torch.tensor(g[n]) for n in PARAM_NAMES}, state,
                         {n: torch.tensor(lrs[n]) for n in PARAM_NAMES}, **opts)
    jp, jstate = jax_optimizer.update(
        {n: jnp.asarray(pre[n]) for n in PARAM_NAMES}, {n: jnp.asarray(g[n]) for n in PARAM_NAMES},
        jax_optimizer.AdamState(m={n: jnp.asarray(m[n]) for n in PARAM_NAMES},
                                v={n: jnp.asarray(v[n]) for n in PARAM_NAMES},
                                count=jnp.int32(count)),
        {n: jnp.float32(lrs[n]) for n in PARAM_NAMES}, **opts)
    return {"port": ({n: tp[n].numpy() for n in PARAM_NAMES},
                     {n: state.m[n].numpy() for n in PARAM_NAMES},
                     {n: state.v[n].numpy() for n in PARAM_NAMES}),
            "jax": ({n: np.asarray(jp[n]) for n in PARAM_NAMES},
                    {n: np.asarray(jstate.m[n]) for n in PARAM_NAMES},
                    {n: np.asarray(jstate.v[n]) for n in PARAM_NAMES})}


def test_adam_update_matches_jax(rec):
    """The row's Adam step from the gradient the card's step took: the port
    against JAX, and both against the row the card's step left."""
    grads = {n: rec[f"grad_{n}"] for n in PARAM_NAMES}
    steps = adam_steps(rec, grads)
    for i, what in enumerate(("param", "m", "v")):
        for n in PARAM_NAMES:
            got, want = steps["port"][i][n], steps["jax"][i][n]
            assert_same(got, want, 1e-5, 1e-7, f"port vs JAX: {what} {n}")
            assert_same(rec[f"post_{what}_{n}"], got, 1e-5, 1e-7, f"card vs CPU: {what} {n}")
