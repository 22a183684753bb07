"""Scenes of ``staging.F32_ID_LIMIT`` (2^24) Gaussians or more.

Gaussian ids ride as f32 values in K2's merge table and in the aligned
layout's record row 11, exact only below 2^24.  The sorted layouts send
such scenes to K5's int32 route whatever the budget; the aligned layout
refuses them; the split layout carries ids as integers and takes them as it
is.  On the CPU the limit is lowered with monkeypatch: a render and a sorted
training step above it must give exactly what they give with the limit
unpatched (pair order, records, gids, image, gradients, Adam's update), on
each side of a lowered ``K2_MAX_SLOTS``.  On the card (skipped without one)
a scene of 2^24 + 160 culled rows and then 2^20 live ones renders and
trains as its live rows alone, and those rows render and train at
a budget of 2^27 slots as at their own; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_many_gaussians.py
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import CHUNK, TILE, H, W, require_cuda, scene_numpy

from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import merge_cuda, projection, rasterize_ref, staging
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import optimizer, trainer
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera, camera_args

N, SH = 200, 1
ID_LIMIT = 128  # the lowered id limit: below N
K2_SLOTS = 2048  # the lowered K2_MAX_SLOTS
BUDGETS = (1536, 4096)  # one on each side of K2_SLOTS


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.detach()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.equal(_bits(got), _bits(want)), name


def _scene():
    params, c2w = scene_numpy(n=N, seed=3, sh_degree=SH, sh_rest_scale=0.1)
    return params, Camera.from_c2w(W, H, 60.0, 60.0, c2w).tensors()


def _raster(budget, **selectors):
    return config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=budget,
                                   chunk_size=CHUNK, **selectors)


def _state(params):
    gp = gaussians.params_from_numpy(params, "cpu")
    adam0 = optimizer.init(gp.tensors())
    return trainer.TrainState(
        params=gp, m=adam0.m, v=adam0.v, count=adam0.count,
        num_active=torch.tensor(N, dtype=torch.int32),
        grad_accum=torch.zeros((N,), dtype=torch.float32),
        grad_denom=torch.zeros((), dtype=torch.float32),
        step=torch.tensor(0, dtype=torch.int32),
        overflow_acc=torch.zeros((2,), dtype=torch.float32))


def _views(cam):
    views = {k: torch.as_tensor(np.asarray(cam[k], np.float32))[None]
             for k in ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x",
                       "focal_y")}
    views["target_rgb"] = torch.as_tensor(
        np.random.default_rng(5).uniform(size=(1, H, W, 3)).astype(np.float32))
    views["target_depth"] = torch.zeros((1, H, W))
    views["depth_mask"] = torch.zeros((1, H, W))
    return views


def _staging_inputs(params, cam):
    """(packed, rect_min, rect_max, radii, depths) of the scene's view."""
    act = gaussians.activations(gaussians.params_from_numpy(params, "cpu").tensors())
    means, shs, opacity, scales, rots = act
    c = camera_args(cam, "cpu")
    with torch.no_grad():
        p = projection.project_gaussians(means, scales, rots, shs, *c, W, H, SH)
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity,
                                              p.depths)
    return packed, p.rect_min, p.rect_max, p.radii, p.depths


def _everything(budget):
    """What the slice gives at ``budget``: the sorted training staging's
    buffers, the served and the trained image, and one training step's
    gradients (Adam's first moment) and updated state."""
    params, cam = _scene()
    st = staging.StagingStatic(W, H, TILE, TILE, budget, CHUNK)
    staged, gid = staging._stage_train_impl(st, *_staging_inputs(params, cam))
    out = {"records": staged.records_cm, "gid": gid, "tile_start": staged.tile_start,
           "tile_count": staged.tile_count, "num_pairs": staged.num_pairs}
    act = gaussians.activations(gaussians.params_from_numpy(params, "cpu").tensors())
    serve, _ = render(*act, *camera_args(cam, "cpu"), W, H, SH, raster_cfg=_raster(budget),
                      inference=True)
    out["served"] = serve.color
    cfg = config.TrainConfig(iterations=100, model=config.ModelConfig(sh_degree=SH),
                             raster=_raster(budget))
    step = trainer.make_train_step(cfg, W, H, SH, 100)
    state, metrics, color = step(_state(params), _views(cam), 0)
    out["trained"] = color
    out["loss"] = metrics["loss"]
    for name in gaussians.PARAM_NAMES:
        out[f"m.{name}"] = state.m[name]
        out[f"v.{name}"] = state.v[name]
        out[f"param.{name}"] = getattr(state.params, name)
    return out


def _merges(monkeypatch):
    """Record which merge each staging calls: K2 (merge_gather) or K5
    (merge_ranks)."""
    calls = []
    for name in ("merge_gather", "merge_ranks"):
        real = getattr(merge_cuda, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(merge_cuda, name, spy)
    return calls


@pytest.mark.parametrize("budget", BUDGETS)
def test_above_the_id_limit_the_sorted_layout_gives_the_same_bits(monkeypatch, budget):
    calls = _merges(monkeypatch)
    monkeypatch.setattr(staging, "K2_MAX_SLOTS", K2_SLOTS)
    want = _everything(budget)
    below = set(calls)
    calls.clear()
    monkeypatch.setattr(staging, "F32_ID_LIMIT", ID_LIMIT)
    got = _everything(budget)
    # Above the id limit every staging merges through K5, whatever the
    # budget; with the limit unpatched a budget under K2_MAX_SLOTS takes K2.
    assert set(calls) == {"merge_ranks"}, calls
    assert below == ({"merge_gather"} if budget <= K2_SLOTS else {"merge_ranks"}), below
    assert 0 < int(want["num_pairs"]) and float(want["served"].max()) > 0.1
    assert torch.count_nonzero(want["m.xyz"]) > 0
    for name in want:
        _assert_bit_equal(got[name], want[name], name)


def test_the_route_above_the_id_limit_is_k5s(monkeypatch):
    """_sorted_pairs sends a scene past the id limit to _ranked_pairs even at
    a budget K2 would take, and a scene below it to K2."""
    params, cam = _scene()
    args = _staging_inputs(params, cam)
    st = staging.StagingStatic(W, H, TILE, TILE, BUDGETS[0], CHUNK)
    routes = []
    real = staging._ranked_pairs
    monkeypatch.setattr(staging, "_ranked_pairs",
                        lambda *a: routes.append("ranked") or real(*a))
    monkeypatch.setattr(staging, "merge_table",
                        lambda *a, _real=staging.merge_table: routes.append("k2") or _real(*a))
    staging._sorted_pairs(st, *args)
    monkeypatch.setattr(staging, "F32_ID_LIMIT", N)  # N rows: at the limit
    staging._sorted_pairs(st, *args)
    assert routes == ["k2", "ranked"]
    with pytest.raises(ValueError, match="fewer than 200 Gaussians, got 200"):
        staging.merge_table(st, *args)


@pytest.mark.parametrize("budget", BUDGETS)
def test_the_aligned_layout_refuses_scenes_above_the_id_limit(monkeypatch, budget):
    params, cam = _scene()
    act = gaussians.activations(gaussians.params_from_numpy(params, "cpu").tensors())
    rc = _raster(budget, train_staging="aligned")
    render(*act, *camera_args(cam, "cpu"), W, H, SH, raster_cfg=rc)  # below the limit
    monkeypatch.setattr(staging, "F32_ID_LIMIT", ID_LIMIT)
    with pytest.raises(ValueError, match=r"record row 11.*fewer than 128 Gaussians; got 200"
                                         r".*sorted layout"):
        render(*act, *camera_args(cam, "cpu"), W, H, SH, raster_cfg=rc)


@pytest.mark.parametrize("inference", [True, False])
def test_the_split_layout_carries_integer_ids_past_the_id_limit(monkeypatch, inference):
    """The split layout gathers records by int64 index and reduces by int32
    gid: the limit plays no part in it."""
    params, cam = _scene()

    def run():
        gp = gaussians.params_from_numpy(params, "cpu")
        out, _ = render(*gaussians.activations(gp.tensors()), *camera_args(cam, "cpu"),
                        W, H, SH, raster_cfg=_raster(BUDGETS[1], staging="split"),
                        inference=inference)
        if inference:
            return [out.color]
        out.color.square().sum().backward()
        return [out.color] + [t.grad for t in gp.tensors().values()]

    want = run()
    monkeypatch.setattr(staging, "F32_ID_LIMIT", ID_LIMIT)
    for k, (g, w) in enumerate(zip(run(), want)):
        _assert_bit_equal(g, w, str(k))


# --- on the card -----------------------------------------------------------------

CARD_LIVE = 2 ** 20
# K4 (csrc/segsum.cu) sums each Gaussian's columns along a merge path cut
# into stretches of 224 steps, one step a segment end: every culled row is an
# empty segment, so a culled count that is not a multiple of 224 cuts the
# live rows' segments elsewhere and regroups their adds.  2^24 + 160 is.
K4_STRETCH = 224
CARD_CULLED = 2 ** 24 + 160
CARD_W = CARD_H = 256
CARD_BUDGET = 2 ** 22
WIDE_BUDGET = 2 ** 27 + 4096


def _card_live_rows(device):
    """2^20 Gaussians in front of the camera at z = -4 (SH degree 3)."""
    gen = torch.Generator(device=device).manual_seed(23)
    n = CARD_LIVE
    f32 = dict(dtype=torch.float32, device=device)
    rot = torch.randn((n, 4), generator=gen, **f32)
    return {
        "xyz": torch.randn((n, 3), generator=gen, **f32) * 0.6,
        "features_dc": torch.rand((n, 1, 3), generator=gen, **f32) * 3.0 - 1.5,
        "features_rest": torch.randn((n, 15, 3), generator=gen, **f32) * 0.02,
        "scales": torch.log(torch.rand((n, 3), generator=gen, **f32) * 0.006 + 0.002),
        "rotation": rot,
        "opacity": torch.randn((n, 1), generator=gen, **f32) * 2.0,
    }


def _with_culled(live):
    """``CARD_CULLED`` rows behind the camera (view depth < 0: radius 0), then
    ``live``."""
    out = {}
    for k, x in live.items():
        pad = torch.zeros((CARD_CULLED,) + x.shape[1:], dtype=x.dtype, device=x.device)
        if k == "xyz":
            pad[:, 2] = -10.0
        if k == "rotation":
            pad[:, 0] = 1.0
        if k == "scales":
            pad[:] = -5.0
        out[k] = torch.cat([pad, x])
    return out


def _card_step(raw, budget, device):
    """Image, pairs and d loss / d raw leaf of one training render, and the
    served image, at ``budget``."""
    cam = Camera.from_c2w(CARD_W, CARD_H, 300.0, 300.0, scene_numpy()[1]).tensors()
    args = camera_args(cam, device)
    gp = gaussians.GaussianParams(**{k: x.clone() for k, x in raw.items()})
    rc = config.RasterizerConfig(tile_h=16, tile_w=16, max_pairs=budget, chunk_size=128)
    act = gaussians.activations(gp.tensors())
    out, aux = render(*act, *args, CARD_W, CARD_H, 3, raster_cfg=rc)
    weight = torch.rand((CARD_H, CARD_W, 3), generator=torch.Generator(device=device)
                        .manual_seed(5), device=device)
    (out.color * weight).sum().backward()
    with torch.no_grad():
        served, _ = render(*act, *args, CARD_W, CARD_H, 3, raster_cfg=rc, inference=True)
    grads = {k: getattr(gp, k).grad for k in gaussians.PARAM_NAMES}
    return out.color.detach(), served.color, int(aux.num_pairs), int(aux.overflow_pairs), grads


@pytest.mark.cuda
def test_a_scene_past_2_24_rows_trains_as_its_live_rows_on_the_card():
    """An f32 id would round the odd ids past 2^24 and put their gradient
    rows on the wrong Gaussian.  Images compare bit for bit; gradients by
    value (K4 may add a first segment's sum to a +0 carry, which turns a -0
    into +0)."""
    require_cuda()
    assert CARD_CULLED % K4_STRETCH == 0 and CARD_CULLED > 2 ** 24
    dev = "cuda"
    live = _card_live_rows(dev)
    img, served, pairs, over, grads = _card_step(live, CARD_BUDGET, dev)
    assert 10 ** 6 < pairs <= CARD_BUDGET and over == 0
    assert float(img.max()) > 0.5
    calls = []
    real = merge_cuda.merge_ranks
    merge_cuda.merge_ranks = lambda *a: calls.append(1) or real(*a)
    try:
        big = _card_step(_with_culled(live), CARD_BUDGET, dev)
    finally:
        merge_cuda.merge_ranks = real
    assert calls, "a scene past 2^24 rows merges through K5"
    _assert_bit_equal(big[0], img, "image")
    _assert_bit_equal(big[1], served, "served image")
    assert big[2] == pairs and big[3] == 0
    for name, g in grads.items():
        assert torch.count_nonzero(g) > 0, name
        assert torch.equal(big[4][name][CARD_CULLED:], g), name
        assert not bool(big[4][name][:CARD_CULLED].any()), name
    del big
    # The live rows at 2^27 slots (the record buffer past 2^31 elements).
    wide = _card_step(live, WIDE_BUDGET, dev)
    _assert_bit_equal(wide[0], img, "image at 2^27 slots")
    _assert_bit_equal(wide[1], served, "served image at 2^27 slots")
    assert wide[2] == pairs
    for name, g in grads.items():
        assert torch.equal(wide[4][name], g), f"{name} at 2^27 slots"
