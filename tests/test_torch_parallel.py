"""The port's data- and tile-parallel training (``gaussiansplattingmlx_tpu_torch/
parallel/``) against the JAX package's (``parallel/sharding.py``), on the
tests/test_sharding.py scene (60 Gaussians, 8 orbit views, 48x48) at its
RASTER8 (tile 8, so a 2-band split keeps the 24-row band a multiple of the
tile height, and a budget that truncates nothing).

The port's ranks run on the CPU over gloo (``parallel.launch.spawn``: 60 s
collective timeout, join timeout), the JAX side on conftest's 8-device CPU
mesh with backend="pallas_interpret".  Tolerances:

* the port's parallel step against the port's own one-device computation
  (one rasterizer, the sums in another order): the JAX package's bars for
  its sharded step against its one-device step (tests/test_sharding.py);
* the port against the JAX package (two rasterizers): the bars of the
  port's one-device step against JAX's (tests/test_torch_train_step.py:
  loss and parts rtol 1e-4; after Adam's first step, which moves a
  parameter by ~3.16 lr sign(g), parameters at rtol 1e-5 / atol 1e-7 where
  |g| > 1e-3 max|g| and within 7 lr elsewhere; the moments, 0.1 g and
  0.001 g^2, as g at the gradient bars rtol 2e-3 / atol 2e-4 x max|g|;
  grad_accum rtol 1e-3 / atol 1e-6), pair and overflow counts equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_sharding import RASTER8, build_state, make_cfg
from test_torch_train_loop import _jax_state_arrays
from test_train_smoke import H, W, orbit_cameras
from torch_port_helpers import assert_images_close, outputs_numpy, to_numpy
import torch_parallel_workers as workers

from gaussiansplattingmlx_tpu.data.dataset import TrainData as JaxTrainData
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.parallel import sharding as jax_sharding
from gaussiansplattingmlx_tpu.render import render as jax_render
from gaussiansplattingmlx_tpu.train import trainer as jax_trainer
from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud as JaxPointCloud
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.parallel import launch, multihost, sharding
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import trainer
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera
from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud

JAX_RASTER = dataclasses.replace(RASTER8, backend="pallas_interpret")
PORT_RASTER = dict(tile_h=RASTER8.tile_h, tile_w=RASTER8.tile_w,
                   max_pairs=RASTER8.max_pairs, chunk_size=RASTER8.chunk_size)
SPAWN = dict(device="cpu", pg_timeout=60.0, timeout=240.0)
VIEWS = [1, 4]  # tests/test_sharding.py's two-view step


def port_cfg(**kw):
    base = dict(iterations=10, init_points=60, log_interval=1, snapshot_interval=10 ** 9,
                checkpoint_interval=0, output_dir="",
                model=config.ModelConfig(sh_degree=0, initial_capacity=64),
                raster=config.RasterizerConfig(**PORT_RASTER),
                densify=config.DensifyConfig(from_iter=10 ** 9))
    base.update(kw)
    return config.TrainConfig(**base)


@pytest.fixture(scope="module")
def scene():
    """tests/test_sharding.py's scene: test_train_smoke.synth_scene's 60
    solid Gaussians (seed 42), rendered from 8 orbit views by the port's
    inference path as targets; the JAX and the port's view stores; the
    JAX build_state as numpy."""
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(60, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(60, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=0, capacity=60,
                                              device="cpu")
    with torch.no_grad():
        params.scales.fill_(float(np.log(0.15)))
        params.opacity.fill_(2.0)
    jcams = orbit_cameras(8)
    cams = [Camera.from_c2w(W, H, c.focal_x, c.focal_y, c.c2w) for c in jcams]
    images = []
    for cam in cams:
        t = cam.tensors()
        with torch.no_grad():
            out, _ = render(*gaussians.activations(params),
                            *(torch.as_tensor(t[k]) for k in ("view", "proj", "camera_center")),
                            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, 0,
                            raster_cfg=config.RasterizerConfig(**PORT_RASTER), inference=True)
        images.append(to_numpy(out.color))
    images = np.stack(images).astype(np.float32)
    data = TrainData(cams, images)
    jdata = JaxTrainData(cameras=jcams, images=images)
    # Both packages' steps read the JAX package's view tensors (its cameras
    # round differently from the port's in the last bits).
    jviews = jax_trainer.stack_views(jdata)
    views_np = {k: np.asarray(v) for k, v in jviews.items()}
    return dict(pts=pts, cols=cols, data=data, jdata=jdata, views_np=views_np,
                jviews=jviews, state_np=_jax_state_arrays(build_state(pts, cols)))


def _jax_step(scene, data, tile, idx):
    mesh = jax_sharding.make_mesh(data, tile, devices=jax.devices()[:data * tile])
    cfg = make_cfg(JAX_RASTER)
    step = jax_sharding.make_dp_train_step(cfg, W, H, 0, cfg.iterations, mesh,
                                           backend="pallas_interpret")
    state = jax_sharding.replicate_state(build_state(scene["pts"], scene["cols"]), mesh)
    new, metrics, _ = step(state, jax_sharding.replicate_views(scene["jviews"], mesh),
                           jax_sharding.shard_view_idx(idx, mesh))
    return {"state": _jax_state_arrays(new),
            "metrics": {k: float(v) for k, v in metrics.items()}}


RUNS = {"d2": (2, 1, VIEWS), "t2": (1, 2, VIEWS[:1]), "d2t2": (2, 2, VIEWS)}


@pytest.fixture(scope="module")
def steps(scene):
    """One step of each mesh from the same state: the port's ranks (2 for
    the data and the tile split, 4 for both) and the JAX package's."""
    cfg = port_cfg()
    args = (cfg, W, H, scene["views_np"], scene["state_np"])
    two, _ = launch.spawn(workers.steps, 2, args=args + (
        [(name, d, t, idx, None) for name, (d, t, idx) in RUNS.items() if d * t == 2],),
        **SPAWN)
    four, _ = launch.spawn(workers.steps, 4, args=args + ([("d2t2", 2, 2, VIEWS, None)],),
                           **SPAWN)
    port = {**two, **four}
    want = {name: _jax_step(scene, d, t, idx) for name, (d, t, idx) in RUNS.items()}
    return port, want


def _learning_rates(cfg):
    return gaussians.learning_rates(torch.zeros((), dtype=torch.int32), cfg.iterations)


def assert_step_matches_jax(got, want):
    """The cross-package bars of the module docstring."""
    gm, wm = got["metrics"], want["metrics"]
    for key in ("loss", "l1", "ssim", "psnr"):
        np.testing.assert_allclose(gm[key], wm[key], rtol=1e-4, err_msg=key)
    for key in ("num_pairs", "overflow_pairs", "overflow_gaussians", "overflow_pairs_acc"):
        assert gm[key] == wm[key], (key, gm[key], wm[key])
    assert gm["overflow_pairs"] == 0
    lrs = _learning_rates(port_cfg())
    gs, ws = got["state"], want["state"]
    for n in gaussians.PARAM_NAMES:
        g = 10.0 * ws[f"adam_m_{n}"]  # m = 0.1 g after the first step
        if g.size == 0:  # features_rest at SH degree 0
            continue
        np.testing.assert_allclose(gs[f"adam_m_{n}"], ws[f"adam_m_{n}"], rtol=2e-3,
                                   atol=2e-4 * 0.1 * np.abs(g).max(), err_msg=n)
        # v = 0.001 g^2 after the first step: |g| at the same bars.
        np.testing.assert_allclose(np.sqrt(gs[f"adam_v_{n}"] / 1e-3),
                                   np.sqrt(ws[f"adam_v_{n}"] / 1e-3), rtol=2e-3,
                                   atol=2e-4 * np.abs(g).max(), err_msg=n)
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(gs[f"param_{n}"][big], ws[f"param_{n}"][big],
                                   rtol=1e-5, atol=1e-7, err_msg=n)
        assert np.all(np.abs(gs[f"param_{n}"] - ws[f"param_{n}"])[~big]
                      <= 7 * float(lrs[n])), n
    np.testing.assert_allclose(gs["grad_accum"], ws["grad_accum"], rtol=1e-3, atol=1e-6)
    for key in ("adam_count", "num_active", "grad_denom", "step", "overflow_acc"):
        np.testing.assert_array_equal(gs[key], ws[key], err_msg=key)


def _one_device(scene, view_ids):
    """The port's one-device computation on the CPU: each view's gradient
    from the same state, averaged, then Adam.  Returns (state as numpy,
    the mean loss, SSIM and per-view |d xyz|)."""
    cfg = port_cfg()
    state = trainer.state_from_numpy(scene["state_np"], "cpu")
    views = {k: torch.as_tensor(v) for k, v in scene["views_np"].items()}
    losses, ssims, grads = [], [], []
    for i in view_ids:
        def take(k):
            return views[k][i]

        leaves, _, out, _ = trainer.render_view(cfg, state, take, W, H, 0)
        loss, parts = trainer.view_loss(cfg, out.color, out.depth, take)
        grads.append(trainer.param_grads(loss, leaves))
        losses.append(float(loss.detach()))
        ssims.append(float(parts["ssim"].detach()))
    mean = {n: sum(g[n] for g in grads) / len(grads) for n in gaussians.PARAM_NAMES}
    norms = [torch.sqrt(torch.sum(g["xyz"] * g["xyz"], dim=1)).numpy() for g in grads]
    trainer.adam_step(cfg, state, state.params.tensors(), mean, cfg.iterations)
    return (trainer.state_to_numpy(state), float(np.mean(losses)), float(np.mean(ssims)),
            np.mean(norms, axis=0))


def test_dp_step_matches_jax_and_mean_of_views(scene, steps):
    """D=2 on views (1, 4): the JAX package's D=2 step; and, at its bars
    (tests/test_sharding.py::test_dp_matches_mean_of_single_steps), the
    port's one-device gradients of the two views averaged, then Adam: the
    densify statistic is the mean of the per-view norms."""
    port, want = steps
    got = port["d2"]
    assert_step_matches_jax(got, want["d2"])
    ref, loss, _, norm = _one_device(scene, VIEWS)
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(got["state"]["grad_accum"], norm, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got["state"]["param_xyz"], ref["param_xyz"], rtol=1e-4,
                               atol=1e-6)
    assert got["image"].shape == (H, W, 3)


def test_tile_step_matches_jax_and_one_device(scene, steps):
    """T=2 (two 24-row bands of view 1): the JAX package's T=2 step; and, at
    its bars (tests/test_sharding.py::test_tile_parallel_matches_single_device),
    the port's one-device train step: the SSIM seam is exact."""
    port, want = steps
    got = port["t2"]
    assert_step_matches_jax(got, want["t2"])
    cfg = port_cfg()
    state = trainer.state_from_numpy(scene["state_np"], "cpu")
    ref_state, ref_metrics, color = trainer.make_train_step(cfg, W, H, 0, cfg.iterations)(
        state, {k: torch.as_tensor(v) for k, v in scene["views_np"].items()}, VIEWS[0])
    ref = trainer.state_to_numpy(ref_state)
    for key in ("loss", "ssim"):
        np.testing.assert_allclose(got["metrics"][key], float(ref_metrics[key]), rtol=1e-6,
                                   err_msg=key)
    for n in ("xyz", "scales", "opacity", "features_dc"):
        np.testing.assert_allclose(got["state"][f"param_{n}"], ref[f"param_{n}"], rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    np.testing.assert_allclose(got["state"]["grad_accum"], ref["grad_accum"], rtol=1e-4,
                               atol=1e-9)
    assert got["metrics"]["num_pairs"] == float(ref_metrics["num_pairs"])
    np.testing.assert_allclose(got["image"], to_numpy(color), rtol=1e-4, atol=1e-5)


def test_data_x_tile_step_matches_jax_and_data_only(steps):
    """D=2 x T=2 (four ranks): the JAX package's (2, 2) step; and, at its
    bars (tests/test_sharding.py::test_data_x_tile_mesh), the port's D=2 x
    T=1 step: the tile split changes nothing."""
    port, want = steps
    got, d2 = port["d2t2"], port["d2"]
    assert_step_matches_jax(got, want["d2t2"])
    np.testing.assert_allclose(got["metrics"]["loss"], d2["metrics"]["loss"], rtol=1e-6)
    for n in ("xyz", "scales", "opacity"):
        np.testing.assert_allclose(got["state"][f"param_{n}"], d2["state"][f"param_{n}"],
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    np.testing.assert_allclose(got["state"]["grad_accum"], d2["state"]["grad_accum"],
                               rtol=1e-4, atol=1e-9)
    assert got["metrics"]["num_pairs"] == d2["metrics"]["num_pairs"]


def _jax_bands(scene, layout, band_h, inference=False):
    """The JAX package's render of each band of view 0 (one jitted
    function, called once a band)."""
    st = build_state(scene["pts"], scene["cols"])
    active = jax_gaussians.active_mask(st.params, st.num_active)
    acts = jax_gaussians.activations(st.params, active)
    t = scene["jdata"].cameras[0].tensors()
    rc = dataclasses.replace(JAX_RASTER, **layout)

    @jax.jit
    def go(acts, active, view, proj, center, off):
        return jax_render(*acts, view, proj, center, t["fov_x"], t["fov_y"], t["focal_x"],
                          t["focal_y"], W, band_h, 0, raster_cfg=rc, backend="pallas_interpret",
                          pixel_y_offset=off, full_image_height=H, active=active,
                          inference=inference)

    cam = (jnp.asarray(t["view"]), jnp.asarray(t["proj"]), jnp.asarray(t["camera_center"]))
    return [go(acts, active, *cam, jnp.float32(b * band_h)) for b in range(H // band_h)]


@pytest.mark.parametrize("layout", [*config.LAYOUTS, "serving"])
def test_band_render_matches_jax(scene, layout):
    """The port's render of each 24-row band of view 0 against the JAX
    package's render(pixel_y_offset=..., full_image_height=...): the
    training render in each record layout, and the serving render
    (inference=True); the stitched bands are the port's full render."""
    inference = layout == "serving"
    selector = {} if inference else config.LAYOUTS[layout]
    state = trainer.state_from_numpy(scene["state_np"], "cpu")
    raster = config.RasterizerConfig(**PORT_RASTER, **selector)
    active = gaussians.active_mask(state.params.capacity, state.num_active)
    cam = [torch.as_tensor(scene["views_np"][k][0]) for k in
           ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")]
    band_h = H // 2

    def port(height, **band):
        return render(*gaussians.activations(state.params, active), *cam, W, height, 0,
                      raster_cfg=raster, active=active, inference=inference, **band)

    with torch.no_grad():
        full, full_aux = port(H)
        bands, pairs = [], 0
        for b, (want, want_aux) in enumerate(_jax_bands(scene, selector, band_h, inference)):
            out, aux = port(band_h, pixel_y_offset=b * band_h, full_image_height=H)
            assert int(aux.num_pairs) == int(want_aux.num_pairs) > 0
            assert int(aux.overflow_pairs) == int(want_aux.overflow_pairs) == 0
            assert_images_close(outputs_numpy(out), outputs_numpy(want))
            bands.append(outputs_numpy(out))
            pairs += int(aux.num_pairs)
    whole = outputs_numpy(full)
    for key in ("color", "alpha"):
        np.testing.assert_allclose(np.concatenate([b[key] for b in bands]), whole[key],
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert pairs == int(full_aux.num_pairs)


# The Trainer: one densify round at step 3 that clones every Gaussian with
# any gradient (grad_threshold ~ 0, no split) into 128 slots, then the
# capacity growth to 256.
TRAINER = dict(iterations=5, init_points=60)
TRAINER_DENSIFY = dict(interval=3, from_iter=3, until_iter=3, grad_threshold=1e-9,
                       max_scale=1e9)


def test_trainer_two_ranks_densify_matches_jax(scene):
    """A 2-rank Trainer (data_parallel=2) with one densify round against the
    JAX package's Trainer on a (2, 1) mesh, from its initial state, each
    side drawing its own densify noise (the same stream): the same view
    pairs every step, the same live counts, losses within rtol 1e-4,
    parameters within 7 lr a step, the state bit-identical on both ranks,
    each rank's key JAX's."""
    from gaussiansplattingmlx_tpu import config as jax_config

    pts, cols, images = scene["pts"], scene["cols"], scene["data"].images
    noisy = pts + np.random.default_rng(1).normal(size=pts.shape).astype(np.float32) * 0.05
    jcfg = jax_config.TrainConfig(
        **TRAINER, log_interval=1, snapshot_interval=10 ** 9, checkpoint_interval=0,
        output_dir="", early_stop_loss=1e-7,
        model=jax_config.ModelConfig(sh_degree=0, initial_capacity=128, max_gaussians=512),
        raster=JAX_RASTER, densify=jax_config.DensifyConfig(**TRAINER_DENSIFY),
        parallel=jax_config.ParallelConfig(data_parallel=2))
    mesh = jax_sharding.make_mesh(2, 1, devices=jax.devices()[:2])
    jt = jax_trainer.Trainer(jcfg, scene["jdata"], JaxPointCloud(noisy, cols * 255.0),
                             mesh=mesh)
    state_np = _jax_state_arrays(jt.state)
    seen = []
    jstep = jt.train_step

    def recorded(state, views, idx):
        seen.append(np.asarray(idx).tolist())
        return jstep(state, views, idx)

    jt.train_step = recorded
    jlog = []
    jt.run(on_metrics=jlog.append)

    cfg = port_cfg(**TRAINER, early_stop_loss=1e-7,
                   model=config.ModelConfig(sh_degree=0, initial_capacity=128,
                                            max_gaussians=512),
                   densify=config.DensifyConfig(**TRAINER_DENSIFY),
                   parallel=config.ParallelConfig(data_parallel=2))
    got, reports = launch.spawn(workers.trainer_run, 2, args=(
        cfg, scene["data"], PointCloud(noisy, cols * 255.0), state_np), **SPAWN)
    assert [list(v) for v in zip(*(r["views"] for r in reports))] == seen
    assert reports[0]["digest"] == reports[1]["digest"]
    assert reports[0]["key"] == reports[1]["key"] == np.asarray(jt.key).tolist()
    tlog = got["history"]
    assert [m["iteration"] for m in tlog] == list(range(1, TRAINER["iterations"] + 1))
    assert [m["num_active"] for m in tlog] == [m["num_active"] for m in jlog]
    assert tlog[-1]["num_active"] > tlog[0]["num_active"]  # the round cloned
    for key in ("loss", "l1", "psnr"):
        np.testing.assert_allclose([m[key] for m in tlog], [m[key] for m in jlog],
                                   rtol=1e-4, err_msg=key)
    want = _jax_state_arrays(jt.state)
    assert got["state"]["param_xyz"].shape == want["param_xyz"].shape
    lr = float(_learning_rates(cfg)["xyz"])
    assert np.all(np.abs(got["state"]["param_xyz"] - want["param_xyz"])
                  <= 7 * lr * TRAINER["iterations"])


def test_band_height_not_multiple_of_tile_raises():
    """Exactness needs the band tiling to be the full image's: a 24-row band
    at tile 16 raises when the step is built (tests/test_sharding.py's
    precondition)."""
    mesh = sharding.Mesh(shape={"data": 1, "tile": 2}, data_index=0, tile_index=0,
                         ranks=(0, 1), group=None, data_group=None, tile_group=None)
    cfg = port_cfg(raster=config.RasterizerConfig(tile_h=16, tile_w=16))
    with pytest.raises(ValueError, match="multiple of tile_h"):
        sharding.make_dp_train_step(cfg, W, H, 0, 10, mesh)
    with pytest.raises(ValueError, match="divisible by the tile axis"):
        sharding.make_dp_train_step(cfg, W, 47, 0, 10, mesh)


def test_more_ranks_than_cards_raises(monkeypatch):
    """A bare 'cuda' gives each rank a card of its own: more ranks than
    cards raise before any rank starts (JAX: make_mesh's device check)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
        launch.spawn(workers.steps, 2, "cuda", args=())
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="local rank 1 has no card"):
        launch.rank_device("cuda")
    assert launch.rank_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.rank_device("cuda:0")


def test_prune_near_cameras_under_multihost_raises(scene, monkeypatch):
    """Per-host camera subsets would prune differently on each host: the
    Trainer refuses prune_near_cameras under multi-host training, as the
    JAX Trainer does."""
    monkeypatch.setattr(multihost, "host_count", lambda: 2)
    cfg = port_cfg(densify=config.DensifyConfig(prune_near_cameras=0.1))
    with pytest.raises(NotImplementedError, match="prune_near_cameras"):
        trainer.Trainer(cfg, scene["data"], PointCloud(scene["pts"], scene["cols"] * 255.0),
                        device="cpu")
