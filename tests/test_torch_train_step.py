"""The training step and loop: three steps of the port's make_train_step
against the JAX package's (backend="pallas_interpret", train_staging
"sorted") from one state carried across by state_from_numpy; the state's
round trip through the JAX checkpoint format; and the port's Trainer on a
small synthetic scene (loss falls, pair-budget auto-grow, unported parts
raise, the heartbeat and the loss curve)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import CHUNK, TILE, scene_numpy, to_numpy

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu.data.dataset import TrainData as JaxTrainData
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.train import checkpoint as jax_checkpoint
from gaussiansplattingmlx_tpu.train import optimizer as jax_adam
from gaussiansplattingmlx_tpu.train import trainer as jax_trainer
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import trainer
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera
from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud

W, H = 48, 48
N, CAP, SH = 80, 96, 1
ITERS = 100
RASTER = dict(tile_h=TILE, tile_w=TILE, max_pairs=4096, chunk_size=CHUNK)


def _jax_state():
    """A JAX TrainState of the staging scene padded to CAP slots (inactive
    slots as create_from_points pads them)."""
    params, _ = scene_numpy(n=N, seed=3, sh_degree=SH, sh_rest_scale=0.1)
    padded = {}
    for k, v in params.items():
        fill = np.zeros((CAP - N,) + v.shape[1:], np.float32)
        if k == "opacity":
            fill[:] = gaussians.INACTIVE_OPACITY
        if k == "rotation":
            fill[:, 0] = 1.0
        padded[k] = np.concatenate([v, fill])
    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in padded.items()})
    return jax_trainer.TrainState(
        params=gp, opt=jax_adam.init(gp), num_active=jnp.int32(N),
        grad_accum=jnp.zeros((CAP,), jnp.float32), grad_denom=jnp.float32(0.0),
        step=jnp.int32(0),
    )


def _views():
    _, c2w = scene_numpy(n=N, seed=3)
    c2ws = []
    for i in range(2):
        c = c2w.copy()
        c[0, 3] = 0.3 * i
        c2ws.append(c)
    images = np.random.default_rng(5).uniform(size=(2, H, W, 3)).astype(np.float32)
    return c2ws, images


def _carry(jstate, tmp_path, name="state.npz"):
    """JAX TrainState -> the port, through the JAX checkpoint file."""
    jax_checkpoint.save(tmp_path / name, jstate)
    return trainer.state_from_numpy(np.load(tmp_path / name), "cpu")


def check_train_steps(tmp_path, backend, views=(0, 1, 0)):
    """Steps of the port's make_train_step(backend=...) against the JAX
    package's with the same backend ("pallas_interpret": the port's kernels'
    plain versions against the JAX kernels in interpret mode), from one
    state carried across, on ``views``: losses and metrics at rtol 1e-4,
    the first step's parameters at rtol 1e-5 / atol 1e-7 where |g| >
    1e-3 max|g|."""
    c2ws, images = _views()
    jcfg = jax_config.TrainConfig(
        iterations=ITERS, model=jax_config.ModelConfig(sh_degree=SH),
        raster=jax_config.RasterizerConfig(**RASTER, backend=backend))
    tcfg = config.TrainConfig(iterations=ITERS, model=config.ModelConfig(sh_degree=SH),
                              raster=config.RasterizerConfig(**RASTER))
    jdata = JaxTrainData([JaxCamera.from_c2w(W, H, 60.0, 60.0, c) for c in c2ws], images)
    tdata = TrainData([Camera.from_c2w(W, H, 60.0, 60.0, c) for c in c2ws], images)
    jstate = _jax_state()
    tstate = _carry(jstate, tmp_path)
    jstep = jax_trainer.make_train_step(jcfg, W, H, SH, ITERS, backend=backend)
    tstep = trainer.make_train_step(tcfg, W, H, SH, ITERS, backend=backend)
    jviews, tviews = jax_trainer.stack_views(jdata), trainer.stack_views(tdata, "cpu")
    for k in jviews:
        np.testing.assert_array_equal(to_numpy(tviews[k]), np.asarray(jviews[k]), err_msg=k)

    before = {n: np.asarray(getattr(jstate.params, n)) for n in gaussians.PARAM_NAMES}
    lrs = gaussians.learning_rates(torch.zeros((), dtype=torch.int32), ITERS)
    for step, view in enumerate(views):
        jstate, jm, _ = jstep(jstate, jviews, jnp.int32(view))
        tstate, tm, color = tstep(tstate, tviews, view)
        assert color.shape == (H, W, 3)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        for key in ("num_pairs", "overflow_pairs", "overflow_pairs_acc", "grad_coverage"):
            assert float(tm[key]) == float(jm[key]), key
        for key in ("l1", "ssim", "psnr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, err_msg=key)
        assert int(tstate.step) == step + 1 and int(tstate.count) == step + 1
        if step == 0:
            assert float(tm["grad_coverage"]) > 0
            for n in gaussians.PARAM_NAMES:
                want = np.asarray(getattr(jstate.params, n))
                got = to_numpy(getattr(tstate.params, n))
                # Adam's first step without bias correction moves every
                # parameter by ~3.16 lr sign(g): where |g| is tiny its sign
                # may differ between the two rasterizers, so compare only
                # where |g| > 1e-3 max|g| and bound the rest by 7 lr.
                g = 10.0 * np.asarray(getattr(jstate.opt.m, n))  # m = 0.1 g
                big = np.abs(g) > 1e-3 * np.abs(g).max()
                np.testing.assert_allclose(got[big], want[big], rtol=1e-5, atol=1e-7,
                                           err_msg=n)
                lr = float(lrs[n])
                assert np.all(np.abs(got - want)[~big] <= 7 * lr), n
                moved = np.abs(want - before[n]) > 0
                assert moved.any(), n
    np.testing.assert_allclose(to_numpy(tstate.grad_accum), np.asarray(jstate.grad_accum),
                               rtol=1e-3, atol=1e-6)


def test_train_steps_match_jax(tmp_path):
    check_train_steps(tmp_path, "pallas_interpret")


def test_state_round_trips_through_jax_checkpoint(tmp_path):
    jstate = _jax_state()
    jstate = dataclasses.replace(jstate, step=jnp.int32(7), num_active=jnp.int32(70),
                                 overflow_acc=jnp.asarray([3.0, 1.0], jnp.float32))
    tstate = _carry(jstate, tmp_path)
    assert int(tstate.step) == 7 and int(tstate.num_active) == 70
    assert tstate.params.capacity == CAP and tstate.count.dtype == torch.int32
    np.savez(tmp_path / "back.npz", **trainer.state_to_numpy(tstate))
    back, _, _ = jax_checkpoint.load(tmp_path / "back.npz")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- the Trainer on a synthetic scene (port only) -----------------------------

def _orbit(n_views, radius=4.0, focal=50.0):
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([radius * np.sin(ang), 0.3, -radius * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, pos
        cams.append(Camera.from_c2w(W, H, focal, focal, c2w))
    return cams


@pytest.fixture(scope="module")
def synthetic():
    """tests/test_train_smoke.py's scene: 60 solid gaussians rendered from 6
    orbit views by the port's inference path."""
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(60, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(60, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=0, capacity=60,
                                              device="cpu")
    with torch.no_grad():
        params.scales.fill_(float(np.log(0.15)))
        params.opacity.fill_(2.0)
    cams = _orbit(6)
    raster = config.RasterizerConfig(**RASTER)
    images = []
    for cam in cams:
        t = cam.tensors()
        m, s, o, sc, r = gaussians.activations(params)
        out, _ = render(m, s, o, sc, r, *(torch.as_tensor(t[k]) for k in
                                          ("view", "proj", "camera_center")),
                        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, 0,
                        raster_cfg=raster, inference=True)
        images.append(to_numpy(out.color))
    return pts, cols, cams, np.stack(images).astype(np.float32)


def _cfg(**kw):
    base = dict(init_points=60, log_interval=20, snapshot_interval=10 ** 9,
                checkpoint_interval=0, output_dir="", early_stop_loss=1e-7,
                model=config.ModelConfig(sh_degree=0, initial_capacity=64),
                raster=config.RasterizerConfig(**RASTER),
                densify=config.DensifyConfig(from_iter=10 ** 9))
    base.update(kw)
    return config.TrainConfig(**base)


def test_trainer_improves_psnr(synthetic):
    pts, cols, cams, images = synthetic
    assert images.max() > 0.2 and images.std() > 0.02
    noisy = pts + np.random.default_rng(1).normal(size=pts.shape).astype(np.float32) * 0.05
    tr = trainer.Trainer(_cfg(iterations=80), TrainData(cams, images),
                         PointCloud(noisy, cols * 255.0), device="cpu")
    assert tr.state.params.capacity == 64 and int(tr.state.num_active) == 60
    log = []
    final = tr.run(on_metrics=log.append)
    assert [m["iteration"] for m in log] == [20, 40, 60, 80]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert final["loss"] < log[0]["loss"] * 0.8
    assert final["psnr"] > log[0]["psnr"] + 1.0
    assert final["grad_coverage"] == 1.0 and final["overflow_pairs_acc"] == 0


def test_trainer_overflow_auto_grow(synthetic, capsys):
    pts, cols, cams, images = synthetic
    raster = config.RasterizerConfig(**dict(RASTER, max_pairs=128), max_pairs_limit=4096)
    tr = trainer.Trainer(_cfg(iterations=8, log_interval=2, raster=raster),
                         TrainData(cams, images), PointCloud(pts, cols * 255.0),
                         device="cpu")
    log = []
    tr.run(on_metrics=log.append)
    assert tr.cfg.raster.max_pairs > 128
    assert log[0]["overflow_pairs"] > 0 and log[-1]["overflow_pairs"] == 0
    assert "WARNING: pair-budget overflow" in capsys.readouterr().err


@pytest.mark.parametrize("layout", list(config.LAYOUTS))
def test_trainer_budget_grows_and_shrinks_per_layout(synthetic, capsys, layout):
    """Auto-grow from a tight budget, then auto-shrink from an oversized one,
    in every record layout (the aligned buffers are num_tiles * chunk
    columns wider than max_pairs): every step after each change runs at the
    new budget with no overflow."""
    pts, cols, cams, images = synthetic
    raster = config.RasterizerConfig(**dict(RASTER, max_pairs=128), max_pairs_limit=4096,
                                     **config.LAYOUTS[layout])
    tr = trainer.Trainer(_cfg(iterations=16, log_interval=1, raster=raster),
                         TrainData(cams, images), PointCloud(pts, cols * 255.0),
                         device="cpu")
    log = []
    tr.run(3, on_metrics=log.append)
    grown = tr.cfg.raster.max_pairs
    assert grown > 128 and log[0]["overflow_pairs"] > 0
    assert all(m["overflow_pairs"] == 0 for m in log[1:])
    assert "WARNING: pair-budget overflow" in capsys.readouterr().err
    # Oversize the budget: after 8 logged steps under half its use, it
    # shrinks to 1.4x the observed peak (the configured 128 is the floor).
    tr.cfg = dataclasses.replace(
        tr.cfg, raster=dataclasses.replace(tr.cfg.raster, max_pairs=8 * grown))
    tr._build_train_step()
    tr.run(16, on_metrics=log.append)
    assert "shrinking max_pairs" in capsys.readouterr().err
    assert 128 < tr.cfg.raster.max_pairs < 8 * grown
    assert all(np.isfinite(m["loss"]) and m["overflow_pairs"] == 0 for m in log[1:])
    assert log[-1]["overflow_pairs_acc"] == log[0]["overflow_pairs_acc"] > 0


@pytest.mark.parametrize("change,match", [
    pytest.param(dict(parallel=config.ParallelConfig(data_parallel=2)),
                 "2 x 1 .* needs 2 ranks", id="change0-A.6"),
    pytest.param(dict(parallel=config.ParallelConfig(tile_parallel=2)),
                 "1 x 2 .* needs 2 ranks", id="change1-A.6"),
])
def test_trainer_raises_on_unported_parts(synthetic, change, match):
    """Data- and tile-parallel training (ROADMAP.md A.6) runs one rank a
    mesh position: a Trainer asked for two ranks in a single process
    raises, naming how to start them (tests/test_torch_parallel.py trains
    them)."""
    pts, cols, cams, images = synthetic
    with pytest.raises(ValueError, match=match):
        tr = trainer.Trainer(_cfg(iterations=4, **change), TrainData(cams, images),
                             PointCloud(pts, cols * 255.0), device="cpu")
        tr.run()


def test_trainer_heartbeat_and_loss_curve(synthetic, tmp_path):
    """The heartbeat file appears when the train step is built and is
    touched again before a capacity growth; the loss curve is an 800x400
    RGB PNG."""
    import os

    from gaussiansplattingmlx_tpu_torch.utils.png import read_png

    pts, cols, cams, images = synthetic
    tr = trainer.Trainer(_cfg(iterations=4, log_interval=1, output_dir=str(tmp_path)),
                         TrainData(cams, images), PointCloud(pts, cols * 255.0),
                         device="cpu")
    beat = tmp_path / "metrics.jsonl"
    assert beat.exists()
    os.utime(beat, (0, 0))
    tr.run()
    tr.state.num_active.fill_(tr.state.params.capacity)  # > 85% live: grows
    tr.maybe_grow()
    assert beat.stat().st_mtime > 0
    tr.save_loss_curve()
    curve = read_png(tmp_path / "loss_curve.png")
    assert curve.shape == (400, 800, 3) and curve.dtype == np.uint8


def test_trainer_cuda_without_gpu_is_an_error(synthetic, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, cols, cams, images = synthetic
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.Trainer(_cfg(iterations=4), TrainData(cams, images),
                        PointCloud(pts, cols * 255.0))
