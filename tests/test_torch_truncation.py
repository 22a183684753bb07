"""Frames whose pair budget is below their demand, held to the JAX package.

A truncated frame stages only the pairs of the first Gaussians (in index
order) that fit the budget; the rest are dropped and counted
(``overflow_pairs`` / ``overflow_gaussians``).  The flagship's runs on the
card truncate at their budget's limit for hundreds of steps, so each layer
that sees such a frame is held to the JAX package here: one training step
(its loss, image, the gradients of all six parameters and the densify
statistic; default fused staging, ``train_staging="sorted"``, the JAX side
through its kernels in interpret mode), the Trainer at ``max_pairs ==
max_pairs_limit`` through a densify round, and the flagship campaign at
32x32 with a stretch at its limit (the JAX script's run starts before the
first test and trains while the others run)."""

import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import CHUNK, H, TILE, W, scene_numpy, to_numpy
from test_torch_train_grads import FOCAL, _tiny_tiles_scene
from test_torch_train_loop import RASTER as LOOP_RASTER
from test_torch_train_loop import _jax_state_arrays, _jax_trainer, _port_trainer
from test_torch_train_loop import scene  # noqa: F401  (the fixture)
from test_torch_flagship_densify import FIRST_DENSIFY, assert_follows_jax, finish_runs, start_runs
from test_torch_flagship_densify import FLAGS as DENSIFY_FLAGS

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
from gaussiansplattingmlx_tpu_torch.train import trainer
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

# The render / gradient bars of tests/test_torch_train_grads.py: the JAX
# image bars for the colour, the Pallas-vs-oracle gradient tolerance with
# atol scaled by each parameter's largest gradient.
COLOR_RTOL, COLOR_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
LOSS_RTOL = 1e-5
RASTER = dict(tile_h=TILE, tile_w=TILE, chunk_size=CHUNK, train_staging="sorted")
ITERS = 100
PAD = 16


# The flagship at 32x32 (test_torch_flagship_densify.py's scene and run (b)'s
# flags) with its limit cut from 65,536 to 1,536: the budget grows from
# 1,024 to the limit at step 50 and holds ~1,400 pairs until the densify
# rounds at 500 and 600 push the demand past it.
STRETCH_LIMIT = 1536
STRETCH_FLAGS = [*DENSIFY_FLAGS[:DENSIFY_FLAGS.index("--max-pairs-limit")],
                 "--max-pairs-limit", str(STRETCH_LIMIT)]


@pytest.fixture(scope="module", autouse=True)
def stretch_runs(tmp_path_factory):
    """The JAX script's run at the cut limit, started before this file's
    first test so that it trains while the others run."""
    started = start_runs(tmp_path_factory.mktemp("flagship_stretch"), STRETCH_FLAGS)
    yield started
    started[2].kill()  # a no-op once it has finished


def _scene(case):
    """The scenes of test_render_training_gradients_match_jax: (params, c2w,
    sh_degree, white background)."""
    if case == "scene_sh1":
        params, c2w = scene_numpy(seed=7, sh_degree=1, sh_rest_scale=0.2)
        return params, c2w, 1, False
    params, c2w = _tiny_tiles_scene()
    return params, c2w, 0, True


def _padded(params):
    """The scene's raw parameters in PAD more slots, padded as
    create_from_points pads inactive slots."""
    out = {}
    for k, v in params.items():
        fill = np.zeros((PAD,) + v.shape[1:], np.float32)
        if k == "opacity":
            fill[:] = gaussians.INACTIVE_OPACITY
        if k == "rotation":
            fill[:, 0] = 1.0
        out[k] = np.concatenate([v, fill])
    return out


def _steps(case, tmp_path):
    """One training step of each package from the same state on the
    scene's frame: ``step(budget) -> (state, metrics, colour)`` for the JAX
    package (kernels in interpret mode) and the port, and the live rows."""
    params, c2w, sh_degree, white = _scene(case)
    n = len(params["xyz"])
    padded = _padded(params)
    image = np.random.default_rng(0).uniform(size=(1, H, W, 3)).astype(np.float32)
    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in padded.items()})
    jstate = jax_trainer.TrainState(
        params=gp, opt=jax_adam.init(gp), num_active=jnp.int32(n),
        grad_accum=jnp.zeros((n + PAD,), jnp.float32), grad_denom=jnp.float32(0.0),
        step=jnp.int32(0))
    jax_checkpoint.save(tmp_path / "state.npz", jstate)
    jviews = jax_trainer.stack_views(
        JaxTrainData([JaxCamera.from_c2w(W, H, FOCAL, FOCAL, c2w)], image))
    tviews = trainer.stack_views(TrainData([Camera.from_c2w(W, H, FOCAL, FOCAL, c2w)], image),
                                 "cpu")

    def jax_step(budget):
        cfg = jax_config.TrainConfig(
            iterations=ITERS, white_background=white,
            model=jax_config.ModelConfig(sh_degree=sh_degree),
            raster=jax_config.RasterizerConfig(**RASTER, max_pairs=budget))
        step = jax_trainer.make_train_step(cfg, W, H, sh_degree, ITERS,
                                           backend="pallas_interpret")
        return step(jstate, jviews, jnp.int32(0))

    def port_step(budget):
        cfg = config.TrainConfig(
            iterations=ITERS, white_background=white,
            model=config.ModelConfig(sh_degree=sh_degree),
            raster=config.RasterizerConfig(**RASTER, max_pairs=budget))
        state = trainer.state_from_numpy(np.load(tmp_path / "state.npz"), "cpu")
        return trainer.make_train_step(cfg, W, H, sh_degree, ITERS)(state, tviews, 0)

    return jax_step, port_step, n


def _assert_grads_match(got, want):
    for name, x, y in zip(gaussians.PARAM_NAMES, got, want):
        assert x.shape == y.shape, name
        if y.size == 0:
            continue
        assert np.isfinite(x).all(), name
        scale = max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x, y, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale, err_msg=name)
        # A Gaussian whose pairs were all dropped (or that has none) gets
        # exactly zero on both sides.
        np.testing.assert_array_equal(x == 0.0, y == 0.0, err_msg=name)


@pytest.mark.parametrize("case", ["scene_sh1", "tiny_tiles_white"])
def test_truncated_training_step_matches_jax(case, tmp_path):
    """One training step on a frame at half its demand, from the same
    state: the same pairs dropped, the same loss, image and gradients of
    all six parameters (Adam's first moment after one step is 0.1 g on
    both sides), and the same densify statistic (``grad_accum``'s
    increment, the norm of each row's position gradient).  A Gaussian
    whose pairs were all dropped gets exactly zero on both sides."""
    jax_step, port_step, n = _steps(case, tmp_path)
    _, full, _ = port_step(4096)
    demand = int(full["num_pairs"])
    assert int(full["overflow_pairs"]) == 0
    budget = demand // 2
    jstate, jm, jcolor = jax_step(budget)
    tstate, tm, tcolor = port_step(budget)
    for key in ("num_pairs", "overflow_pairs", "overflow_gaussians", "overflow_pairs_acc",
                "overflow_gaussians_acc", "grad_coverage"):
        assert float(tm[key]) == float(jm[key]), key
    # JAX's demand is the port's: it kept the budget and dropped the rest.
    assert int(jm["num_pairs"]) == budget and int(jm["overflow_pairs"]) == demand - budget
    assert int(jm["overflow_gaussians"]) > 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(to_numpy(tcolor), np.asarray(jcolor), rtol=COLOR_RTOL,
                               atol=COLOR_ATOL)
    got = [10.0 * to_numpy(tstate.m[k]) for k in gaussians.PARAM_NAMES]
    want = [10.0 * np.asarray(getattr(jstate.opt.m, k)) for k in gaussians.PARAM_NAMES]
    _assert_grads_match(got, want)
    accum = to_numpy(tstate.grad_accum)
    _assert_grads_match([accum], [np.asarray(jstate.grad_accum)])
    assert float(tstate.grad_denom) == float(jstate.grad_denom) == 1.0
    # The truncation took whole Gaussians' gradients: some live rows that
    # the full frame reaches get none at its half; padding gets none.
    full_state, _, _ = port_step(4096)
    lost = (accum[:n] == 0) & (to_numpy(full_state.grad_accum)[:n] != 0)
    assert lost.any() and not accum[n:].any()


# --- the Trainer at its pair-budget limit ---------------------------------------

# test_torch_train_loop.py's scene (60 Gaussians, 6 orbit views at 48x48,
# ~510 pairs a view) at a budget and limit of 256: every step truncates.
# One densify round at step 3; its thresholds sit at least 1% from every
# live row's mean gradient, largest scale and opacity in both runs
# (asserted), and the round splits, clones and prunes.  About half the rows
# lose all their pairs and keep a zero gradient.
LIMIT = 256
LIMIT_ITERS = 5
LIMIT_DENSIFY = dict(interval=3, from_iter=3, until_iter=3, grad_threshold=2.0e-3,
                     max_scale=0.45, min_opacity=0.09)
LIMIT_MODEL = dict(sh_degree=0, initial_capacity=128)
ROUND_STATS = ("num_active", "n_keep", "n_split", "n_clone", "n_prune")


def _margin(state_arrays):
    """The round's smallest relative distance from a threshold: each live
    row's mean gradient, largest scale and opacity."""
    n = int(state_arrays["num_active"])
    avg = state_arrays["grad_accum"][:n] / float(state_arrays["grad_denom"])
    max_scale = np.exp(state_arrays["scales"][:n]).max(axis=1)
    op = 1.0 / (1.0 + np.exp(-state_arrays["opacity"][:n, 0]))
    d = LIMIT_DENSIFY
    return min(float(np.min(np.abs(v / t - 1.0))) for v, t in
               ((avg, d["grad_threshold"]), (max_scale, d["max_scale"]),
                (op, d["min_opacity"])))


def test_trainer_at_its_limit_matches_jax(scene, capsys):
    """``max_pairs == max_pairs_limit`` below the scene's demand: both
    Trainers warn that the limit is reached and never grow the budget, and
    they agree on the run's overflow totals, the densify statistics the
    round reads (``grad_accum``, ``grad_denom``), the round's Gaussians and
    each step's loss."""
    raster = dict(LOOP_RASTER, max_pairs=LIMIT)
    jt = _jax_trainer(scene, iterations=LIMIT_ITERS,
                      model=jax_config.ModelConfig(**LIMIT_MODEL),
                      raster=jax_config.RasterizerConfig(**raster, max_pairs_limit=LIMIT),
                      densify=jax_config.DensifyConfig(**LIMIT_DENSIFY))
    tt = _port_trainer(scene, iterations=LIMIT_ITERS,
                       model=config.ModelConfig(**LIMIT_MODEL),
                       raster=config.RasterizerConfig(**raster, max_pairs_limit=LIMIT),
                       densify=config.DensifyConfig(**LIMIT_DENSIFY))
    tt.state = trainer.state_from_numpy(_jax_state_arrays(jt.state), "cpu")
    rounds = {}

    def record(side, fn, host):
        def step(state, noise):
            before = {"num_active": host(state.num_active), "grad_accum": host(state.grad_accum),
                      "grad_denom": host(state.grad_denom),
                      "overflow_acc": host(state.overflow_acc),
                      "scales": host(state.params.scales), "opacity": host(state.params.opacity)}
            state, stats = fn(state, noise)
            rounds[side] = (before, [int(getattr(stats, k)) for k in ROUND_STATS])
            return state, stats
        return step

    jt.densify_step = record("jax", jt.densify_step, np.asarray)
    tt.densify_step = record("port", tt.densify_step, lambda x: to_numpy(x).copy())
    jlog, tlog = [], []
    jt.run(on_metrics=jlog.append)
    jax_err = capsys.readouterr().err
    tt.run(on_metrics=tlog.append)
    port_err = capsys.readouterr().err

    for err in (jax_err, port_err):
        assert err.count("but max_pairs_limit reached (max_pairs=256)") == LIMIT_ITERS
        assert "growing max_pairs" not in err
    assert tt.cfg.raster.max_pairs == jt.cfg.raster.max_pairs == LIMIT
    for key in ("num_pairs", "overflow_pairs", "overflow_gaussians", "overflow_pairs_acc",
                "overflow_gaussians_acc", "num_active"):
        assert [m[key] for m in tlog] == [m[key] for m in jlog], key
    assert all(m["num_pairs"] == LIMIT and m["overflow_pairs"] > 0 for m in tlog)
    np.testing.assert_allclose([m["loss"] for m in tlog], [m["loss"] for m in jlog],
                               rtol=1e-4)
    np.testing.assert_array_equal(to_numpy(tt.state.overflow_acc),
                                  np.asarray(jt.state.overflow_acc))

    (jb, jstats), (tb, tstats) = rounds["jax"], rounds["port"]
    assert _margin(jb) >= 0.01 and _margin(tb) >= 0.01, (_margin(jb), _margin(tb))
    assert tstats == jstats
    assert jstats[2] > 0 and jstats[3] > 0 and jstats[4] > 0  # split, clone, prune
    assert float(tb["grad_denom"]) == float(jb["grad_denom"]) == 3.0
    np.testing.assert_array_equal(tb["overflow_acc"], jb["overflow_acc"])
    _assert_grads_match([tb["grad_accum"]], [jb["grad_accum"]])
    n = int(jb["num_active"])
    assert (jb["grad_accum"][:n] == 0).sum() > n // 4  # rows that lost every pair


# --- the flagship campaign with a stretch at its limit ----------------------------

def test_flagship_stretch_at_the_limit_matches_jax(stretch_runs):
    """Past densify, capacity growth and an opacity reset at the cut limit:
    the port follows the JAX script at test_torch_flagship_densify.py's
    bars, the same rows truncate on both sides, and both drop pairs at the
    limit after the first densify round."""
    port_out, jax_out, _ = finish_runs(*stretch_runs)
    rows, jax_rows = assert_follows_jax(port_out, jax_out)
    truncated = [r["iteration"] for r in rows if r["overflow_pairs"] > 0]
    assert truncated == [r["iteration"] for r in jax_rows if r["overflow_pairs"] > 0]
    print("truncating rows", truncated)
    for side in (rows, jax_rows):
        assert side[0]["max_pairs"] == side[-1]["max_pairs"] == STRETCH_LIMIT
        at_round = next(r for r in side if r["iteration"] == FIRST_DENSIFY)
        assert side[-1]["overflow_pairs_acc"] > at_round["overflow_pairs_acc"]
    assert any(i > FIRST_DENSIFY for i in truncated)
