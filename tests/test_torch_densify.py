"""Densify and prune: the port's ``train/densify.py`` and the trainer's
densify, prune-only and opacity-reset steps and capacity growth against the
JAX package's, on the same numpy inputs and the same normal draw (JAX draws
it inside ``split_and_prune`` from a key; the port takes it as an
argument).  Stats, gather map and noise modes must be bit-exact, and so must
every parameter and moment, except the ``xyz`` and ``scales`` of rows a
round created (split children and clone copies), which go through ``exp``
and a float32 ``log`` whose last bits differ between XLA and torch: those
are held to rtol 1e-6 / atol 1e-7."""

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
from gaussiansplattingmlx_tpu.train import densify as jax_densify
from gaussiansplattingmlx_tpu.train import optimizer as jax_adam
from gaussiansplattingmlx_tpu.train import trainer as jax_trainer
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.models.gaussians import INACTIVE_OPACITY, PARAM_NAMES
from gaussiansplattingmlx_tpu_torch.train import densify, trainer

FRESH_RTOL, FRESH_ATOL = 1e-6, 1e-7
STATS = ("num_active", "n_keep", "n_split", "n_clone", "n_prune", "densify_enabled")


def jax_noise(key, cap):
    """The draw JAX's split_and_prune makes from ``key``."""
    return np.array(jax.random.normal(key, (cap, 3), dtype=jnp.float32))


def base_params(cap, scales_log=-3.0, opacity_logit=0.0):
    """tests/test_densify.py's make_params, as numpy."""
    return {
        "xyz": np.arange(cap * 3, dtype=np.float32).reshape(cap, 3) * np.float32(0.01),
        "features_dc": np.full((cap, 1, 3), 0.5, np.float32),
        "features_rest": np.zeros((cap, 3, 3), np.float32),
        "scales": np.full((cap, 3), scales_log, np.float32),
        "rotation": np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32), (cap, 1)),
        "opacity": np.full((cap, 1), opacity_logit, np.float32),
    }


def _with(params, **rows):
    """A copy of ``params`` with the given {name: (index, value)} writes."""
    out = {k: v.copy() for k, v in params.items()}
    for name, writes in rows.items():
        for idx, value in writes:
            out[name][idx] = value
    return out


def _mixed_case():
    """A random scene at capacity 256 where every rule fires: low opacity,
    split, clone, keep, non-finite rows, world-scale, near-camera and needle
    prunes; every classified quantity at least 1% from its threshold."""
    rng = np.random.default_rng(11)
    cap, n = 256, 180
    p = {
        "xyz": rng.normal(size=(cap, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(cap, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(cap, 8, 3)) * 0.1).astype(np.float32),
        "scales": np.log(rng.choice([0.002, 0.004, 0.03, 0.05], size=(cap, 3))
                         * rng.uniform(0.9, 1.1, size=(cap, 3))).astype(np.float32),
        "rotation": rng.normal(size=(cap, 4)).astype(np.float32),
        "opacity": rng.choice([-7.0, -1.0, 0.5, 2.0], size=(cap, 1)).astype(np.float32),
    }
    p["scales"][5] = np.log([3.0, 0.01, 0.01])  # needle, and over the world scale
    p["scales"][6] = np.log([0.2, 0.01, 0.01])  # needle only
    p["xyz"][7] = [0.1, 0.0, -4.0]  # next to the camera
    p["xyz"][9, 1] = np.nan
    p["features_rest"][10, 2, 0] = np.inf
    accum = (rng.choice([1e-5, 2e-3], size=cap) * rng.uniform(0.9, 1.1, size=cap)
             * 3.0).astype(np.float32)
    kw = dict(prune_world_scale=1.0, prune_needle_ratio=10.0, prune_near_cameras=0.5,
              camera_centers=np.asarray([[0.0, 0.0, -4.0], [4.0, 0.0, 0.0]], np.float32))
    return p, n, accum, 3.0, kw


def _cases():
    zeros = lambda cap: np.zeros(cap, np.float32)  # noqa: E731
    one_at = lambda cap, i: np.where(np.arange(cap) == i, 1.0, 0.0).astype(np.float32)  # noqa: E731
    p8 = base_params(8)
    needle_scales = np.full((8, 3), -3.0, np.float32)
    needle_scales[1] = [-3.0 + np.log(50.0), -3.0, -3.0]
    needle_scales[2] = [0.0, 0.0, -6.0]
    return {
        "keep_only": (p8, 4, zeros(8), 1.0, {}),
        "prune_low_opacity": (_with(p8, opacity=[((1, 0), -8.0)]), 4, zeros(8), 1.0, {}),
        "clone": (base_params(16, scales_log=-6.0), 3, one_at(16, 2), 1.0, {}),
        "split": (base_params(16, scales_log=0.0), 3, one_at(16, 0), 1.0, {}),
        "average_below": (base_params(8, scales_log=-6.0), 2, 3e-4 * one_at(8, 0), 2.0, {}),
        "average_above": (base_params(8, scales_log=-6.0), 2, 5e-4 * one_at(8, 0), 2.0, {}),
        "capacity_guard": (base_params(4, scales_log=-6.0), 4, np.ones(4, np.float32), 1.0, {}),
        "max_gaussians": (base_params(16, scales_log=-6.0), 8, np.ones(16, np.float32), 1.0,
                          dict(max_gaussians=8)),
        "world_scale": (_with(base_params(8, opacity_logit=5.0), scales=[((2, 0), 1.0)]), 4,
                        zeros(8), 1.0, dict(prune_world_scale=2.0)),
        "world_scale_beats_split": (base_params(8, scales_log=1.0, opacity_logit=5.0), 2,
                                    np.ones(8, np.float32), 1.0, dict(prune_world_scale=2.0)),
        "non_finite": (_with(base_params(8, opacity_logit=5.0), xyz=[(1, np.nan)],
                             opacity=[((2, 0), np.nan)]), 4, zeros(8), 1.0, {}),
        "near_cameras": (p8, 4, zeros(8), 1.0,
                         dict(prune_near_cameras=0.02, camera_centers=p8["xyz"][2:3].copy())),
        "needle": (dict(p8, scales=needle_scales), 4, zeros(8), 1.0,
                   dict(prune_needle_ratio=10.0)),
        "prune_only": (p8, 4, np.where(np.arange(8) < 4, 1.0, 0.0).astype(np.float32), 1.0,
                       dict(allow_densify=False, grad_threshold=1e-9)),
        "mixed": _mixed_case(),
    }


CASES = _cases()


def assert_params_match(got: dict, want: dict, noise_mode: np.ndarray):
    """Bit-exact, except the xyz and scales of the rows a round created."""
    fresh = noise_mode != 0
    for n in PARAM_NAMES:
        g, w = np.asarray(got[n]), np.asarray(want[n])
        assert g.dtype == w.dtype and g.shape == w.shape, n
        if n in ("xyz", "scales"):
            np.testing.assert_array_equal(g[~fresh], w[~fresh], err_msg=n)
            np.testing.assert_allclose(g[fresh], w[fresh], rtol=FRESH_RTOL, atol=FRESH_ATOL,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_split_and_prune_matches_jax(case):
    params, n, accum, denom, kw = CASES[case]
    cap = params["xyz"].shape[0]
    key = jax.random.PRNGKey(7)
    jkw = {k: (jnp.asarray(v) if k == "camera_centers" else v) for k, v in kw.items()}
    wp, wstats, widx, wmode = jax_densify.split_and_prune(
        jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        jnp.int32(n), jnp.asarray(accum), jnp.float32(denom), key, **jkw)
    tkw = {k: (torch.as_tensor(v) if k == "camera_centers" else v) for k, v in kw.items()}
    gp, gstats, gidx, gmode = densify.split_and_prune(
        gaussians.params_from_numpy(params, "cpu"), torch.tensor(n, dtype=torch.int32),
        torch.as_tensor(accum), torch.tensor(denom, dtype=torch.float32),
        torch.as_tensor(jax_noise(key, cap)), **tkw)
    for name in STATS:
        got, want = to_numpy(getattr(gstats, name)), np.asarray(getattr(wstats, name))
        assert got.dtype == want.dtype and got == want, name
    np.testing.assert_array_equal(to_numpy(gidx), np.asarray(widx))
    np.testing.assert_array_equal(to_numpy(gmode), np.asarray(wmode))
    assert to_numpy(gidx).dtype == np.int32 and to_numpy(gmode).dtype == np.int32
    wmode = np.asarray(wmode)
    assert_params_match({k: to_numpy(v) for k, v in gp.items()},
                        {k: np.asarray(getattr(wp, k)) for k in PARAM_NAMES}, wmode)
    if case == "mixed":  # the scene exercises every rule
        assert int(wstats.n_split) > 0 and int(wstats.n_clone) > 0
        assert int(wstats.n_prune) > 0 and int(wstats.n_keep) > 0
        assert bool(wstats.densify_enabled)


def test_reset_opacity_matches_jax():
    rng = np.random.default_rng(4)
    cap, n = 64, 40
    p = base_params(cap)
    p["opacity"] = rng.normal(0.0, 4.0, size=(cap, 1)).astype(np.float32)
    p["opacity"][50:] = INACTIVE_OPACITY
    p["opacity"][3, 0] = np.nan
    want = jax_densify.reset_opacity(
        jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        jnp.int32(n), reset_value=0.01)
    got = densify.reset_opacity(torch.as_tensor(p["opacity"]), torch.tensor(n), 0.01)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want.opacity))
    assert (to_numpy(got)[:n] <= np.log(0.01 / 0.99) + 1e-6).sum() == n - 1  # NaN stays


def test_remap_optimizer_moments_matches_jax():
    rng = np.random.default_rng(5)
    cap = 32
    moments = {"a": rng.normal(size=(cap, 3)).astype(np.float32),
               "b": rng.normal(size=(cap, 4, 3)).astype(np.float32),
               "c": rng.normal(size=(cap, 1)).astype(np.float32)}
    gather_idx = rng.integers(0, 20, size=cap).astype(np.int32)
    noise_mode = rng.integers(0, 4, size=cap).astype(np.int32)
    want = jax_densify.remap_optimizer_moments(
        {k: jnp.asarray(v) for k, v in moments.items()}, jnp.asarray(gather_idx),
        jnp.asarray(noise_mode))
    got = densify.remap_optimizer_moments(
        {k: torch.as_tensor(v) for k, v in moments.items()}, torch.as_tensor(gather_idx),
        torch.as_tensor(noise_mode))
    for k in moments:
        np.testing.assert_array_equal(to_numpy(got[k]), np.asarray(want[k]), err_msg=k)


# --- the trainer's maintenance steps on a state after 3 JAX steps -------------

W = H = 48
N, CAP, SH = 80, 256, 1
ITERS = 100
RASTER = dict(tile_h=TILE, tile_w=TILE, max_pairs=4096, chunk_size=CHUNK)


def _gap_threshold(values, q):
    """A threshold near quantile ``q`` of ``values`` in a gap between two
    of them, at least 1% from both."""
    v = np.sort(np.asarray(values, np.float64))
    order = np.argsort(np.abs(np.arange(len(v) - 1) - q * len(v)))
    for i in order:
        if v[i + 1] > v[i] * 1.03:
            return float(np.sqrt(v[i] * v[i + 1]))
    raise AssertionError("no gap of 3% in the values")


def assert_margin(values, threshold, what):
    rel = np.abs(np.asarray(values, np.float64) / threshold - 1.0)
    assert rel.min() >= 0.01, f"{what}: a value within {rel.min():.2%} of {threshold}"


@pytest.fixture(scope="module")
def stepped_jax_state():
    """A JAX TrainState after 3 train steps (backend pallas_interpret) of the
    staging scene padded to CAP slots, and densify thresholds chosen from it
    so every live row sits at least 1% from each."""
    params, c2w = scene_numpy(n=N, seed=3, sh_degree=SH, sh_rest_scale=0.1)
    padded = {}
    for k, v in params.items():
        fill = np.zeros((CAP - N,) + v.shape[1:], np.float32)
        if k == "opacity":
            fill[:] = INACTIVE_OPACITY
        if k == "rotation":
            fill[:, 0] = 1.0
        padded[k] = np.concatenate([v, fill])
    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in padded.items()})
    state = jax_trainer.TrainState(
        params=gp, opt=jax_adam.init(gp), num_active=jnp.int32(N),
        grad_accum=jnp.zeros((CAP,), jnp.float32), grad_denom=jnp.float32(0.0),
        step=jnp.int32(0))
    cams = []
    for i in range(2):
        c = c2w.copy()
        c[0, 3] = 0.3 * i
        cams.append(JaxCamera.from_c2w(W, H, 60.0, 60.0, c))
    images = np.random.default_rng(5).uniform(size=(2, H, W, 3)).astype(np.float32)
    jcfg = jax_config.TrainConfig(
        iterations=ITERS, model=jax_config.ModelConfig(sh_degree=SH),
        raster=jax_config.RasterizerConfig(**RASTER, backend="pallas_interpret"))
    step = jax_trainer.make_train_step(jcfg, W, H, SH, ITERS, backend="pallas_interpret")
    views = jax_trainer.stack_views(JaxTrainData(cams, images))
    for view in (0, 1, 0):
        state, _, _ = step(state, views, jnp.int32(view))
    live = slice(0, N)
    avg = np.asarray(state.grad_accum)[live] / float(state.grad_denom)
    max_s = np.exp(np.asarray(state.params.scales)[live]).max(axis=1)
    op = 1.0 / (1.0 + np.exp(-np.asarray(state.params.opacity)[live, 0]))
    thresholds = dict(grad_threshold=_gap_threshold(avg, 0.6),
                      max_scale=_gap_threshold(max_s, 0.5),
                      min_opacity=_gap_threshold(op, 0.1))
    for (name, t), vals in zip(thresholds.items(), (avg, max_s, op)):
        assert_margin(vals, t, name)
    return state, thresholds


def _np_state(jstate, tmp_path, name):
    jax_checkpoint.save(tmp_path / name, jstate)
    with np.load(tmp_path / name) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("variant", ["reset_adam", "remap_moments", "prune_only"])
def test_densify_steps_match_jax(stepped_jax_state, tmp_path, variant):
    jstate, thresholds = stepped_jax_state
    before = _np_state(jstate, tmp_path, "before.npz")
    dkw = dict(thresholds, reset_optimizer_state=variant == "reset_adam")
    jcfg = jax_config.TrainConfig(densify=jax_config.DensifyConfig(**dkw))
    tcfg = config.TrainConfig(densify=config.DensifyConfig(**dkw))
    allow = variant != "prune_only"
    key = jax.random.PRNGKey(3)
    # The JAX step donates its input: run it on a copy.
    jcopy = jax.tree.map(jnp.copy, jstate)
    jout, jstats = jax_trainer.make_densify_step(jcfg, allow_densify=allow)(jcopy, key)
    tstate = trainer.state_from_numpy(before, "cpu")
    params_before = {n: getattr(tstate.params, n) for n in PARAM_NAMES}
    tout, tstats = trainer.make_densify_step(tcfg, allow_densify=allow)(
        tstate, torch.as_tensor(jax_noise(key, CAP)))
    # In place: the same parameter tensors, new contents.
    assert all(getattr(tout.params, n) is params_before[n] for n in PARAM_NAMES)
    for name in STATS:
        assert to_numpy(getattr(tstats, name)) == np.asarray(getattr(jstats, name)), name
    assert int(jstats.n_prune) > 0
    if allow:
        assert int(jstats.n_split) > 0 and int(jstats.n_clone) > 0
    else:
        assert int(jstats.n_split) == int(jstats.n_clone) == 0
    want = _np_state(jout, tmp_path, "after.npz")
    got = trainer.state_to_numpy(tout)
    assert set(got) <= set(want)
    _, _, _, mode = jax_densify.split_and_prune(
        jstate.params, jstate.num_active, jstate.grad_accum, jstate.grad_denom, key,
        allow_densify=allow, **thresholds)
    fresh = np.asarray(mode) != 0
    assert fresh.any() == allow
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        if k in ("param_xyz", "param_scales"):
            np.testing.assert_array_equal(got[k][~fresh], want[k][~fresh], err_msg=k)
            np.testing.assert_allclose(got[k][fresh], want[k][fresh], rtol=FRESH_RTOL,
                                       atol=FRESH_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if variant == "reset_adam":
        assert int(tout.count) == 0 and not any(got[f"adam_m_{n}"].any() for n in PARAM_NAMES)
    else:
        assert int(tout.count) == 3 and got["adam_v_xyz"].any()
    assert not got["grad_accum"].any() and float(got["grad_denom"]) == 0.0


def test_opacity_reset_step_matches_jax(stepped_jax_state, tmp_path):
    jstate, _ = stepped_jax_state
    before = _np_state(jstate, tmp_path, "before.npz")
    dkw = dict(opacity_reset_value=0.3)  # below some live opacities, above others
    jcfg = jax_config.TrainConfig(densify=jax_config.DensifyConfig(**dkw))
    jout = jax_trainer.make_opacity_reset_step(jcfg)(jax.tree.map(jnp.copy, jstate))
    tout = trainer.make_opacity_reset_step(config.TrainConfig(
        densify=config.DensifyConfig(**dkw)))(trainer.state_from_numpy(before, "cpu"))
    want, got = _np_state(jout, tmp_path, "after.npz"), trainer.state_to_numpy(tout)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["param_opacity"] != before["param_opacity"]).any()
    assert not got["adam_m_opacity"].any() and got["adam_m_xyz"].any()


def test_grow_capacity_matches_jax(stepped_jax_state, tmp_path):
    jstate, _ = stepped_jax_state
    before = _np_state(jstate, tmp_path, "before.npz")
    want = _np_state(jax_trainer.grow_capacity(jstate, 2 * CAP), tmp_path, "grown.npz")
    tstate = trainer.state_from_numpy(before, "cpu")
    grown = trainer.grow_capacity(tstate, 2 * CAP)
    got = trainer.state_to_numpy(grown)
    assert grown.params.capacity == 2 * CAP
    assert isinstance(grown.params.xyz, torch.nn.Parameter)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert trainer.grow_capacity(tstate, CAP) is tstate
