"""The training slice's smaller pieces against the JAX package, on the same
numpy inputs: projection gradients and the active mask, SSIM and the losses
(values and gradients), Adam, the learning-rate table, SH warmup,
create_from_points, the config dataclasses' JSON, the dataset and the
point-cloud sampler.  Tolerances are rtol 1e-5 or tighter unless stated."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import to_numpy, to_torch
from test_torch_projection import _cameras, _default_gaussians

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu.data.dataset import TrainData as JaxTrainData
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.ops import losses as jax_losses
from gaussiansplattingmlx_tpu.ops import projection as jax_projection
from gaussiansplattingmlx_tpu.ops import ssim as jax_ssim
from gaussiansplattingmlx_tpu.train import optimizer as jax_adam
from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud as JaxPointCloud
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import losses, projection, ssim
from gaussiansplattingmlx_tpu_torch.train import optimizer
from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud


def _images(seed, h=40, w=36):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_projection_gradients_and_active_mask_match_jax(seed):
    """VJP of every projection output with respect to means, scales, quats
    and SH, with a third of the rows inactive and some behind the camera."""
    rng = np.random.default_rng(seed)
    means, scales, quats, shs = _default_gaussians(48, rng, degree=3)
    means[:5, 2] = -1.0  # behind the camera
    active = (np.arange(48) % 3 != 0).astype(np.float32)
    jc, tc = _cameras(64, 48, 60.0, 0.0)
    t = jc.tensors()
    outs = ("means2d", "depths", "colors", "cov2d", "conic")
    cots = {k: rng.normal(size=s).astype(np.float32) for k, s in
            (("means2d", (48, 2)), ("depths", (48,)), ("colors", (48, 3)),
             ("cov2d", (48, 4)), ("conic", (48, 4)))}

    def jf(*xs):
        p = jax_projection.project_gaussians(
            *xs, *(jnp.asarray(t[k]) for k in ("view", "proj", "camera_center")),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], 64, 48, 3,
            active=jnp.asarray(active))
        return sum(jnp.sum(getattr(p, k) * cots[k]) for k in outs), p

    (_, want_p), want_g = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (means, scales, quats, shs)))
    xs = [to_torch(a).requires_grad_() for a in (means, scales, quats, shs)]
    u = tc.tensors()
    got_p = projection.project_gaussians(
        *xs, *(to_torch(u[k]) for k in ("view", "proj", "camera_center")),
        u["fov_x"], u["fov_y"], u["focal_x"], u["focal_y"], 64, 48, 3,
        active=to_torch(active))
    sum(torch.sum(getattr(got_p, k) * to_torch(cots[k])) for k in outs).backward()
    np.testing.assert_array_equal(to_numpy(got_p.radii), np.asarray(want_p.radii))
    assert (to_numpy(got_p.radii)[active == 0] == 0).all()
    assert not got_p.radii.requires_grad and not got_p.rect_min.requires_grad
    for x, g in zip(xs, want_g):
        g = np.asarray(g)
        assert np.isfinite(to_numpy(x.grad)).all()
        np.testing.assert_allclose(to_numpy(x.grad), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_and_losses_match_jax(seed):
    a, b = _images(seed)
    depth = np.random.default_rng(seed + 7).uniform(1, 3, size=a.shape[:2]).astype(np.float32)
    tdepth = depth + 0.1
    mask = (np.random.default_rng(seed).uniform(size=a.shape[:2]) > 0.5).astype(np.float32)
    for window, sigma in ((11, 1.5), (7, 1.0)):
        np.testing.assert_allclose(
            to_numpy(ssim.ssim_map(to_torch(a), to_torch(b), window, sigma)),
            np.asarray(jax_ssim.ssim_map(jnp.asarray(a), jnp.asarray(b), window, sigma)),
            rtol=1e-5, atol=1e-6)
    want_loss, want_parts = jax_losses.total_loss(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(depth), jnp.asarray(tdepth),
        jnp.asarray(mask), lambda_dssim=0.2, lambda_depth=0.3)
    got_loss, got_parts = losses.total_loss(
        to_torch(a), to_torch(b), to_torch(depth), to_torch(tdepth), to_torch(mask),
        lambda_dssim=0.2, lambda_depth=0.3)
    # The means sum in another order than XLA's: rtol 1e-5.
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for k in ("l1", "ssim", "depth"):
        np.testing.assert_allclose(float(got_parts[k]), float(want_parts[k]), rtol=1e-5)
    np.testing.assert_allclose(float(losses.psnr(to_torch(a), to_torch(b))),
                               float(jax_losses.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    no_mask = np.zeros_like(mask)
    assert float(losses.depth_loss(to_torch(depth), to_torch(tdepth), to_torch(no_mask))) == 0.0


def test_loss_gradient_matches_jax():
    """d loss / d render of L1 + SSIM: the cotangent the rasterizer backward
    receives in every training step."""
    a, b = _images(3, 32, 32)
    z = np.zeros(a.shape[:2], np.float32)

    def jf(x):
        return jax_losses.total_loss(x, jnp.asarray(b), jnp.asarray(z), jnp.asarray(z),
                                     jnp.asarray(z))[0]

    want = np.asarray(jax.grad(jf)(jnp.asarray(a)))
    x = to_torch(a).requires_grad_()
    losses.total_loss(x, to_torch(b), to_torch(z), to_torch(z), to_torch(z))[0].backward()
    np.testing.assert_allclose(to_numpy(x.grad), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_ssim_is_full_f32_and_bounded():
    """Identical images give SSIM 1 to float32 rounding; the blur is exact
    float32 (no convolution library, so TF32 cannot touch it)."""
    a, _ = _images(4)
    val = float(ssim.ssim(to_torch(a), to_torch(a)))
    assert abs(val - 1.0) < 1e-6
    taps = ssim.gaussian_window(11, 1.5)
    np.testing.assert_array_equal(np.asarray(taps, np.float32),
                                  jax_ssim.gaussian_window(11, 1.5))


@pytest.mark.parametrize("bias_correction", [False, True])
def test_adam_matches_jax(bias_correction):
    rng = np.random.default_rng(2)
    shapes = {"xyz": (7, 3), "opacity": (7, 1)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lrs = {"xyz": np.float32(1.6e-4), "opacity": np.float32(2.5e-2)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_adam.init(jp)
    tp = {k: to_torch(v) for k, v in params.items()}
    tstate = optimizer.init(tp)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10 ** (-step) for k, s in
                 shapes.items()}
        grads["xyz"][0] = 0.0  # a zero gradient: eps keeps the step finite
        jp, jstate = jax_adam.update(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                                     jstate, {k: jnp.asarray(v) for k, v in lrs.items()},
                                     bias_correction=bias_correction)
        optimizer.update(tp, {k: to_torch(v) for k, v in grads.items()}, tstate,
                         {k: torch.tensor(v) for k, v in lrs.items()},
                         bias_correction=bias_correction)
        for k in shapes:
            np.testing.assert_allclose(to_numpy(tp[k]), np.asarray(jp[k]), rtol=1e-6)
            np.testing.assert_allclose(to_numpy(tstate.m[k]), np.asarray(jstate.m[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(to_numpy(tstate.v[k]), np.asarray(jstate.v[k]),
                                       rtol=1e-6)
    assert int(tstate.count) == int(jstate.count) == 3


@pytest.mark.parametrize("step", [0, 37, 99, 150])
def test_learning_rates_and_sh_warmup_match_jax(step):
    want = jax_gaussians.learning_rates(jnp.int32(step), 100, lr_xyz=2e-4)
    got = gaussians.learning_rates(torch.tensor(step, dtype=torch.int32), 100, lr_xyz=2e-4)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-7, err_msg=k)
    rest = np.random.default_rng(step).normal(size=(5, 15, 3)).astype(np.float32)
    jp = jax_gaussians.GaussianParams(
        xyz=jnp.zeros((5, 3)), features_dc=jnp.zeros((5, 1, 3)),
        features_rest=jnp.asarray(rest), scales=jnp.zeros((5, 3)),
        rotation=jnp.zeros((5, 4)), opacity=jnp.zeros((5, 1)))
    for warmup in (0, 40):
        want_rest = jax_gaussians.apply_sh_warmup(jp, jnp.int32(step), warmup, 3).features_rest
        got_rest = gaussians.apply_sh_warmup({"features_rest": to_torch(rest)},
                                             torch.tensor(step), warmup, 3)["features_rest"]
        np.testing.assert_array_equal(to_numpy(got_rest), np.asarray(want_rest))


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    pts[7] = pts[3]  # a duplicate point: distance 0 hits the dist2 floor
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    want, n_want = jax_gaussians.create_from_points(pts, cols, sh_degree=2, capacity=512)
    got, n_got = gaussians.create_from_points(pts, cols, sh_degree=2, capacity=512,
                                              device="cpu")
    assert n_got == n_want == 300 and got.capacity == 512
    for name in gaussians.PARAM_NAMES:
        np.testing.assert_allclose(to_numpy(getattr(got, name)),
                                   np.asarray(getattr(want, name)), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_array_equal(to_numpy(got.rotation)[300:], [[1, 0, 0, 0]] * 212)
    np.testing.assert_allclose(gaussians.knn_mean_sq_dist(pts[:40], k=3, device="cpu"),
                               jax_gaussians.knn_mean_sq_dist(pts[:40], k=3), rtol=1e-5)
    mask = gaussians.active_mask(512, torch.tensor(300, dtype=torch.int32))
    np.testing.assert_array_equal(
        to_numpy(mask), np.asarray(jax_gaussians.active_mask(want, jnp.int32(300))))
    # activations with the mask zero the inactive slots' opacity.
    _, _, opacity, _, _ = gaussians.activations(got, mask)
    assert float(opacity[300:].abs().max()) == 0.0 and float(opacity[:300].min()) > 0


def test_train_config_json_round_trips_across_packages():
    cfg = config.TrainConfig(iterations=123, model=config.ModelConfig(sh_degree=2),
                             raster=config.RasterizerConfig(max_pairs=8192))
    back = jax_config.TrainConfig.from_json(cfg.to_json())
    assert back.iterations == 123 and back.model.sh_degree == 2
    assert back.raster.max_pairs == 8192
    again = config.TrainConfig.from_json(back.to_json())
    assert again == cfg
    assert dataclasses.asdict(again) == dataclasses.asdict(back)


def test_dataset_and_point_cloud_match_jax():
    rng = np.random.default_rng(6)
    _, tc = _cameras(20, 16, 30.0, -3.0)
    jc, _ = _cameras(20, 16, 30.0, -3.0)
    images = rng.uniform(size=(2, 16, 20, 3)).astype(np.float32)
    depths = rng.uniform(1, 2, size=(2, 16, 20)).astype(np.float32)
    alphas = (rng.uniform(size=(2, 16, 20)) > 0.3).astype(np.float32)
    for kw in ({}, {"depths": depths}, {"depths": depths, "alphas": alphas}):
        got = TrainData([tc, tc], images, **kw).view_tensors(1)
        want = JaxTrainData([jc, jc], images, **kw).view_tensors(1)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError):
        TrainData([tc], images)
    coords = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.uniform(0, 255, size=(50, 3)).astype(np.float32)
    got = PointCloud(coords, colors).random_sample(20, seed=4)
    want = JaxPointCloud(coords, colors).random_sample(20, seed=4)
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert PointCloud(coords, colors).random_sample(80).size == 50
