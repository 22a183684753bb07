"""Gradients of all six Gaussian parameters through the port's training
render (render(inference=False) on the CPU: staging Function, K1/K3 and K4
plain versions) against jax.grad of the JAX package's render with
backend="pallas_interpret" and train_staging="sorted", from the same numpy
parameters."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import CHUNK, H, MAX_PAIRS, TILE, W, scene_numpy, to_numpy, to_torch

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu import render as jax_render
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

FOCAL = 60.0


def _loss_terms(color, depth, alpha, target, xp):
    return xp.sum((color - target) ** 2) + 0.1 * xp.sum(depth) + xp.sum(alpha)


def _grads_jax(params, c2w, sh_degree, max_pairs, target, white):
    t = JaxCamera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = jax_config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=max_pairs,
                                      chunk_size=CHUNK, train_staging="sorted")

    def f(ptuple):
        gp = jax_gaussians.GaussianParams.from_tuple(ptuple)
        means, shs, opacity, scales, rots = jax_gaussians.activations(gp)
        out, _ = jax_render.render(
            means, shs, opacity, scales, rots,
            jnp.asarray(t["view"]), jnp.asarray(t["proj"]), jnp.asarray(t["camera_center"]),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
            raster_cfg=cfg, white_background=white, backend="pallas_interpret",
        )
        return _loss_terms(out.color, out.depth, out.alpha, jnp.asarray(target), jnp)

    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    loss, grads = jax.value_and_grad(f)(gp.as_tuple())
    return float(loss), [np.asarray(g) for g in grads]


def _grads_port(params, c2w, sh_degree, max_pairs, target, white):
    gp = gaussians.params_from_numpy(params, "cpu")
    means, shs, opacity, scales, rots = gaussians.activations(gp)
    t = Camera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=max_pairs,
                                  chunk_size=CHUNK)
    out, aux = render(
        means, shs, opacity, scales, rots,
        to_torch(t["view"]), to_torch(t["proj"]), to_torch(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
        raster_cfg=cfg, white_background=white, inference=False,
    )
    assert int(aux.overflow_pairs) == 0 and int(aux.num_pairs) > 0
    loss = _loss_terms(out.color, out.depth, out.alpha, to_torch(target), torch)
    loss.backward()
    return float(loss.detach()), [to_numpy(getattr(gp, n).grad) for n in gaussians.PARAM_NAMES]


def _tiny_tiles_scene():
    """tests/test_staging.py:473's scene: six large, fairly opaque gaussians
    whose pairs put several tiles inside one record window."""
    params, c2w = scene_numpy(n=6, seed=23)
    params = dict(params, scales=np.full((6, 3), np.log(0.35), np.float32),
                  opacity=np.full((6, 1), 1.5, np.float32))
    return params, c2w


@pytest.mark.parametrize("case", ["scene_sh1", "tiny_tiles_white"])
def test_render_training_gradients_match_jax(case):
    if case == "scene_sh1":
        (params, c2w), sh_degree, max_pairs, white = (
            scene_numpy(seed=7, sh_degree=1, sh_rest_scale=0.2), 1, MAX_PAIRS, False)
    else:
        (params, c2w), sh_degree, max_pairs, white = _tiny_tiles_scene(), 0, 256, True
    target = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)
    want_loss, want = _grads_jax(params, c2w, sh_degree, max_pairs, target, white)
    got_loss, got = _grads_port(params, c2w, sh_degree, max_pairs, target, white)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for name, x, y in zip(gaussians.PARAM_NAMES, got, want):
        assert x.shape == y.shape, name
        if y.size == 0:
            continue
        assert np.isfinite(x).all(), name
        # The Pallas-vs-oracle gradient tolerance, atol scaled by the
        # parameter's largest gradient (tests/test_staging.py:462-470).
        scale = max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x, y, rtol=2e-3, atol=2e-4 * scale, err_msg=name)
        # A gaussian with no contributing pair gets exactly zero on both.
        np.testing.assert_array_equal(x == 0.0, y == 0.0, err_msg=name)
    assert any(np.abs(g).max() > 0 for g in got if g.size)
