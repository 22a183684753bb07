"""The oracle backend (RasterizerConfig.backend="reference") against the JAX
package's, on the same numpy inputs: rasterize_reference's outputs
(rtol 1e-4 / atol 1e-5, n_contrib equal) and its gradients by autograd
against jax.vjp (rtol 2e-3 / atol 2e-4 x the largest magnitude), on the
scenes of tests/test_rasterize_ref.py and tests/test_rasterize_pallas.py
(early exit included); render(backend="reference") with the new RenderAux
fields; two make_train_step steps and the Trainer with backend="reference";
and the render CLI's --backend."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_rasterize_pallas
import test_rasterize_ref
from torch_port_helpers import (
    CHUNK, H, MAX_PAIRS, TILE, W, assert_images_close, outputs_numpy, scene_numpy,
    to_numpy, to_torch,
)
from test_torch_train_step import check_train_steps

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu import render as jax_render
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.ops import rasterize_ref as jax_ref
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import config, render_cli
from gaussiansplattingmlx_tpu_torch.data import ply
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import rasterize_ref
from gaussiansplattingmlx_tpu_torch.render import render, resolve_backend
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

FOCAL = 60.0
# Scene makers and their arguments: tests/test_rasterize_ref.py's (square
# tiles, isotropic conics; also with opacities 0.95-0.99, the early exit)
# and tests/test_rasterize_pallas.py's (16 x 8 tiles, off-diagonal conics).
SCENES = {
    "ref": (test_rasterize_ref.make_scene, dict(n=20)),
    "ref_early_exit": (test_rasterize_ref.make_scene, dict(n=30, opacity_range=(0.95, 0.99))),
    "pallas": (test_rasterize_pallas.make_scene, dict(n=24)),
}


def _scene(name, seed=0):
    make, kw = SCENES[name]
    packed, b, dims = make(np.random.default_rng(seed), **kw)
    return np.asarray(packed), np.asarray(b.sorted_gauss_idx), np.asarray(b.sorted_tile_id), dims


@pytest.mark.parametrize("name", sorted(SCENES))
def test_rasterize_reference_matches_jax(name):
    """Outputs at rtol 1e-4 / atol 1e-5 with n_contrib equal; the gradient
    of random output cotangents by autograd against jax.vjp at rtol 2e-3 /
    atol 2e-4 x its largest magnitude, zero where JAX's is."""
    packed, gidx, tid, dims = _scene(name)
    w, h = dims[0], dims[1]
    rng = np.random.default_rng(2)
    cots = (rng.normal(size=(h, w, 3)).astype(np.float32),
            rng.normal(size=(h, w)).astype(np.float32),
            rng.normal(size=(h, w)).astype(np.float32))

    def f(p):
        out = jax_ref.rasterize_reference(p, jnp.asarray(gidx), jnp.asarray(tid), *dims)
        return (out.color, out.depth, out.alpha), out

    @jax.jit
    def outputs_and_grad(p, c):
        _, vjp, out = jax.vjp(f, p, has_aux=True)
        return out, vjp(c)[0]

    want_out, want_grad = outputs_and_grad(jnp.asarray(packed),
                                           tuple(jnp.asarray(c) for c in cots))
    want, want_grad = outputs_numpy(want_out), np.asarray(want_grad)
    p = to_torch(packed).requires_grad_()
    out = rasterize_ref.rasterize_reference(p, to_torch(gidx), to_torch(tid), *dims)
    torch.autograd.backward([out.color, out.depth, out.alpha], [to_torch(c) for c in cots])
    got, got_grad = outputs_numpy(out), to_numpy(p.grad)
    for k in ("color", "depth", "alpha"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["n_contrib"].dtype == np.int32
    np.testing.assert_array_equal(got["n_contrib"], want["n_contrib"])
    if "early_exit" in name:  # the exit fires
        assert (got["n_contrib"] < SCENES[name][1]["n"]).any()
    scale = float(np.abs(want_grad).max())
    assert scale > 0
    np.testing.assert_allclose(got_grad, want_grad, rtol=2e-3, atol=2e-4 * scale)
    np.testing.assert_array_equal(got_grad == 0.0, want_grad == 0.0)


def test_row_chunks_change_nothing():
    """Any row_chunk gives the same outputs, bit for bit, and the same
    gradient but for the order in which the chunks' parts are summed
    (rtol 1e-5)."""
    packed, gidx, tid, dims = _scene("pallas")
    results = []
    for chunk in (1, 8, 64):
        p = to_torch(packed).requires_grad_()
        out = rasterize_ref.rasterize_reference(p, to_torch(gidx), to_torch(tid), *dims,
                                                row_chunk=chunk)
        (torch.sum(out.color) + torch.sum(out.depth * out.alpha)).backward()
        results.append([outputs_numpy(out), to_numpy(p.grad)])
    for out, grad in results[1:]:
        for k, v in out.items():
            np.testing.assert_array_equal(v, results[0][0][k], err_msg=k)
        np.testing.assert_allclose(grad, results[0][1], rtol=1e-5,
                                   atol=1e-6 * np.abs(grad).max())


def test_sample_alpha_clamp_gradient_matches_jnp():
    """Zero gradient above the clamp, half at a tie (jnp.minimum's), one
    below."""
    raw = np.array([0.5, 0.99, 1.3], np.float32)
    zeros = np.zeros(3, np.float32)
    want = jax.grad(lambda o: jnp.sum(jax_ref.sample_alpha(0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                                           0.0, 0.0, o)))(jnp.asarray(raw))
    o = to_torch(raw).requires_grad_()
    z = to_torch(zeros)
    torch.sum(rasterize_ref.sample_alpha(z, z, z, z, z, z, z, z, o)).backward()
    np.testing.assert_array_equal(to_numpy(o.grad), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(o.grad), [1.0, 0.5, 0.0])


def test_unpack_gradients_matches_jax():
    g = np.random.default_rng(0).normal(size=(7, 11)).astype(np.float32)
    for got, want in zip(rasterize_ref.unpack_gradients(to_torch(g)),
                         jax_ref.unpack_gradients(jnp.asarray(g))):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _render_jax(params, c2w, sh_degree, white, inference):
    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    means, shs, opacity, scales, rots = jax_gaussians.activations(gp)
    t = JaxCamera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = jax_config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=MAX_PAIRS,
                                      chunk_size=CHUNK)
    return jax_render.render(
        means, shs, opacity, scales, rots,
        jnp.asarray(t["view"]), jnp.asarray(t["proj"]), jnp.asarray(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
        raster_cfg=cfg, white_background=white, backend="reference", inference=inference,
    )


def _render_port(params, c2w, sh_degree, white, inference, backend, layout="sorted"):
    gp = gaussians.params_from_numpy(params, "cpu")
    means, shs, opacity, scales, rots = gaussians.activations(gp)
    t = Camera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=MAX_PAIRS,
                                  chunk_size=CHUNK, **config.LAYOUTS[layout])
    return render(
        means, shs, opacity, scales, rots,
        to_torch(t["view"]), to_torch(t["proj"]), to_torch(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
        raster_cfg=cfg, white_background=white, inference=inference, backend=backend,
    )


def _assert_aux_matches(got, want):
    for k in ("num_pairs", "overflow_gaussians", "overflow_pairs", "tile_depth_max"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert float(got.tile_depth_mean) == pytest.approx(float(want.tile_depth_mean), rel=1e-6)
    np.testing.assert_allclose(to_numpy(got.means2d), np.asarray(want.means2d),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(to_numpy(got.radii), np.asarray(want.radii))


@pytest.mark.parametrize("seed,sh_degree,white,inference",
                         [(3, 0, False, False), (13, 3, True, True)])
def test_render_reference_matches_jax(seed, sh_degree, white, inference):
    """render(backend="reference") against the JAX package's, image and
    RenderAux; inference=True changes nothing in the reference branch."""
    params, c2w = scene_numpy(seed=seed, sh_degree=sh_degree, sh_rest_scale=0.2 * sh_degree)
    want_out, want_aux = _render_jax(params, c2w, sh_degree, white, inference)
    got_out, got_aux = _render_port(params, c2w, sh_degree, white, inference, "reference")
    assert int(want_aux.num_pairs) > 0
    got, want = outputs_numpy(got_out), outputs_numpy(want_out)
    for k in ("color", "depth", "alpha"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["n_contrib"], want["n_contrib"])
    _assert_aux_matches(got_aux, want_aux)
    other, _ = _render_port(params, c2w, sh_degree, white, not inference, "reference")
    np.testing.assert_array_equal(to_numpy(other.color), got["color"])


@pytest.mark.parametrize("layout", list(config.LAYOUTS))
def test_render_aux_fields_every_layout(layout):
    """The kernels' layouts fill RenderAux's new fields as the JAX package's
    reference render does (the same pairs per tile), and their images meet
    the oracle's at the JAX image bars."""
    params, c2w = scene_numpy(seed=3)
    want_out, want_aux = _render_jax(params, c2w, 0, False, False)
    got_out, got_aux = _render_port(params, c2w, 0, False, False, None, layout)
    _assert_aux_matches(got_aux, want_aux)
    assert_images_close(outputs_numpy(got_out), outputs_numpy(want_out))


def test_resolve_backend():
    for name in ("auto", "pallas", "pallas_interpret"):
        assert resolve_backend(name) == "kernels"
    assert resolve_backend("reference") == "reference"
    with pytest.raises(ValueError, match="triton"):
        resolve_backend("triton")


def test_reference_train_steps_match_jax(tmp_path):
    """Two steps of make_train_step(backend="reference") against the JAX
    package's reference step, at tests/test_torch_train_step.py's bars."""
    check_train_steps(tmp_path, "reference", views=(0, 1))


def test_render_cli_reference_backend(tmp_path):
    """render_cli --backend reference renders the orbit within the JAX image
    bars of the kernels' path (plain versions on the CPU)."""
    params, _ = scene_numpy(n=60, seed=5, sh_degree=1, sh_rest_scale=0.1)
    path = tmp_path / "scene.ply"
    ply.write_gaussian_ply(path, params["xyz"], params["features_dc"],
                           params["features_rest"], params["opacity"], params["scales"],
                           params["rotation"])
    common = ["--ply", str(path), "--orbit", "2", "--width", "40", "--height", "32",
              "--focal", "40", "--max-pairs", "4096", "--no-auto-pairs", "--device", "cpu"]
    ref = render_cli.main([*common, "--out", str(tmp_path / "ref"), "--backend", "reference"])
    ker = render_cli.main([*common, "--out", str(tmp_path / "ker")])
    assert sorted(p.name for p in (tmp_path / "ref").iterdir()) == [
        "render_000.png", "render_001.png"]
    for a, b in zip(ref.colors, ker.colors):
        assert a.shape == (32, 40, 3) and a.std() > 1e-3
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        render_cli.main([*common, "--out", str(tmp_path / "x"), "--backend", "bogus"])


def test_dp_step_and_trainer_pass_the_backend(tmp_path, monkeypatch):
    """make_dp_train_step(backend=...) on a one-rank mesh renders with the
    oracle and equals make_train_step(backend=...) bit for bit;
    Trainer(backend=...) renders every step with it."""
    from test_torch_train_step import ITERS, RASTER, SH, _carry, _jax_state, _views

    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.parallel import sharding
    from gaussiansplattingmlx_tpu_torch.train import trainer
    from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud

    calls = []
    oracle = rasterize_ref.rasterize_reference
    monkeypatch.setattr(rasterize_ref, "rasterize_reference",
                        lambda *a, **k: calls.append(1) or oracle(*a, **k))
    c2ws, images = _views()
    cfg = config.TrainConfig(iterations=ITERS, model=config.ModelConfig(sh_degree=SH),
                             raster=config.RasterizerConfig(**RASTER))
    data = TrainData([Camera.from_c2w(W, H, 60.0, 60.0, c) for c in c2ws], images)
    views = trainer.stack_views(data, "cpu")
    mesh = sharding.Mesh(shape={"data": 1, "tile": 1}, data_index=0, tile_index=0,
                         ranks=(0,), group=None, data_group=None, tile_group=None)
    jstate = _jax_state()
    one = trainer.make_train_step(cfg, W, H, SH, ITERS, backend="reference")(
        _carry(jstate, tmp_path, "a.npz"), views, 1)
    dp = sharding.make_dp_train_step(cfg, W, H, SH, ITERS, mesh, backend="reference")(
        _carry(jstate, tmp_path, "b.npz"), views, sharding.shard_view_idx([1], mesh))
    assert len(calls) == 2
    assert float(dp[1]["loss"]) == float(one[1]["loss"])
    for a, b in zip(trainer.state_to_numpy(dp[0]).values(),
                    trainer.state_to_numpy(one[0]).values()):
        np.testing.assert_array_equal(a, b)

    params, _ = scene_numpy(n=60, seed=3)
    tr = trainer.Trainer(
        config.TrainConfig(iterations=2, init_points=60, log_interval=1, output_dir="",
                           checkpoint_interval=0, snapshot_interval=10 ** 9,
                           model=config.ModelConfig(sh_degree=0, initial_capacity=64),
                           raster=config.RasterizerConfig(**RASTER)),
        data, PointCloud(params["xyz"], np.full((60, 3), 128.0, np.float32)), device="cpu",
        backend="reference")
    tr.run()
    assert tr.backend == "reference" and len(calls) == 4 and int(tr.state.step) == 2
