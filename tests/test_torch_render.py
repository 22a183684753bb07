"""The whole inference slice: the same numpy parameters through the JAX
package's render(backend="pallas_interpret", inference=True) and the port's
render(inference=True) on the CPU; and the port's render CLI end to end."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import (
    CHUNK, H, MAX_PAIRS, TILE, W, assert_images_close, outputs_numpy,
    scene_numpy, to_torch,
)

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu import render as jax_render
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import config, render_cli
from gaussiansplattingmlx_tpu_torch.data import ply
from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

FOCAL = 60.0


def _render_jax(params, c2w, sh_degree, white):
    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    means, shs, opacity, scales, rots = jax_gaussians.activations(gp)
    t = JaxCamera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = jax_config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=MAX_PAIRS,
                                      chunk_size=CHUNK)
    return jax_render.render(
        means, shs, opacity, scales, rots,
        jnp.asarray(t["view"]), jnp.asarray(t["proj"]), jnp.asarray(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
        raster_cfg=cfg, white_background=white, backend="pallas_interpret",
        inference=True,
    )


def _render_port(params, c2w, sh_degree, white, device="cpu"):
    gp = params_from_numpy(params, device)
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(gp)
    t = Camera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cfg = config.RasterizerConfig(tile_h=TILE, tile_w=TILE, max_pairs=MAX_PAIRS,
                                  chunk_size=CHUNK)
    return render(
        means, shs, opacity, scales, rots,
        to_torch(t["view"], device), to_torch(t["proj"], device),
        to_torch(t["camera_center"], device),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, sh_degree,
        raster_cfg=cfg, white_background=white, inference=True,
    )


@pytest.mark.parametrize("seed,sh_degree,white", [(3, 0, False), (13, 3, True)])
def test_render_inference_matches_jax(seed, sh_degree, white):
    params, c2w = scene_numpy(seed=seed, sh_degree=sh_degree,
                              sh_rest_scale=0.2 if sh_degree else 0.0)
    want, want_aux = _render_jax(params, c2w, sh_degree, white)
    got, got_aux = _render_port(params, c2w, sh_degree, white)
    assert int(got_aux.num_pairs) == int(want_aux.num_pairs) > 0
    assert int(got_aux.overflow_pairs) == int(want_aux.overflow_pairs) == 0
    np.testing.assert_array_equal(got_aux.radii.numpy(), np.asarray(want_aux.radii))
    got_np, want_np = outputs_numpy(got), outputs_numpy(want)
    assert got_np["color"].shape == (H, W, 3)
    assert got_np["color"].std() > 0.01
    assert_images_close(got_np, want_np)


def test_render_training_path_not_ported():
    params, c2w = scene_numpy(n=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gp = params_from_numpy(params, "cpu")
        means, shs, opacity, scales, rots = activations(gp)
        t = Camera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
        render(means, shs, opacity, scales, rots, to_torch(t["view"]),
               to_torch(t["proj"]), to_torch(t["camera_center"]), t["fov_x"],
               t["fov_y"], t["focal_x"], t["focal_y"], W, H, 0)


def test_render_cli_cpu_writes_pngs(tmp_path):
    params, _ = scene_numpy(n=120, seed=5, sh_degree=1, sh_rest_scale=0.1)
    ply.write_gaussian_ply(
        tmp_path / "scene.ply", params["xyz"], params["features_dc"],
        params["features_rest"], params["opacity"], params["scales"],
        params["rotation"],
    )
    out_dir = tmp_path / "renders"
    res = render_cli.main([
        "--ply", str(tmp_path / "scene.ply"), "--out", str(out_dir),
        "--orbit", "2", "--width", "40", "--height", "32", "--focal", "40",
        "--bench-frames", "2", "--depth", "--device", "cpu",
    ])
    assert res.device == "cpu"
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "depth_000.png", "depth_001.png", "render_000.png", "render_001.png"]
    assert (out_dir / "render_000.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert all(n > 0 for n in res.num_pairs) and res.overflow_pairs == [0, 0]
    assert res.max_pairs % 512 == 0 and res.max_pairs >= max(res.num_pairs)
    assert res.bench_fps > 0 and res.bench_overflow_pairs == 0
    for c in res.colors:
        assert c.shape == (32, 40, 3) and np.isfinite(c).all() and c.std() > 0


def test_render_cli_cuda_without_gpu_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, _ = scene_numpy(n=4)
    ply.write_gaussian_ply(
        tmp_path / "s.ply", params["xyz"], params["features_dc"],
        params["features_rest"], params["opacity"], params["scales"],
        params["rotation"],
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_cli.main(["--ply", str(tmp_path / "s.ply"), "--out", str(tmp_path)])
