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
    """The pixel-band form of the training render (ROADMAP.md A.6, used by
    the band-split step) is ported: the two halves of a view, each rendered
    with its band window, are the full render's rows, and its pairs split
    between them (tests/test_torch_parallel.py holds bands against JAX)."""
    params, c2w = scene_numpy(n=40)
    gp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(gp)
    t = Camera.from_c2w(W, H, FOCAL, FOCAL, c2w).tensors()
    cam = (to_torch(t["view"]), to_torch(t["proj"]), to_torch(t["camera_center"]),
           t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"])
    cfg = config.RasterizerConfig(tile_h=TILE // 2, tile_w=TILE // 2, max_pairs=MAX_PAIRS,
                                  chunk_size=CHUNK)
    with torch.no_grad():
        full, full_aux = render(means, shs, opacity, scales, rots, *cam, W, H, 0,
                                raster_cfg=cfg)
        bands = [render(means, shs, opacity, scales, rots, *cam, W, H // 2, 0,
                        raster_cfg=cfg, pixel_y_offset=b * (H // 2), full_image_height=H)
                 for b in range(2)]
    for key in ("color", "alpha"):
        np.testing.assert_allclose(
            np.concatenate([outputs_numpy(out)[key] for out, _ in bands]),
            outputs_numpy(full)[key], rtol=1e-4, atol=1e-5, err_msg=key)
    assert sum(int(aux.num_pairs) for _, aux in bands) == int(full_aux.num_pairs) > 0


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


def test_render_cli_video_gif_decodes(tmp_path):
    """``--video`` writes a looping GIF of the orbit frames without Pillow;
    Pillow reads it back frame for frame, each frame the render on the
    GIF's fixed palette."""
    from PIL import Image, ImageSequence

    from gaussiansplattingmlx_tpu_torch.utils import gif

    params, _ = scene_numpy(n=80, seed=5, sh_degree=0)
    ply.write_gaussian_ply(tmp_path / "scene.ply", params["xyz"], params["features_dc"],
                           params["features_rest"], params["opacity"], params["scales"],
                           params["rotation"])
    video = tmp_path / "orbit.gif"
    res = render_cli.main([
        "--ply", str(tmp_path / "scene.ply"), "--out", str(tmp_path / "renders"),
        "--orbit", "3", "--width", "40", "--height", "32", "--focal", "40",
        "--video", str(video), "--video-fps", "25", "--device", "cpu",
    ])
    with Image.open(video) as im:
        frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
        assert im.info["loop"] == 0 and im.info["duration"] == 40
    assert len(frames) == 3
    for got, color in zip(frames, res.colors):
        rendered = np.clip(color * 255.0, 0, 255).astype(np.uint8)
        want = gif._palette()[gif._quantise(rendered)].reshape(rendered.shape)
        np.testing.assert_array_equal(got, want)
