"""The benchmark's plain reference agrees with the program's render and
training step at a small size on the CPU."""

from __future__ import annotations

import json

import torch

from benchmark import harness, scene, train_loop
from benchmark import reference as ref


def test_reference_image_matches_the_programs_render(tiny_root):
    from gaussiansplattingmlx_tpu_torch import config as pcfg
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations
    from gaussiansplattingmlx_tpu_torch.render import render

    for name in ("nerf_synthetic_800", "mipnerf360_outdoor_4"):  # white and black backgrounds
        cfg = json.loads((tiny_root / "benchmark" / "configs" / f"{name}.json").read_text())
        fit = scene.draw_scene(cfg, 21, "cpu")
        cam = scene.train_cameras(cfg, "cpu")[1]
        white = bool(cfg["white_background"])
        want, work = ref.render(fit, cam, cfg["sh_degree"], cfg["tile"], white,
                                count_work=True)
        rcfg = pcfg.RasterizerConfig(max_pairs=2 * work.pairs + 4096, tile_w=cfg["tile"],
                                     tile_h=cfg["tile"])
        out, aux = render(*activations(fit), cam.view, cam.proj, cam.center, cam.fov_x,
                          cam.fov_y, cam.focal_x, cam.focal_y, cam.width, cam.height,
                          cfg["sh_degree"], raster_cfg=rcfg, white_background=white,
                          inference=True)
        assert int(aux.num_pairs) == work.pairs
        assert torch.allclose(out.color, want, atol=2e-4, rtol=0), float(
            (out.color - want).abs().max())
        assert int(out.n_contrib.sum()) == work.pixel_records


def test_reference_step_matches_the_programs_step(tiny_root):
    cell = harness.load_cell("mipnerf360_outdoor_4.train_late", tiny_root)
    inp = train_loop.make_inputs(cell, 4, "cpu")
    got = train_loop.first_steps(train_loop.Program(cell, inp, "cpu"), inp, "cpu")
    want = train_loop.reference_steps(cell, inp, "cpu")
    gaps = train_loop.compare(got, want)
    assert gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-3, gaps
    assert gaps["change_gap"] < 1e-3 and gaps["image_gap"] < 2e-3, gaps
