"""The golden scene of tests/test_golden.py, built and rendered by the port
(torch and numpy only, no JAX: ``chip_smoke.py`` renders it on the card
too).  The same draws from the same seed as the JAX test: 120 Gaussians at
SH degree 2, 64x64, white background; the committed
``tests/golden_scene.npz`` holds the JAX oracle's image of it."""

from pathlib import Path

import numpy as np
import torch

from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

GOLDEN = Path(__file__).resolve().parent / "golden_scene.npz"
RASTER = RasterizerConfig(tile_h=16, tile_w=16, max_pairs=8192, chunk_size=32)
W = H = 64
SH_DEGREE = 2


def golden_params(device) -> gaussians.GaussianParams:
    rng = np.random.default_rng(1234)
    n = 120
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=SH_DEGREE, capacity=n,
                                             device=device)
    src = params.to_numpy()
    src["scales"] = np.log(rng.uniform(0.05, 0.15, size=(n, 3))).astype(np.float32)
    src["rotation"] = rng.normal(size=(n, 4)).astype(np.float32)
    src["opacity"] = rng.uniform(-1.0, 2.0, size=(n, 1)).astype(np.float32)
    src["features_rest"] = rng.normal(size=(n, 8, 3)).astype(np.float32) * 0.1
    return gaussians.params_from_numpy(src, device)


def render_golden(device, backend: str, inference: bool) -> dict:
    """The golden scene's color, depth, alpha and n_contrib as numpy."""
    c2w = np.eye(4)
    c2w[:3, 3] = [0.5, -0.3, -3.5]
    t = Camera.from_c2w(W, H, 70.0, 72.0, c2w).tensors()
    with torch.no_grad():
        act = gaussians.activations(golden_params(device))
        out, _ = render(
            *act,
            *(torch.as_tensor(np.asarray(t[k])).to(device)
              for k in ("view", "proj", "camera_center")),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, SH_DEGREE,
            raster_cfg=RASTER, white_background=True, inference=inference, backend=backend,
        )
    return {k: getattr(out, k).detach().cpu().numpy()
            for k in ("color", "depth", "alpha", "n_contrib")}


def golden_errors(got: dict, want) -> dict:
    """The JAX golden test's measures: the largest excess over each bar
    (<= 0 passes) and the n_contrib mismatch fraction (must stay < 0.002)."""
    out = {}
    for k, rtol, atol in (("color", 1e-4, 1e-5), ("depth", 1e-4, 1e-4),
                          ("alpha", 1e-4, 1e-5)):
        diff = np.abs(got[k].astype(np.float64) - want[k])
        out[f"{k}_excess"] = float(np.max(diff - (atol + rtol * np.abs(want[k]))))
        out[f"{k}_max_abs_err"] = float(diff.max())
    out["ncon_mismatch"] = float(np.mean(got["n_contrib"] != want["n_contrib"]))
    return out
