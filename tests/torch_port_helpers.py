"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs, made from a seed, go through the JAX package and the
port; arrays cross between them as numpy.  Torch is capped at two CPU
threads: the suite runs several pytest workers on one machine.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# The fused-staging scenes of tests/test_staging.py.
W, H = 48, 48
TILE = 16
CHUNK = 32
MAX_PAIRS = 4096


def to_torch(x, device="cpu"):
    return torch.as_tensor(np.array(x)).to(device)


def to_numpy(x):
    return x.detach().cpu().numpy()


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided at run
    time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")


def scene_numpy(n=80, seed=3, sh_degree=0, sh_rest_scale=0.0):
    """Raw Gaussian parameters as numpy, drawn exactly like
    tests/test_staging.py:scene (create_from_points, then random scales and
    opacity; identity rotations), plus optional nonzero higher SH bands.
    Returns (params dict keyed like PARAM_NAMES, c2w of the camera at z=-4)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    params = {
        "xyz": pts,
        "features_dc": ((cols - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32),
        "features_rest": np.zeros((n, (sh_degree + 1) ** 2 - 1, 3), np.float32),
        "scales": np.log(rng.uniform(0.05, 0.25, size=(n, 3))).astype(np.float32),
        "rotation": rot,
        "opacity": rng.normal(0.5, 1.0, size=(n, 1)).astype(np.float32),
    }
    if sh_rest_scale:
        rest = rng.normal(size=params["features_rest"].shape) * sh_rest_scale
        params["features_rest"] = rest.astype(np.float32)
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    return params, c2w


def jax_geometry(params, c2w, width=W, height=H, focal=60.0, sh_degree=0):
    """The JAX package's activations + projection + packing of a numpy
    scene, returned as numpy: (packed [N, 11], rect_min, rect_max, radii,
    depths)."""
    import jax.numpy as jnp

    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.ops import projection, rasterize_ref
    from gaussiansplattingmlx_tpu.utils.camera import Camera

    gp = gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    means, shs, opacity, scales, rots = gaussians.activations(gp)
    t = Camera.from_c2w(width, height, focal, focal, c2w).tensors()
    p = projection.project_gaussians(
        means, scales, rots, shs,
        jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
        jnp.asarray(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
        width, height, sh_degree,
    )
    packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity, p.depths)
    return tuple(np.asarray(a) for a in (packed, p.rect_min, p.rect_max, p.radii, p.depths))


def assert_images_close(got, want, ncon_slack=0.003):
    """The JAX package's Pallas-vs-oracle tolerances
    (tests/test_rasterize_pallas.py): the two rasterizers round the
    transmittance product differently."""
    np.testing.assert_allclose(got["color"], want["color"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=1e-4, atol=1e-5)
    mismatch = np.mean(got["n_contrib"] != want["n_contrib"])
    assert mismatch <= ncon_slack, f"n_contrib mismatch fraction {mismatch}"


def outputs_numpy(out):
    """RenderOutputs (either package) -> dict of numpy arrays."""
    conv = to_numpy if isinstance(out.color, torch.Tensor) else np.asarray
    return {k: conv(getattr(out, k)) for k in ("color", "depth", "alpha", "n_contrib")}
