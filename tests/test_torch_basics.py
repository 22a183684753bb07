"""The port's framework-free pieces against the JAX package: config, camera,
PLY, parameters, SH; and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import to_numpy, to_torch

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu.data import ply as jax_ply
from gaussiansplattingmlx_tpu.utils import camera as jax_camera
from gaussiansplattingmlx_tpu.utils import sh as jax_sh
from gaussiansplattingmlx_tpu.utils import transforms as jax_transforms
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data import ply
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.utils import camera, sh, transforms

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", [
    "RasterizerConfig", "ModelConfig", "OptimizerConfig", "DensifyConfig",
    "LossConfig", "CameraConfig", "ParallelConfig", "TrainConfig",
])
def test_rasterizer_config_matches_jax(name):
    """Every config dataclass of the port has the JAX package's fields,
    annotations and defaults (nested configs: the same default factory)."""
    def fields(cls):
        return [(f.name, f.type, f.default,
                 f.default_factory().__class__.__name__
                 if f.default_factory is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]

    assert fields(getattr(config, name)) == fields(getattr(jax_config, name))
    assert (dataclasses.asdict(getattr(config, name)())
            == dataclasses.asdict(getattr(jax_config, name)()))


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_tensors_bit_equal(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.eye(4)
    c2w[:3, :3] = q
    c2w[:3, 3] = rng.normal(size=3) * 3
    width, height, focal = 64 + seed, 48, float(rng.uniform(40, 90))
    a = camera.Camera.from_c2w(width, height, focal, focal * 1.1, c2w).tensors()
    b = jax_camera.Camera.from_c2w(width, height, focal, focal * 1.1, c2w).tensors()
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert camera.fov2focal(0.7, 100) == jax_camera.fov2focal(0.7, 100)
    assert camera.focal2fov(90.0, 100) == jax_camera.focal2fov(90.0, 100)


def _random_ply_fields(rng, n, m):
    return (rng.normal(size=(n, 3)), rng.normal(size=(n, 1, 3)),
            rng.normal(size=(n, m, 3)), rng.normal(size=(n, 1)),
            rng.normal(size=(n, 3)), rng.normal(size=(n, 4)))


@pytest.mark.parametrize("m", [0, 15, 24])
def test_ply_crosses_packages_bit_equal(tmp_path, m):
    rng = np.random.default_rng(m)
    fields = _random_ply_fields(rng, 7, m)
    jax_ply.write_gaussian_ply(tmp_path / "j.ply", *fields)
    ply.write_gaussian_ply(tmp_path / "t.ply", *fields)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    got = ply.read_gaussian_ply(tmp_path / "j.ply")
    want = jax_ply.read_gaussian_ply(tmp_path / "j.ply")
    for name in ("xyz", "features_dc", "features_rest", "opacity", "scales", "rotation"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=name)


def test_params_from_numpy_round_trips(tmp_path):
    rng = np.random.default_rng(4)
    fields = _random_ply_fields(rng, 9, 15)
    ply.write_gaussian_ply(tmp_path / "g.ply", *fields)
    g = ply.read_gaussian_ply(tmp_path / "g.ply")
    params = gaussians.params_from_numpy(g, "cpu")
    assert params.capacity == 9 and params.sh_degree == 3
    assert [n for n, _ in params.named_parameters()] == list(gaussians.PARAM_NAMES)
    back = params.to_numpy()
    for name in gaussians.PARAM_NAMES:
        np.testing.assert_array_equal(back[name], getattr(g, name), err_msg=name)
    again = gaussians.params_from_numpy(back, "cpu").to_numpy()
    for name in gaussians.PARAM_NAMES:
        np.testing.assert_array_equal(again[name], back[name], err_msg=name)
    means, shs, opacity, scales, rots = gaussians.activations(params)
    assert shs.shape == (9, 16, 3)
    np.testing.assert_allclose(to_numpy(opacity), 1 / (1 + np.exp(-g.opacity)), rtol=1e-6)
    np.testing.assert_allclose(to_numpy(scales), np.exp(g.scales), rtol=1e-6)
    assert gaussians.INACTIVE_OPACITY == -30.0


@pytest.mark.parametrize("degree", [0, 1, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(64, k, 3)).astype(np.float32)
    dirs = (rng.normal(size=(64, 3)) * 2).astype(np.float32)  # unnormalized
    want = np.asarray(jax_sh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = to_numpy(sh.eval_sh(degree, to_torch(coeffs), to_torch(dirs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_c = np.asarray(jax_sh.sh_to_color(degree, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got_c = to_numpy(sh.sh_to_color(degree, to_torch(coeffs), to_torch(dirs)))
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(sh.rgb2sh(rgb), np.asarray(jax_sh.rgb2sh(rgb)), rtol=1e-6)


def test_transforms_match_jax():
    rng = np.random.default_rng(8)
    quats = rng.normal(size=(32, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.5, size=(32, 3)).astype(np.float32)
    mats = (rng.normal(size=(32, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    pairs = [
        (transforms.quat_to_rotmat(to_torch(quats)),
         jax_transforms.quat_to_rotmat(jnp.asarray(quats))),
        (transforms.build_cov3d(to_torch(scales), to_torch(quats)),
         jax_transforms.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))),
        (transforms.inv3x3(to_torch(mats)), jax_transforms.inv3x3(jnp.asarray(mats))),
        (transforms.homogeneous(to_torch(scales)),
         jax_transforms.homogeneous(jnp.asarray(scales))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax():
    """Importing every module of the port (the render CLI included) pulls in
    neither jax nor the JAX package."""
    code = (
        "import pkgutil, sys\n"
        "import gaussiansplattingmlx_tpu_torch as pkg\n"
        "import gaussiansplattingmlx_tpu_torch.render_cli\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'gaussiansplattingmlx_tpu'\n"
        "             or m.startswith('gaussiansplattingmlx_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
