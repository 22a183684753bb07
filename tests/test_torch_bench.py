"""The port's bench (``gaussiansplattingmlx_tpu_torch/bench.py``) against the
JAX package's ``bench.py`` on the CPU: its scene bit for bit, its probe and
pair budget at the full 800x800 / 100,000-Gaussian workload, its step
(loss, image, every raw gradient, the workload stats) at a toy size against
``jax.value_and_grad`` of bench.py's step (``backend="pallas_interpret"``),
and the command line: the last line on the CPU, and no CPU fallback."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import to_numpy

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu import render as jax_render
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.ops import binning as jax_binning
from gaussiansplattingmlx_tpu.ops import losses as jax_losses
from gaussiansplattingmlx_tpu.ops import projection as jax_projection
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu_torch import bench
from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
from gaussiansplattingmlx_tpu_torch.models.gaussians import PARAM_NAMES, activations
from gaussiansplattingmlx_tpu_torch.render import render

ROOT = Path(__file__).resolve().parent.parent
FULL_N, FULL_SIZE, SH_DEGREE = 100_000, 800, 3
# The toy step: 64x64, 400 Gaussians, SH3, tile 16, bench.py's chunk.
TOY = dict(size=64, n=400, tile=16, chunk=128)
TOY_ARGV = ["--size", "64", "--gaussians", "400", "--tile", "16"]
IMAGE_RTOL, IMAGE_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
LINE_KEYS = {"metric", "value", "unit", "num_pairs", "max_pairs", "tile", "overflow_pairs",
             "tile_depth_mean", "tile_depth_max", "device", "power_limit_w", "repeats",
             "iters", "step_ms", "device_ms_median", "loss", "seed"}


def jax_bench_scene(n, seed, size):
    """bench.py:79-99: create_from_points, the scales and opacity replaced,
    then the target."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    cols = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    params, _ = jax_gaussians.create_from_points(pts, cols, sh_degree=SH_DEGREE, capacity=n)
    params = dataclasses.replace(
        params,
        scales=jnp.asarray(np.log(rng.uniform(0.004, 0.02, size=(n, 3))).astype(np.float32)),
        opacity=jnp.asarray(rng.normal(0.0, 2.0, size=(n, 1)).astype(np.float32)),
    )
    target = rng.uniform(size=(size, size, 3)).astype(np.float32)
    return params, target


def jax_camera(size):
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    focal = 1111.0 * size / 800
    return JaxCamera.from_c2w(size, size, focal, focal, c2w).tensors()


def jax_cam_args(t):
    return (jnp.asarray(t["view"]), jnp.asarray(t["proj"]), jnp.asarray(t["camera_center"]),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"])


def jax_pair_demand(params, size, tile):
    """bench.py:110-128."""
    t = jax_camera(size)

    @jax.jit
    def pair_demand(ptuple):
        pp = jax_gaussians.GaussianParams.from_tuple(ptuple)
        means, shs, opacity, scales, rots = jax_gaussians.activations(pp)
        p = jax_projection.project_gaussians(means, scales, rots, shs, *jax_cam_args(t),
                                             size, size, SH_DEGREE)
        gw = gh = -(-size // tile)
        tmin_x, tmin_y, tmax_x, tmax_y = jax_binning._tile_bounds(
            p.rect_min, p.rect_max, tile, tile, gw, gh)
        foot = jnp.maximum(tmax_x - tmin_x, 0) * jnp.maximum(tmax_y - tmin_y, 0)
        return jnp.sum(jnp.where(p.radii > 0, foot, 0))

    return int(pair_demand(params.as_tuple()))


def jax_budget(demand, chunk):
    """bench.py:131-133."""
    quantum = 512 * chunk // math.gcd(512, chunk)
    return -(-int(demand * 1.03) // quantum) * quantum


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def test_bench_scene_equals_jax_create_from_points():
    """bench_scene skips the k-NN that bench.py's scales overwrite; its
    parameters and target are JAX's create_from_points + replace bit for
    bit (2,000 points, the real k-NN on the JAX side)."""
    want, want_target = jax_bench_scene(2000, seed=0, size=64)
    got, got_target = bench.bench_scene(2000, SH_DEGREE, 0, "cpu", size=64)
    for name in PARAM_NAMES:
        g, w = to_numpy(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=name)
    np.testing.assert_array_equal(bits(to_numpy(got_target)), bits(want_target))


@pytest.fixture(scope="module")
def full_scenes():
    """The full workload in both packages (JAX's k-NN replaced: bench.py
    overwrites its scales)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gaussians, "knn_mean_sq_dist",
                   lambda points, k=3: np.ones(len(points), np.float32))
        jax_params, _ = jax_bench_scene(FULL_N, seed=0, size=FULL_SIZE)
    params, _ = bench.bench_scene(FULL_N, SH_DEGREE, 0, "cpu", size=FULL_SIZE)
    return jax_params, params


@pytest.mark.parametrize("tile,demand,budget", [(32, 552_230, 568_832), (16, 1_410_101, None)])
def test_full_size_probe_equals_jax(full_scenes, tile, demand, budget):
    """bench.py's probe at 800x800, 100,000 Gaussians, SH3: the same pair
    demand in both packages, and the same budget (x 1.03 in 512-slot
    quanta at chunk 128)."""
    jax_params, params = full_scenes
    cam = bench.camera_args(bench.bench_camera(FULL_SIZE), "cpu")
    got = bench.pair_demand(params, cam, FULL_SIZE, SH_DEGREE, tile)
    assert got == jax_pair_demand(jax_params, FULL_SIZE, tile) == demand
    assert bench.pair_budget(got, 128) == jax_budget(demand, 128)
    if budget is not None:
        assert bench.pair_budget(got, 128) == budget


def jax_step(params, target, size, cfg):
    """bench.py:139-159 with backend="pallas_interpret"; also the image."""
    t = jax_camera(size)
    zeros = jnp.zeros((size, size), jnp.float32)

    def loss_fn(ptuple):
        pp = jax_gaussians.GaussianParams.from_tuple(ptuple)
        means, shs, opacity, scales, rots = jax_gaussians.activations(pp)
        out, aux = jax_render.render(means, shs, opacity, scales, rots, *jax_cam_args(t),
                                     size, size, SH_DEGREE, raster_cfg=cfg,
                                     backend="pallas_interpret")
        loss, _ = jax_losses.total_loss(out.color, jnp.asarray(target), out.depth, zeros, zeros)
        stats = (aux.num_pairs, aux.overflow_pairs, aux.tile_depth_mean, aux.tile_depth_max)
        return loss, (jax.lax.stop_gradient(stats), out.color)

    (loss, (stats, color)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params.as_tuple())
    return float(loss), [float(s) for s in stats], np.asarray(color), [np.asarray(g) for g in grads]


def test_bench_step_matches_jax_value_and_grad():
    """The bench step at the toy size against JAX's: loss and image at the
    image bars, each raw gradient at rtol 2e-3 / atol 2e-4 x the leaf's
    largest magnitude, the four workload stats equal."""
    size, n, tile, chunk = TOY["size"], TOY["n"], TOY["tile"], TOY["chunk"]
    params, target = bench.bench_scene(n, SH_DEGREE, 0, "cpu", size=size)
    cam = bench.camera_args(bench.bench_camera(size), "cpu")
    max_pairs = bench.pair_budget(bench.pair_demand(params, cam, size, SH_DEGREE, tile), chunk)
    cfg = RasterizerConfig(max_pairs=max_pairs, chunk_size=chunk, tile_w=tile, tile_h=tile)
    loss, stats, grads = bench.train_like_step(params, cam, target, cfg, size, SH_DEGREE)
    with torch.no_grad():
        out, _ = render(*activations(params), *cam, size, size, SH_DEGREE, raster_cfg=cfg,
                        inference=True)

    jax_params, jax_target = jax_bench_scene(n, seed=0, size=size)
    jcfg = jax_config.RasterizerConfig(max_pairs=max_pairs, chunk_size=chunk, tile_w=tile,
                                       tile_h=tile)
    want_loss, want_stats, want_color, want_grads = jax_step(jax_params, jax_target, size, jcfg)

    assert [float(s) for s in stats] == want_stats
    assert want_stats[0] > 0 and want_stats[1] == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
    np.testing.assert_allclose(to_numpy(out.color), want_color, rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL)
    for name, g, w in zip(PARAM_NAMES, grads, want_grads):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(to_numpy(g), w, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=name)


def test_bench_cli_on_cpu_prints_the_line():
    """``python -m gaussiansplattingmlx_tpu_torch.bench --device cpu`` at
    the toy size: the last line has the keys, no overflow, "cpu" and null
    timings; an earlier line names the launches (none: plain versions)."""
    proc = subprocess.run(
        [sys.executable, "-m", "gaussiansplattingmlx_tpu_torch.bench", *TOY_ARGV,
         "--iters", "2", "--repeats", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == LINE_KEYS
    assert line["overflow_pairs"] == 0 and line["num_pairs"] > 0
    assert line["max_pairs"] == bench.pair_budget(line["num_pairs"], 128)
    assert line["device"] == "cpu" and line["power_limit_w"] == "not read"
    assert line["value"] is None and line["step_ms"] is None
    assert line["device_ms_median"] is None
    assert line["metric"] == "fwd+bwd pixels/s/chip (64x64, 400 gaussians, SH3)"
    assert (line["tile"], line["repeats"], line["iters"], line["seed"]) == (16, 2, 2, 0)
    assert np.isfinite(line["loss"])
    launches = json.loads(next(ln for ln in lines if ln.startswith("kernel launches: "))
                          .split(": ", 1)[1])
    assert launches["steps"] == 4 and set(launches["total"].values()) == {0}
    assert "losses: 5 steps bit-identical" in lines


def test_bench_defaults_and_no_cpu_fallback(monkeypatch):
    """bench.py's defaults; the default device is cuda, and without a CUDA
    device the bench raises instead of running on the CPU."""
    args = bench.parse_args([])
    assert (args.size, args.gaussians, args.sh_degree, args.tile, args.chunk, args.max_pairs,
            args.iters, args.repeats, args.seed, args.device) == (
        800, 100_000, 3, 32, 128, None, 10, 5, 0, "cuda")
    assert bench.metric_name(800, 100_000, 3) == (
        "fwd+bwd pixels/s/chip (800x800, 100k gaussians, SH3)")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TOY_ARGV)
