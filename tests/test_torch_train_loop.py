"""The port's Trainer through densify, prune-only and opacity-reset rounds,
capacity growth, previews, snapshots and checkpoints: the whole loop
against the JAX package's Trainer (same initial state, same densify draws,
same camera sequence), checkpoints that cross between the packages, and a
bit-exact resume in the port."""

import dataclasses
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import CHUNK, TILE, assert_normal_matches, to_numpy

from gaussiansplattingmlx_tpu import config as jax_config
from gaussiansplattingmlx_tpu.data.dataset import TrainData as JaxTrainData
from gaussiansplattingmlx_tpu.train import checkpoint as jax_checkpoint
from gaussiansplattingmlx_tpu.train import trainer as jax_trainer
from gaussiansplattingmlx_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud as JaxPointCloud
from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data import ply
from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import checkpoint, trainer
from gaussiansplattingmlx_tpu_torch.utils import prng
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera
from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud

W = H = 48
RASTER = dict(tile_h=TILE, tile_w=TILE, max_pairs=4096, chunk_size=CHUNK)
STATS = ("num_active", "n_keep", "n_split", "n_clone", "n_prune")


def _orbit_c2w(n_views, radius=4.0):
    out = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([radius * np.sin(ang), 0.3, -radius * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, pos
        out.append(c2w)
    return out


@pytest.fixture(scope="module")
def scene():
    """tests/test_train_smoke.py's scene: 60 solid gaussians rendered from 6
    orbit views by the port's inference path; the cloud to train from is
    the points with noise."""
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(60, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(60, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=0, capacity=60,
                                              device="cpu")
    with torch.no_grad():
        params.scales.fill_(float(np.log(0.15)))
        params.opacity.fill_(2.0)
    c2ws = _orbit_c2w(6)
    raster = config.RasterizerConfig(**RASTER)
    images = []
    for c2w in c2ws:
        t = Camera.from_c2w(W, H, 50.0, 50.0, c2w).tensors()
        m, s, o, sc, r = gaussians.activations(params)
        out, _ = render(m, s, o, sc, r, *(torch.as_tensor(t[k]) for k in
                                          ("view", "proj", "camera_center")),
                        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], W, H, 0,
                        raster_cfg=raster, inference=True)
        images.append(to_numpy(out.color))
    noisy = pts + np.random.default_rng(1).normal(size=pts.shape).astype(np.float32) * 0.05
    return noisy, cols, c2ws, np.stack(images).astype(np.float32)


def _port_trainer(scene, **kw):
    pts, cols, c2ws, images = scene
    base = dict(init_points=60, log_interval=1, snapshot_interval=10 ** 9,
                checkpoint_interval=0, output_dir="", early_stop_loss=1e-7,
                model=config.ModelConfig(sh_degree=0, initial_capacity=64),
                raster=config.RasterizerConfig(**RASTER),
                densify=config.DensifyConfig(from_iter=10 ** 9))
    base.update(kw)
    cams = [Camera.from_c2w(W, H, 50.0, 50.0, c) for c in c2ws]
    return trainer.Trainer(config.TrainConfig(**base), TrainData(cams, images),
                           PointCloud(pts, cols * 255.0), device="cpu")


def _jax_trainer(scene, **kw):
    pts, cols, c2ws, images = scene
    base = dict(init_points=60, log_interval=1, snapshot_interval=10 ** 9,
                checkpoint_interval=0, output_dir="", early_stop_loss=1e-7,
                model=jax_config.ModelConfig(sh_degree=0, initial_capacity=64),
                raster=jax_config.RasterizerConfig(**RASTER),
                densify=jax_config.DensifyConfig(from_iter=10 ** 9))
    base.update(kw)
    cams = [JaxCamera.from_c2w(W, H, 50.0, 50.0, c) for c in c2ws]
    return jax_trainer.Trainer(jax_config.TrainConfig(**base), JaxTrainData(cams, images),
                               JaxPointCloud(pts, cols * 255.0), backend="reference")


# The whole-loop test: 30 of the 60 points in 32 slots (the first round
# grows them to 64), densify rounds at 3 and 6, prune-only at 9.  The
# thresholds were searched so that every live row's mean gradient, largest
# scale and opacity sit at least 1% from them in every round of both runs
# (asserted), while the rounds split, clone and prune.
LOOP_DENSIFY = dict(interval=3, from_iter=3, until_iter=6, prune_until_iter=9,
                    grad_threshold=8.020e-4, max_scale=0.4097, min_opacity=0.1156)
LOOP_MODEL = dict(sh_degree=0, initial_capacity=32)


def _margins(avg, max_scale, op):
    d = LOOP_DENSIFY
    return min(float(np.min(np.abs(v / t - 1.0))) for v, t in
               ((avg, d["grad_threshold"]), (max_scale, d["max_scale"]),
                (op, d["min_opacity"])))


def test_trainer_densify_rounds_match_jax(scene):
    """Two densify rounds and a prune-only round, a capacity growth, ten
    logged steps: the port's Trainer against the JAX package's, from the
    JAX trainer's initial state, each drawing its own densify noise (the
    same stream: one split of ``PRNGKey(seed)`` a round)."""
    iters = 10
    jt = _jax_trainer(scene, iterations=iters, init_points=30,
                      model=jax_config.ModelConfig(**LOOP_MODEL),
                      densify=jax_config.DensifyConfig(**LOOP_DENSIFY))
    tt = _port_trainer(scene, iterations=iters, init_points=30,
                       model=config.ModelConfig(**LOOP_MODEL),
                       densify=config.DensifyConfig(**LOOP_DENSIFY))
    # The same initial state (the two kNN initialisations agree to ~1e-5).
    tt.state = trainer.state_from_numpy(_jax_state_arrays(jt.state), "cpu")

    rounds = {"jax": [], "port": []}

    def record(fn, side, host):
        def step(state, arg):
            n = int(state.num_active)
            avg = host(state.grad_accum)[:n] / float(state.grad_denom)
            max_scale = np.exp(host(state.params.scales)[:n]).max(axis=1)
            op = 1.0 / (1.0 + np.exp(-host(state.params.opacity)[:n, 0]))
            state, stats = fn(state, arg)
            rounds[side].append(([int(getattr(stats, k)) for k in STATS],
                                 _margins(avg, max_scale, op), state.params.capacity))
            return state, stats
        return step

    jt.densify_step = record(jt.densify_step, "jax", np.asarray)
    jt.prune_step = record(jt.prune_step, "jax", np.asarray)
    tt.densify_step = record(tt.densify_step, "port", to_numpy)
    tt.prune_step = record(tt.prune_step, "port", to_numpy)
    jlog, tlog = [], []
    jt.run(on_metrics=jlog.append)
    tt.run(on_metrics=tlog.append)

    assert len(rounds["jax"]) == len(rounds["port"]) == 3
    np.testing.assert_array_equal(tt.key, np.asarray(jt.key))  # three splits each
    for (js, jm, jcap), (ts, tm, tcap) in zip(rounds["jax"], rounds["port"]):
        assert js == ts and jcap == tcap
        assert jm >= 0.01 and tm >= 0.01, (jm, tm)
    split = sum(r[0][2] for r in rounds["port"])
    clone = sum(r[0][3] for r in rounds["port"])
    prune = sum(r[0][4] for r in rounds["port"])
    assert split > 0 and clone > 0 and prune > 0
    assert rounds["port"][2][0][2:4] == [0, 0]  # the prune-only round
    assert tt.state.params.capacity == jt.state.params.capacity == 64  # grown from 32
    assert [m["iteration"] for m in tlog] == list(range(1, iters + 1))
    assert [m["num_active"] for m in tlog] == [m["num_active"] for m in jlog]
    for key in ("loss", "l1", "psnr"):
        np.testing.assert_allclose([m[key] for m in tlog], [m[key] for m in jlog], rtol=1e-4,
                                   err_msg=key)


def _jax_state_arrays(state) -> dict:
    """A JAX TrainState as numpy arrays under its checkpoint keys."""
    p, m, v = (jax.device_get(x) for x in (state.params, state.opt.m, state.opt.v))
    out = {}
    for n in gaussians.PARAM_NAMES:
        out[f"param_{n}"] = np.asarray(getattr(p, n))
        out[f"adam_m_{n}"] = np.asarray(getattr(m, n))
        out[f"adam_v_{n}"] = np.asarray(getattr(v, n))
    for key, value in (("adam_count", state.opt.count), ("num_active", state.num_active),
                       ("grad_accum", state.grad_accum), ("grad_denom", state.grad_denom),
                       ("step", state.step), ("overflow_acc", state.overflow_acc)):
        out[key] = np.asarray(value)
    return out


# --- persistence ---------------------------------------------------------------

# With LOOP_MODEL: rounds at 2 (densify off by the capacity guard, then
# growth to 64 slots) and 4 (splits and clones), an opacity reset at 4,
# prune-only at 6.
PERSIST_DENSIFY = dict(interval=2, from_iter=2, until_iter=5, prune_until_iter=7,
                       opacity_reset_interval=4, grad_threshold=1.5e-3, max_scale=0.41)


def _read_png(path) -> np.ndarray:
    """Decode an 8-bit RGB PNG whose rows all use filter 0 (as
    ``utils.png.write_png`` writes them)."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
            assert body[8:10] == b"\x08\x02"  # 8-bit RGB
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_jax_checkpoint_loads_in_port(scene, tmp_path, capsys):
    jt = _jax_trainer(scene, iterations=6, init_points=30, output_dir=str(tmp_path),
                      model=jax_config.ModelConfig(**LOOP_MODEL),
                      densify=jax_config.DensifyConfig(**PERSIST_DENSIFY))
    jt.run(iterations=3)
    jt.save_checkpoint(3)
    path = tmp_path / "ckpt_3.npz"
    state, host_rng, key = checkpoint.load(path, "cpu")
    np.testing.assert_array_equal(key, np.asarray(jt.key))  # split once, at step 2
    got, want = trainer.state_to_numpy(state), _jax_state_arrays(jt.state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert state.params.capacity == 64  # grown at the round of step 2
    assert host_rng.integers(0, 1 << 30, size=8).tolist() == \
        jt.rng.integers(0, 1 << 30, size=8).tolist()
    assert dataclasses.asdict(checkpoint.load_config(path)) == dataclasses.asdict(jt.cfg)

    tt = _port_trainer(scene, iterations=6, init_points=30,
                       model=config.ModelConfig(**LOOP_MODEL),
                       densify=config.DensifyConfig(**PERSIST_DENSIFY))
    tt.restore_checkpoint(path)
    assert "will not replay" not in capsys.readouterr().err
    assert int(tt.state.step) == 3
    # The port's next densify draw is the JAX trainer's.
    restored = tt.key.copy()
    draw = tt.densify_noise(tt.state.params.capacity)
    assert_normal_matches(draw, jax.random.normal(jt.next_key(), (64, 3), jnp.float32))
    np.testing.assert_array_equal(tt.key, np.asarray(jt.key))
    tt.key = restored
    log = []
    tt.run(on_metrics=log.append)
    assert [m["iteration"] for m in log] == [4, 5, 6]
    assert all(np.isfinite(m["loss"]) for m in log)


def test_port_checkpoint_loads_in_jax(scene, tmp_path):
    tt = _port_trainer(scene, iterations=6, init_points=30, output_dir=str(tmp_path),
                       model=config.ModelConfig(**LOOP_MODEL),
                       densify=config.DensifyConfig(**PERSIST_DENSIFY))
    tt.run(iterations=3)
    assert tt.state.params.capacity == 64  # grown at the round of step 2
    tt.save_checkpoint(3)
    path = tmp_path / "ckpt_3.npz"
    state, host_rng, jax_key = jax_checkpoint.load(path)
    np.testing.assert_array_equal(np.asarray(jax_key), tt.key)
    got, want = _jax_state_arrays(state), trainer.state_to_numpy(tt.state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert host_rng.integers(0, 1 << 30, size=8).tolist() == \
        tt.rng.integers(0, 1 << 30, size=8).tolist()
    assert dataclasses.asdict(jax_checkpoint.load_config(path)) == dataclasses.asdict(tt.cfg)


def test_port_checkpoint_key_resumes_jax_noise(scene, tmp_path):
    """The JAX trainer resuming a port checkpoint adopts the port's key (two
    rounds in) and draws the port's next densify noise."""
    tt = _port_trainer(scene, iterations=6, init_points=30, output_dir=str(tmp_path),
                       model=config.ModelConfig(**LOOP_MODEL),
                       densify=config.DensifyConfig(**PERSIST_DENSIFY))
    tt.run(iterations=5)
    tt.save_checkpoint(5)
    np.testing.assert_array_equal(tt.key, prng.split(prng.split(prng.prng_key(0))[0])[0])
    jt = _jax_trainer(scene, iterations=6, init_points=30,
                      model=jax_config.ModelConfig(**LOOP_MODEL),
                      densify=jax_config.DensifyConfig(**PERSIST_DENSIFY))
    jt.restore_checkpoint(str(tmp_path / "ckpt_5.npz"))
    np.testing.assert_array_equal(np.asarray(jt.key), tt.key)
    cap = tt.state.params.capacity
    assert_normal_matches(tt.densify_noise(cap),
                          jax.random.normal(jt.next_key(), (cap, 3), jnp.float32))


def test_checkpoint_without_key_restarts_from_seed(scene, tmp_path, capsys):
    """A port checkpoint written before the key was kept (no ``jax_key``)
    still loads; the key restarts from the seed and a NOTE says the noise
    will not replay."""
    tt = _port_trainer(scene, iterations=4, init_points=30, output_dir=str(tmp_path),
                       model=config.ModelConfig(**LOOP_MODEL),
                       densify=config.DensifyConfig(**PERSIST_DENSIFY))
    tt.run(iterations=3)
    tt.save_checkpoint(3)
    with np.load(tmp_path / "ckpt_3.npz") as z:
        old = {k: z[k] for k in z.files if k != "jax_key"}
    np.savez(tmp_path / "old.npz", **old)
    state, host_rng, key = checkpoint.load(tmp_path / "old.npz", "cpu")
    assert key is None and host_rng is not None and int(state.step) == 3
    resumed = _port_trainer(scene, iterations=4, init_points=30,
                            model=config.ModelConfig(**LOOP_MODEL),
                            densify=config.DensifyConfig(**PERSIST_DENSIFY))
    resumed.next_key()
    resumed.restore_checkpoint(tmp_path / "old.npz")
    assert "the noise will not replay" in capsys.readouterr().err
    np.testing.assert_array_equal(resumed.key, prng.prng_key(resumed.cfg.seed))
    resumed.run()
    assert int(resumed.state.step) == 4


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_checkpoint_key_impl(scene, tmp_path, impl):
    """A typed JAX key loads when its impl is threefry2x32 (its key data);
    any other impl raises, naming it."""
    jt = _jax_trainer(scene, iterations=1, init_points=30)
    typed = jax.random.key(5, impl=impl)
    jax_checkpoint.save(tmp_path / "c.npz", jt.state, jax_key=typed)
    if impl == "threefry2x32":
        _, _, key = checkpoint.load(tmp_path / "c.npz", "cpu")
        np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(typed)))
        np.testing.assert_array_equal(key, prng.prng_key(5))
    else:
        with pytest.raises(ValueError, match="rbg"):
            checkpoint.load(tmp_path / "c.npz", "cpu")


def test_resume_bit_equivalence(scene, tmp_path):
    """A checkpoint at step 3 and 4 more steps == 7 uninterrupted steps, bit
    for bit: parameters, Adam state, counters, the logged losses and the
    densify noise stream, through densify, prune-only and opacity-reset
    rounds and a capacity growth (tests/test_train_smoke.py's resume test
    for the port)."""
    def make():
        return _port_trainer(scene, iterations=7, init_points=30, output_dir=str(tmp_path),
                             model=config.ModelConfig(**LOOP_MODEL),
                             densify=config.DensifyConfig(**PERSIST_DENSIFY))

    full = make()
    full.run()
    first = make()
    first.run(iterations=3)
    first.save_checkpoint(3)
    resumed = make()
    resumed.restore_checkpoint(tmp_path / "ckpt_3.npz")
    assert int(resumed.state.step) == 3
    resumed.run()

    assert full.state.params.capacity == resumed.state.params.capacity == 64
    assert int(full.state.num_active) > 30  # the round of step 4 split and cloned
    got, want = trainer.state_to_numpy(resumed.state), trainer.state_to_numpy(full.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tail = [(m["iteration"], m["loss"], m["num_active"]) for m in full.history[3:]]
    assert [(m["iteration"], m["loss"], m["num_active"]) for m in resumed.history] == tail
    np.testing.assert_array_equal(resumed.key, full.key)


def test_restore_adopts_larger_saved_max_pairs(scene, tmp_path):
    saved = _port_trainer(scene, iterations=2, output_dir=str(tmp_path),
                          raster=config.RasterizerConfig(**dict(RASTER, max_pairs=8192)))
    saved.state.overflow_acc.copy_(torch.tensor([5.0, 2.0]))
    saved.save_checkpoint(0)
    path = tmp_path / "ckpt_0.npz"

    smaller = _port_trainer(scene, iterations=2)
    step_before = smaller.train_step
    smaller.restore_checkpoint(path)
    assert smaller.cfg.raster.max_pairs == 8192 and smaller.train_step is not step_before
    assert smaller._overflow_handled == 5.0
    larger = _port_trainer(scene, iterations=2,
                           raster=config.RasterizerConfig(**dict(RASTER, max_pairs=16384)))
    larger.restore_checkpoint(path)
    assert larger.cfg.raster.max_pairs == 16384
    final = larger.run()
    assert final["overflow_pairs_acc"] == 5.0 and larger._overflow_handled == 5.0


def test_preview_and_snapshot_decode(scene, tmp_path):
    """The preview PNG decodes to the rendered image beside its target, the
    PLY snapshot to the live rows."""
    tt = _port_trainer(scene, iterations=2, output_dir=str(tmp_path), preview_interval=2,
                       snapshot_interval=2)
    seen = []
    step = tt.train_step

    def recording_step(state, views, view_idx):
        state, metrics, color = step(state, views, view_idx)
        seen.append((view_idx, to_numpy(color)))
        return state, metrics, color

    tt.train_step = recording_step
    tt.run()
    view_idx, color = seen[-1]
    png = _read_png(tmp_path / "previews" / f"iter_000002_v{view_idx}.png")
    rendered = np.clip(color * 255.0, 0, 255).astype(np.uint8)
    target = np.clip(scene[3][view_idx] * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(png, np.concatenate([rendered, target], axis=1))
    assert rendered.std() > 0

    snap = ply.read_gaussian_ply(tmp_path / "iteration_2.ply")
    n = int(tt.state.num_active)
    assert snap.xyz.shape == (n, 3)
    params = tt.state.params.to_numpy()
    for name in gaussians.PARAM_NAMES:
        np.testing.assert_array_equal(getattr(snap, name), params[name][:n], err_msg=name)
