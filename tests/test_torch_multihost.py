"""The port's multi-host layer (``gaussiansplattingmlx_tpu_torch/parallel/
multihost.py``) and the train CLI's ``--data-parallel`` / ``--multihost``:
the view-store helpers against the JAX package's on plain numpy, the
batched-views step against the index step for the same chosen views (the
JAX package's bars, tests/test_multihost.py), and ``train_cli`` starting
its own ranks on the CPU (gloo) or joining a group from torchrun's
variables: only rank 0 prints and writes, and a resume is bit-identical."""

import csv
import functools
import json

import numpy as np
import pytest
import torch

from test_cli import CONFIG, write_scene
from test_torch_parallel import SPAWN, port_cfg, scene  # noqa: F401
from test_train_smoke import H, W
import torch_parallel_workers as workers

from gaussiansplattingmlx_tpu.parallel import multihost as jax_multihost
from gaussiansplattingmlx_tpu_torch import train_cli
from gaussiansplattingmlx_tpu_torch.parallel import launch, multihost, sharding

ITERS = 6


@pytest.mark.parametrize("num_views,process_count", [(10, 4), (7, 1), (8, 2), (3, 5)])
def test_local_view_range_matches_jax(num_views, process_count):
    parts = [multihost.local_view_range(num_views, pi, process_count)
             for pi in range(process_count)]
    for pi, got in enumerate(parts):
        want = jax_multihost.local_view_range(num_views, pi, process_count)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
    assert {len(p) for p in parts} == {-(-num_views // process_count)}
    assert set(np.concatenate(parts).tolist()) == set(range(num_views))


def test_sample_and_select_local_batch_match_jax():
    """The same seeded stream draws the same host-local ids, and the same
    rows come out of a host's store."""
    local = np.array([2, 5, 7])
    got = multihost.sample_local_view_ids(np.random.default_rng(0), local, 64)
    want = jax_multihost.sample_local_view_ids(np.random.default_rng(0), local, 64)
    assert got.tolist() == want.tolist() and set(got.tolist()) <= {2, 5, 7}
    store = {"a": np.arange(3 * 4, dtype=np.float32).reshape(3, 4),
             "b": np.arange(3, dtype=np.float32)}
    chosen = got[:5]
    g = multihost.select_local_batch(store, local, chosen)
    w = jax_multihost.select_local_batch(store, local, chosen)
    for k in store:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_single_process_degenerates(monkeypatch):
    """Without torchrun's variables nothing is joined: one host, every view
    local, a 1 x 1 mesh whose collectives are no-ops."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert (multihost.host_index(), multihost.host_count()) == (0, 1)
    assert multihost.local_view_range(5).tolist() == list(range(5))
    mesh = multihost.data_process_mesh()
    assert mesh.shape == {"data": 1, "tile": 1} and mesh.group is None
    assert multihost.local_data_shards(mesh)[0].tolist() == [0]
    x = torch.ones(3)
    assert sharding.all_reduce(x, mesh.data_group, mesh) is x and mesh.collective_calls == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        sharding.make_mesh(2, 1)


def test_batched_step_matches_idx_step(scene):  # noqa: F811
    """Two ranks, each with a store of only its host's 4 views
    (local_view_range): the batched step on chosen views (3, 6) equals the
    index step on the replicated store, at the JAX package's bars
    (tests/test_multihost.py::test_batched_step_matches_idx_step)."""
    chosen = [3, 6]
    runs = [("index", 2, 1, chosen, None), ("batched", 2, 1, None, chosen)]
    out, reports = launch.spawn(workers.steps, 2, args=(
        port_cfg(), W, H, scene["views_np"], scene["state_np"], runs), **SPAWN)
    a, b = out["index"], out["batched"]
    np.testing.assert_allclose(a["metrics"]["loss"], b["metrics"]["loss"], rtol=1e-6)
    np.testing.assert_allclose(a["state"]["param_xyz"], b["state"]["param_xyz"], rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(a["state"]["grad_accum"], b["state"]["grad_accum"], rtol=1e-5,
                               atol=1e-10)
    np.testing.assert_array_equal(a["image"], b["image"])
    assert all(n == 0 for r in reports for n in r["launches"].values())  # CPU: no kernels


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """tests/test_cli.py's Blender fixture (4 views 32x24) and a config
    from its CONFIG: logs at 2, 4, 6, snapshots and checkpoints at 3 and 6,
    a pair budget that no step overflows."""
    root = tmp_path_factory.mktemp("mh_scene")
    write_scene(root, np.random.default_rng(0), n_images=4)
    cfg = {**CONFIG, "raster": {**CONFIG["raster"], "backend": "auto", "max_pairs": 16384},
           "snapshot_interval": 3, "checkpoint_interval": 3, "preview_interval": 100}
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root


def _argv(root, out, *extra):
    return ["--dataset", "blender", "--root", str(root), "--output", str(out),
            "--config", str(root / "cfg.json"), "--iterations", str(ITERS),
            "--sh-degree", "1", "--resize-factor", "1.0", "--device", "cpu", *extra]


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _written_once(out, res, text):
    """One writer: each log line, the final line and each metrics row once."""
    assert text.count("final:") == 1
    assert len([ln for ln in text.splitlines() if ln.startswith("iter ")]) == len(res.history)
    assert [int(r["iteration"]) for r in _rows(out / "metrics.csv")] == \
        [m["iteration"] for m in res.history]
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["config.json", "metrics.csv", "metrics.jsonl", "loss_curve.png", "ckpt_3.npz",
         "ckpt_6.npz", "iteration_3.ply", "iteration_6.ply"])


def test_train_cli_data_parallel_writes_once_and_resumes(cli_scene, tmp_path, capfd,
                                                         monkeypatch):
    """--data-parallel 2 --device cpu: main starts two ranks over gloo, which
    train replicated (bit-identical digests); only rank 0 prints and writes;
    a resume from ckpt_3 writes a ckpt_6 bit-identical to the whole run's."""
    monkeypatch.setattr(launch, "spawn", functools.partial(
        launch.spawn, pg_timeout=SPAWN["pg_timeout"], timeout=SPAWN["timeout"]))
    out = tmp_path / "run"
    res = train_cli.main(_argv(cli_scene, out, "--data-parallel", "2"))
    text = capfd.readouterr().out
    assert "2 ranks share device cpu" in text and "views replicated" in text
    assert res.trainer is None and res.final["iteration"] == ITERS
    assert [m["iteration"] for m in res.history] == [2, 4, 6]
    assert all(np.isfinite(m["loss"]) and m["overflow_pairs"] == 0 for m in res.history)
    assert len(res.ranks) == 2 and res.ranks[0]["digest"] == res.ranks[1]["digest"]
    assert all(r["steps"] == ITERS and r["collective_calls"] > 0 for r in res.ranks)
    _written_once(out, res, text)

    resumed = tmp_path / "resumed"
    res2 = train_cli.main(_argv(cli_scene, resumed, "--data-parallel", "2",
                                "--resume", str(out / "ckpt_3.npz")))
    assert "resumed from" in capfd.readouterr().out
    assert res2.ranks[0]["digest"] == res.ranks[0]["digest"]
    with np.load(out / f"ckpt_{ITERS}.npz") as a, np.load(resumed / f"ckpt_{ITERS}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == "config_json":
                ca, cb = (json.loads(bytes(z[k])) for z in (a, b))
                ca.pop("output_dir"), cb.pop("output_dir")
                assert ca == cb
            else:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_train_cli_multihost_from_torchrun_variables(cli_scene, tmp_path, capfd):
    """--multihost in two ranks that each see themselves as one host of two
    (torchrun's variables: LOCAL_WORLD_SIZE 1, MASTER_ADDR / MASTER_PORT):
    each joins the group itself, the default 1 x 1 config spans both ranks,
    each keeps a batched store of its own shard's views, and only rank 0
    writes."""
    out = tmp_path / "mh"
    res, reports = launch.spawn(
        train_cli._rank_main, 2, args=(_argv(cli_scene, out, "--multihost"),),
        init_group=False, env={"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, **SPAWN)
    text = capfd.readouterr().out
    assert "'data': 2, 'tile': 1} over 2 ranks, views batched" in text
    assert reports[0]["digest"] == reports[1]["digest"]
    assert all(np.isfinite(m["loss"]) and m["overflow_pairs"] == 0 for m in res.history)
    _written_once(out, res, text)
