"""The port's checkpoint tools against the JAX package's, on a checkpoint
that the port's Trainer wrote after a few steps on the vendored scene:
``scripts/torch_ckpt_to_ply.py`` writes the same PLY bytes as
``scripts/ckpt_to_ply.py``, and ``scripts/torch_diagnose_holdout.py
--device cpu`` prints the same ablations as ``scripts/diagnose_holdout.py``
with PSNRs within 1e-3 dB (the JAX script runs its oracle rasterizer off a
TPU, the port its kernels' plain versions)."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_cli import FORBIDDEN

from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.data import colmap
from gaussiansplattingmlx_tpu_torch.train import trainer

REPO = Path(__file__).resolve().parent.parent
VENDOR = REPO / "tests" / "fixtures" / "vendor_scene"
FACTOR = 0.25
MAX_PAIRS = 16384
VIEWS = "0,3,7"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """ckpt_2.npz and ckpt_4.npz of 4 steps at SH1 on the vendored scene at
    a quarter of its size (the cloud centred as train_cli centres it)."""
    out = tmp_path_factory.mktemp("ckpt")
    data, pcd = colmap.load_colmap(VENDOR, resize_factor=FACTOR)
    pcd, centroid = pcd.centering()
    data = data.shift_cameras(centroid)
    cfg = config.TrainConfig(
        iterations=4, init_points=1500, log_interval=1, snapshot_interval=10 ** 9,
        preview_interval=10 ** 9, checkpoint_interval=2, output_dir=str(out),
        model=config.ModelConfig(sh_degree=1, initial_capacity=2048),
        raster=config.RasterizerConfig(max_pairs=MAX_PAIRS, chunk_size=32),
        densify=config.DensifyConfig(from_iter=10 ** 9))
    trainer.Trainer(cfg, data, pcd, device="cpu").run()
    assert {p.name for p in out.glob("ckpt_*.npz")} == {"ckpt_2.npz", "ckpt_4.npz"}
    return out


def test_torch_ckpt_to_ply_writes_the_jax_scripts_bytes(ckpt_dir, tmp_path):
    mod = _script("torch_ckpt_to_ply")
    got = mod.main([str(ckpt_dir / "ckpt_2.npz"), "-o", str(tmp_path / "port.ply")])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "GSPLAT_PLATFORM": "cpu"}
    subprocess.run([sys.executable, str(REPO / "scripts" / "ckpt_to_ply.py"),
                    str(ckpt_dir / "ckpt_2.npz"), "-o", str(tmp_path / "jax.ply")],
                   check=True, env=env, capture_output=True, timeout=300)
    assert got.read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert len(got.read_bytes()) > 1500 * 4 * 23  # 23 floats a vertex at SH1
    # A directory takes its newest checkpoint, written beside it by default.
    newest = mod.main([str(ckpt_dir)])
    assert newest == ckpt_dir / "iteration_4.ply"
    assert newest.read_bytes() != got.read_bytes()


def test_torch_diagnose_holdout_matches_the_jax_script(ckpt_dir, monkeypatch, capsys):
    ckpt = str(ckpt_dir / "ckpt_4.npz")
    argv = [ckpt, "--dataset-root", str(VENDOR), "--views", VIEWS,
            "--resize-factor", str(FACTOR), "--max-pairs", str(MAX_PAIRS)]
    got = _script("torch_diagnose_holdout").main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out

    from gaussiansplattingmlx_tpu.ops import losses as jax_losses

    psnrs = []
    real = jax_losses.psnr
    monkeypatch.setattr(jax_losses, "psnr", lambda a, b: psnrs.append(float(real(a, b)))
                        or psnrs[-1])
    monkeypatch.setattr(sys, "argv", ["diagnose_holdout.py"] + argv)
    _script("diagnose_holdout").main()
    jax_out = capsys.readouterr().out

    views = len(VIEWS.split(","))
    want = np.array(psnrs).reshape(-1, views)
    assert list(got) == [ln[:28].rstrip() for ln in jax_out.splitlines()]
    np.testing.assert_allclose(np.array(list(got.values())), want, rtol=0, atol=1e-3)
    kept = re.compile(r"kept +(\d+)/(\d+)")
    assert kept.findall(port_out) == kept.findall(jax_out)
    assert port_out.splitlines()[1].startswith("non-finite rows: 0 of ")
    assert np.isfinite(want).all() and want.min() > 5.0
    # The ablations change the image: SH0 and the opacity culls move PSNR.
    assert len({round(float(v), 4) for v in want[:, 0]}) > 3


@pytest.mark.parametrize("path", ["scripts/torch_ckpt_to_ply.py",
                                  "scripts/torch_flagship_run.py",
                                  "scripts/torch_diagnose_holdout.py",
                                  "scripts/torch_find_nonfinite.py",
                                  "tests/torch_golden_scene.py"])
def test_torch_tools_import_no_jax(path):
    """The scripts and the golden scene's module run where JAX is not
    installed: they import neither JAX, the JAX package, Pillow nor
    matplotlib."""
    assert FORBIDDEN.findall((REPO / path).read_text()) == []


def _row(it, n, pairs, overflow, loss, budget):
    return {"iteration": it, "num_active": n, "num_pairs": pairs, "overflow_pairs": overflow,
            "loss": loss, "max_pairs": budget, "wall_s": float(it)}


def test_flagship_run_compares_two_logs(tmp_path, capsys):
    """``torch_flagship_run.py --compare``: two metrics.jsonl logs side by
    side at their shared iterations, with each side's spiking rows and first
    truncating row, overall and at its largest budget."""
    import json

    run = [_row(50, 100, 512, 10, 0.6, 1024), _row(100, 110, 600, 0, 0.2, 1024),
           _row(150, 120, 1024, 40, 0.3, 2048), _row(200, 130, 700, 0, 0.1, 2048)]
    ref = [_row(50, 100, 500, 0, 0.4, 1024), _row(150, 125, 1024, 5, 0.7, 1024),
           _row(200, 140, 1024, 90, 0.2, 1024), _row(250, 150, 800, 0, 0.1, 1024)]
    paths = []
    for name, rows in (("run", run), ("ref", ref)):
        paths.append(tmp_path / f"{name}.jsonl")
        paths[-1].write_text("".join(json.dumps(r) + "\n" for r in rows))
    table = _script("torch_flagship_run").main(["--compare", *map(str, paths)])["rows"]
    assert [c["iteration"] for c in table] == [50, 150, 200]
    assert table[0]["gaussians"] == (100, 100) and table[0]["demand"] == (522, 500)
    assert table[1]["demand"] == (1064, 1029) and table[1]["budget"] == (2048, 1024)
    assert [c["truncated"] for c in table] == [(True, False), (True, True), (False, True)]
    assert [c["spiked"] for c in table] == [(True, False), (False, True), (False, False)]
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + 3 + 2
    assert out[1].split()[:5] == ["50", "100", "100", "522", "500"]
    assert out[-2] == ("run: spiked rows [50]; first truncating row 50, "
                       "at the budget 2048: 150 (1 rows)")
    assert out[-1] == ("ref: spiked rows [150]; first truncating row 150, "
                       "at the budget 1024: 150 (2 rows)")


def _card_arms(script: str) -> dict:
    """The one-line arms of the card ``case`` in torch_c4_cards.sh:
    pattern -> the words of its command."""
    import shlex

    arms = {}
    for line in script.splitlines():
        m = re.match(r"^\s*([\w\[\]]+)\)\s*(train .*?)\s*&\s*;;\s*$", line)
        if m:
            arms[m.group(1)] = shlex.split(m.group(2))
    return arms


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_c4_cards_warmup_seeds(seed):
    """``torch_c4_cards.sh`` knows cards w0-w3: card c's flags (run (b) at
    the 2^24 limit) plus ``--sh-warmup 1000`` and the card's ``--seed``.
    The script is parsed, not run."""
    import fnmatch

    arms = _card_arms((REPO / "scripts" / "torch_c4_cards.sh").read_text())
    card = f"w{seed}"
    pattern = [p for p in arms if fnmatch.fnmatchcase(card, p)]
    assert len(pattern) == 1, (card, sorted(arms))
    words = [w.replace("${card#w}", card[1:]).replace("$card", card) for w in arms[pattern[0]]]
    assert words[:2] == ["train", card]
    base = arms["c"][2:]
    assert base == ["${RUN_B[@]}", "--max-pairs-limit", "16777216"]
    assert words[2:] == base + ["--sh-warmup", "1000", "--seed", str(seed)]
