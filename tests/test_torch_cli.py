"""The port's train and eval CLIs against the JAX package's train.py and
eval.py (run as subprocesses with the reference backend) on
tests/test_cli.py's Blender fixture and config: the same files, the same
metrics.csv columns, the logged losses and PSNRs within the step-parity
tolerance, the eval metrics within stated tolerances, also with the port's
--backend reference; a bit-exact resume; the flags' error paths; and that
no module of the port imports JAX, the JAX package, matplotlib, or Pillow
outside the JPEG branch."""

import csv
import json
import re
import urllib.error
from pathlib import Path

import numpy as np
import pytest
import torch

from test_cli import CONFIG, run_cli, write_scene

from gaussiansplattingmlx_tpu_torch import eval_cli, train_cli
from gaussiansplattingmlx_tpu_torch.data import fetch
from gaussiansplattingmlx_tpu_torch.data.fetch import FetchError
from gaussiansplattingmlx_tpu_torch.utils.png import read_png

PORT = Path(__file__).resolve().parents[1] / "gaussiansplattingmlx_tpu_torch"
ITERS = 6
# tests/test_torch_train_loop.py's step-parity tolerance.
LOSS_RTOL = 1e-4
PSNR_ATOL_DB, SSIM_ATOL, L1_ATOL = 0.01, 1e-4, 1e-5


def train_args(scene, out, cfg_path, *extra):
    return ["--dataset", "blender", "--root", str(scene), "--output", str(out),
            "--config", str(cfg_path), "--iterations", str(ITERS), "--sh-degree", "1",
            "--resize-factor", "1.0", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The Blender fixture trained by both CLIs: JAX with CONFIG (backend
    "reference"), the port with CONFIG's backend left at "auto"."""
    scene = tmp_path_factory.mktemp("scene")
    write_scene(scene, np.random.default_rng(0))
    jax_cfg = scene / "cfg_jax.json"
    jax_cfg.write_text(json.dumps(CONFIG))
    port_cfg = scene / "cfg_port.json"
    port_cfg.write_text(json.dumps({**CONFIG, "raster": {**CONFIG["raster"], "backend": "auto"}}))
    jax_out = tmp_path_factory.mktemp("jax_out")
    r = run_cli("train.py", *train_args(scene, jax_out, jax_cfg))
    assert r.returncode == 0, r.stderr[-3000:]
    port_out = tmp_path_factory.mktemp("port_out")
    res = train_cli.main(train_args(scene, port_out, port_cfg, "--device", "cpu"))
    return scene, jax_out, port_out, port_cfg, res


def read_csv(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def listing(out: Path):
    return sorted(p.relative_to(out).as_posix() for p in out.rglob("*"))


def test_train_cli_matches_jax(runs, capsys):
    scene, jax_out, port_out, _, res = runs
    assert listing(port_out) == listing(jax_out)
    jax_header, jax_rows = read_csv(jax_out / "metrics.csv")
    port_header, port_rows = read_csv(port_out / "metrics.csv")
    assert port_header == jax_header
    assert [r["iteration"] for r in port_rows] == [r["iteration"] for r in jax_rows]
    for p, j in zip(port_rows, jax_rows):
        for key in ("loss", "psnr"):
            np.testing.assert_allclose(float(p[key]), float(j[key]), rtol=LOSS_RTOL)
    assert res.output_dir == port_out and res.final["iteration"] == ITERS
    assert res.final["loss"] == pytest.approx(float(port_rows[-1]["loss"]))
    assert int(res.trainer.state.step) == ITERS
    curve = read_png(port_out / "loss_curve.png")
    assert curve.shape == (400, 800, 3) and curve.dtype == np.uint8
    assert len(np.unique(curve.reshape(-1, 3), axis=0)) >= 3  # lines in two colours


def test_train_cli_resume_is_bit_exact(runs, tmp_path, capsys):
    scene, _, port_out, port_cfg, _ = runs
    res = train_cli.main(train_args(scene, tmp_path, port_cfg, "--device", "cpu",
                                    "--resume", str(port_out / "ckpt_5.npz")))
    assert "resumed from" in capsys.readouterr().out
    assert int(res.trainer.state.step) == ITERS
    with np.load(port_out / f"ckpt_{ITERS}.npz") as a, np.load(tmp_path / f"ckpt_{ITERS}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == "config_json":  # the configs differ in output_dir only
                ca, cb = (json.loads(bytes(z[k])) for z in (a, b))
                assert ca["output_dir"] != cb["output_dir"]
                ca.pop("output_dir"), cb.pop("output_dir")
                assert ca == cb
            else:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    header, rows = read_csv(tmp_path / "metrics.csv")
    assert [r["iteration"] for r in rows] == [str(ITERS)]


def test_train_cli_reference_backend_matches_jax(runs, tmp_path, capsys):
    """train_cli --backend reference (the oracle) against train.py with the
    reference backend: the same files and metrics columns, the logged losses
    and PSNRs within the step-parity tolerance."""
    scene, jax_out, _, port_cfg, _ = runs
    res = train_cli.main(train_args(scene, tmp_path, port_cfg, "--device", "cpu",
                                    "--backend", "reference"))
    assert res.trainer.backend == "reference"
    # The run records the rasterizer it used, so a re-run from config.json
    # or a resume keeps it.
    assert json.loads((tmp_path / "config.json").read_text())["raster"]["backend"] == "reference"
    with np.load(tmp_path / f"ckpt_{ITERS}.npz") as ckpt:
        assert json.loads(bytes(ckpt["config_json"]))["raster"]["backend"] == "reference"
    assert listing(tmp_path) == listing(jax_out)
    jax_header, jax_rows = read_csv(jax_out / "metrics.csv")
    port_header, port_rows = read_csv(tmp_path / "metrics.csv")
    assert port_header == jax_header
    assert [r["iteration"] for r in port_rows] == [r["iteration"] for r in jax_rows]
    for p, j in zip(port_rows, jax_rows):
        for key in ("loss", "psnr"):
            np.testing.assert_allclose(float(p[key]), float(j[key]), rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def jax_eval(runs):
    """eval.py --backend reference on the port's final PLY: (its argv
    without the backend, its JSON metrics)."""
    scene, _, port_out, _, _ = runs
    ply = port_out / f"iteration_{ITERS}.ply"
    args = ["--dataset", "blender", "--root", str(scene), "--ply", str(ply),
            "--resize-factor", "1.0", "--max-pairs", "8192"]
    r = run_cli("eval.py", *args, "--backend", "reference")
    assert r.returncode == 0, r.stderr[-3000:]
    return args, json.loads(r.stdout.strip().splitlines()[-1])


def check_eval_metrics(got, want):
    assert sorted(got) == sorted(want)
    assert got["views"] == want["views"] == 3 and got["view_ids"] == want["view_ids"]
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= PSNR_ATOL_DB
    assert abs(got["ssim_mean"] - want["ssim_mean"]) <= SSIM_ATOL
    assert abs(got["l1_mean"] - want["l1_mean"]) <= L1_ATOL


def test_eval_cli_matches_jax(jax_eval, tmp_path, capsys):
    args, want = jax_eval
    res = eval_cli.main([*args, "--device", "cpu", "--save-renders", str(tmp_path)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == res.metrics
    check_eval_metrics(got, want)
    assert res.overflow_pairs == [0, 0, 0] and all(n > 0 for n in res.num_pairs)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "eval_000.png", "eval_001.png", "eval_002.png"]
    assert read_png(tmp_path / "eval_000.png").shape == (24, 32, 3)


def test_eval_cli_reference_backend_matches_jax(jax_eval, capsys):
    """eval_cli --backend reference against eval.py --backend reference."""
    args, want = jax_eval
    res = eval_cli.main([*args, "--device", "cpu", "--backend", "reference"])
    check_eval_metrics(res.metrics, want)
    assert res.overflow_pairs == [0, 0, 0] and all(n > 0 for n in res.num_pairs)


@pytest.mark.parametrize("extra,error,match", [
    # --fetch-demo without network access (the download fails here at once).
    pytest.param(["--fetch-demo", "lego"], FetchError, "could not download", id="extra0-A.5"),
    # The parallel flags: torchrun's variables in part, and more ranks than
    # the one card visible with a bare --device cuda.
    pytest.param(["--multihost"], ValueError, "RANK.*torchrun", id="extra1-A.6"),
    pytest.param(["--data-parallel", "2", "--device", "cuda"], RuntimeError,
                 "2 ranks need 2 cards", id="extra2-A.6"),
    pytest.param(["--tile-parallel", "4", "--device", "cuda"], RuntimeError,
                 "4 ranks need 4 cards", id="extra3-A.6"),
    # A backend name that does not exist.
    pytest.param(["--backend", "triton"], ValueError, "unknown rasterizer backend",
                 id="extra4-A.8"),
])
def test_train_cli_unported_flags_raise(tmp_path, monkeypatch, extra, error, match):
    """Flags raise on what they cannot run, before anything is written.
    (The ids name the ROADMAP.md items of the flags, which were unported
    when the cases were written: --fetch-demo and --backend reference now
    run, tests/test_torch_native_io.py and
    test_train_cli_reference_backend_matches_jax.)"""
    if "--multihost" in extra:
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.delenv("RANK", raising=False)

    def offline(url, timeout):
        raise urllib.error.URLError("no network in the test")

    monkeypatch.setattr(fetch.urllib.request, "urlopen", offline)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(error, match=match):
        train_cli.main(["--dataset", "colmap", "--root", str(tmp_path / "missing"),
                        "--output", str(tmp_path / "out"), "--device", "cpu", *extra])
    assert not (tmp_path / "out").exists()


def test_eval_cli_reference_backend_raises(tmp_path):
    """eval_cli takes --backend reference (test_eval_cli_reference_backend_
    matches_jax runs it); what raises here is the missing scene, and an
    unknown backend raises before the scene is read."""
    argv = ["--dataset", "colmap", "--root", str(tmp_path), "--ply", "x.ply",
            "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="cameras.bin"):
        eval_cli.main([*argv, "--backend", "reference"])
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        eval_cli.main([*argv, "--backend", "triton"])


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_cli_default_device_is_cuda(runs, tmp_path, monkeypatch, cli):
    """The CLIs run on cuda unless told otherwise; without a CUDA device
    that is an error, not a CPU run."""
    scene, _, port_out, port_cfg, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli == "train":
            train_cli.main(train_args(scene, tmp_path, port_cfg))
        else:
            eval_cli.main(["--dataset", "blender", "--root", str(scene), "--ply",
                           str(port_out / f"iteration_{ITERS}.ply")])


FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|PIL|matplotlib|gaussiansplattingmlx_tpu)(?:\.|\s|$)", re.M)


def test_port_imports_no_jax_pillow_or_matplotlib():
    """No module of the port imports JAX, the JAX package or matplotlib;
    Pillow only inside read_image's JPEG branch."""
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
        if hits:
            found[path.relative_to(PORT).as_posix()] = hits
    assert found == {"utils/png.py": ["from PIL"]}
    src = (PORT / "utils" / "png.py").read_text()
    branch = src[src.index("def read_image"):src.index("def _bilinear_coeffs")]
    assert "from PIL import Image" in branch and 'b"\\xff\\xd8"' in branch
