"""The port's small training campaign (``gaussiansplattingmlx_tpu_torch/
train_synthetic.py``) against the JAX package's
``scripts/train_synthetic_tpu.py`` on the CPU with the same flags: the
ground-truth images and the logged loss and PSNR.  The JAX script runs in a
subprocess on ``--backend pallas_interpret``, through a wrapper that saves
the images it trains on and the metrics it logs (it writes neither)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussiansplattingmlx_tpu_torch import train_synthetic

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "train_synthetic_tpu.py"
ARGS = ["--iters", "50", "--views", "3", "--size", "32", "--gaussians", "300"]
# The JAX package's Pallas-vs-oracle colour bars (tests/torch_port_helpers.py
# assert_images_close) and tests/test_torch_train_loop.py's step parity.
IMAGE_RTOL, IMAGE_ATOL = 1e-4, 1e-5
ROW_RTOL = 1e-4

# Runs the JAX script unchanged, with its TrainData and Trainer wrapped to
# save the images and append each logged metrics dict to a file.
WRAPPER = r"""
import json, runpy, sys
import numpy as np
from gaussiansplattingmlx_tpu.data import dataset
from gaussiansplattingmlx_tpu.train import trainer

out, script = sys.argv[1], sys.argv[2]
TrainData = dataset.TrainData


def capture_data(*args, **kwargs):
    data = TrainData(*args, **kwargs)
    np.save(out + "/images.npy", np.asarray(data.images))
    return data


class Trainer(trainer.Trainer):
    def run(self, on_metrics=None, **kwargs):
        def log(m):
            with open(out + "/history.jsonl", "a") as f:
                f.write(json.dumps({k: float(v) for k, v in m.items()}) + "\n")
            return on_metrics(m) if on_metrics else None
        return super().run(on_metrics=log, **kwargs)


dataset.TrainData = capture_data
trainer.Trainer = Trainer
sys.argv = [script] + sys.argv[3:]
runpy.run_path(script, run_name="__main__")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_synthetic")
    env = dict(os.environ, JAX_PLATFORMS="cpu", GSPLAT_PLATFORM="cpu",
               JAX_COMPILATION_CACHE_DIR=str(out / "jax_cache"))
    proc = subprocess.Popen([sys.executable, "-c", WRAPPER, str(out), str(SCRIPT), *ARGS,
                             "--backend", "pallas_interpret"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = train_synthetic.main([*ARGS, "--device", "cpu"])
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    history = [json.loads(line) for line in (out / "history.jsonl").read_text().splitlines()]
    return port, np.load(out / "images.npy"), history, stdout


def test_ground_truth_matches_jax(runs):
    port, images, _, _ = runs
    assert port.images.shape == images.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(port.images, images, rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
    assert float(images.std()) > 0.05  # a scene, not a blank background


def test_logged_metrics_match_jax(runs):
    port, _, history, stdout = runs
    assert [m["iteration"] for m in port.history] == [m["iteration"] for m in history] == [50]
    for got, want in zip(port.history, history):
        assert got["num_active"] == want["num_active"] == 300
        for key in ("loss", "l1", "ssim", "psnr"):
            np.testing.assert_allclose(got[key], want[key], rtol=ROW_RTOL, err_msg=key)
    assert port.final == port.history[-1]
    assert int(port.trainer.state.step) == 50
    assert "first psnr" in stdout


def test_synthetic_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_synthetic.main(ARGS)
