"""Fixtures of the benchmark's tests: a copy of the benchmark's files whose
configurations and traffic mixes are cut to a size the CPU runs in seconds
(the kernels' plain versions run there), and the card's presence, decided
inside a fixture."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {"image_width": 64, "image_height": 48, "train_views": 4}
TINY_GAUSSIANS = 3000
TINY_TRAFFIC = {
    "train": {"warmup_steps": 2, "trace_steps": 3, "sync_steps": 1},
    "serve": {"trace_frames": 4, "check_frames": 3, "warmup_frames": 2, "sync_frames": 1,
              "per_pose": 1, "probe_every": 20},
}


def make_tiny_root(dest: Path) -> Path:
    """``dest`` with BENCHMARK.json and the benchmark's data files, each
    configuration and traffic mix cut to a tiny size."""
    bench = ROOT / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(bench / sub, dest / "benchmark" / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if "focal_px" in cfg["cameras"]:
            cfg["cameras"]["focal_px"] *= TINY_CONFIG["image_width"] / cfg["image_width"]
        cfg.update(TINY_CONFIG)
        cfg["scene"]["gaussians"] = TINY_GAUSSIANS
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(TINY_TRAFFIC[tr["kind"]])
        path.write_text(json.dumps(tr))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return "cuda:0"
