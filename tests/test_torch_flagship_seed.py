"""``train_flagship.py --seed`` against the JAX package's ``TrainConfig.seed``.

The JAX script trains seed 0 only, so its side here is what the JAX
Trainer builds from a seed (``gaussiansplattingmlx_tpu/train/trainer.py``:
``np.random.default_rng(seed)`` for the camera stream, drawn one view a
step, and ``jax.random.PRNGKey(seed)`` split once a densify round), held
against the port's campaign script run at a tiny size on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from test_torch_flagship import VENDOR, read_summary
from torch_port_helpers import assert_normal_matches
from gaussiansplattingmlx_tpu.config import TrainConfig as JaxTrainConfig
from gaussiansplattingmlx_tpu_torch import train_flagship
from gaussiansplattingmlx_tpu_torch.train.trainer import Trainer

# The self-fit form at its smallest: 3 views of 16x16, a few steps, no
# densify round (those start at 500).  Its ground truth renders at the
# port's 2^22 budget, ~1 s a view here.
TINY = ["--views", "3", "--size", "16", "--gt-gaussians", "300", "--init-points", "128",
        "--max-pairs", "4096", "--max-pairs-limit", "16384", "--checkpoint-interval", "0",
        "--device", "cpu"]
STEPS = 12
NOISE_ROWS = 512


class Built(Exception):
    pass


def test_seed_flag_reaches_train_config(monkeypatch, tmp_path):
    """Default 0; ``--seed 3`` is the seed of the TrainConfig that ``run``
    hands the Trainer."""
    assert train_flagship.parse_args([]).seed == 0 == JaxTrainConfig().seed
    seen = []

    def capture(cfg, *args, **kwargs):
        seen.append(cfg)
        raise Built

    monkeypatch.setattr(train_flagship, "Trainer", capture)
    for argv, seed in (([], 0), (["--seed", "3"], 3)):
        with pytest.raises(Built):
            train_flagship.run(["--dataset-root", str(VENDOR), *argv, "--device", "cpu",
                                "--out", str(tmp_path)])
        assert seen[-1].seed == seed


class RecordingTrainer(Trainer):
    """The port's Trainer, recording the view of every step it trains."""

    def __init__(self, *args, **kwargs):
        self.drawn = []
        super().__init__(*args, **kwargs)

    def _build_train_step(self):
        super()._build_train_step()
        step = self.train_step

        def recorded(state, views, view_idx):
            self.drawn.append(int(view_idx))
            return step(state, views, view_idx)

        self.train_step = recorded


def test_seed_one_streams_are_jax_streams(monkeypatch, tmp_path):
    """``--seed 1``: the views the port's run trained on are the JAX
    Trainer's draws from ``default_rng(1)``; its next densify key and the
    [512, 3] normal drawn from it are JAX's from ``PRNGKey(1)``; the
    summary records the seed."""
    monkeypatch.setattr(train_flagship, "Trainer", RecordingTrainer)
    res = train_flagship.run([*TINY, "--seed", "1", "--iters", str(STEPS),
                              "--out", str(tmp_path)])
    trainer = res.trainer
    seed = JaxTrainConfig(seed=1).seed
    rng = np.random.default_rng(seed)
    want = [int(rng.integers(0, trainer.data.num_views)) for _ in range(STEPS)]
    assert trainer.drawn == want
    assert len(set(want)) > 1  # the draws do pick among the views

    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    start = trainer.key.copy()
    np.testing.assert_array_equal(trainer.next_key(), np.asarray(sub))
    np.testing.assert_array_equal(trainer.key, np.asarray(key))
    trainer.key = start
    noise = trainer.densify_noise(NOISE_ROWS)  # the round's own split and draw
    np.testing.assert_array_equal(trainer.key, np.asarray(key))
    assert_normal_matches(noise, jax.random.normal(sub, (NOISE_ROWS, 3), dtype=jnp.float32))
    assert read_summary(tmp_path)["workload"]["seed"] == 1
