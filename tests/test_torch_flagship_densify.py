"""The port's flagship campaign (``train_flagship.py``) against the JAX
package's ``scripts/train_flagship_tpu.py`` past the first densify round,
a capacity growth, a pair-budget growth and an opacity reset, on the
independent form's kind of scene: ``scripts/make_vendor_scene.py --rich``
with its sky dome, cut to 12 views at 32x32.

The two runs cannot replay each other's densify noise on their own (JAX
draws it from a key, the port from a ``torch.Generator``), so the port's
``Trainer.densify_noise`` is replaced here by JAX's draw: ``PRNGKey(seed)``
split once a round, as the JAX trainer's ``next_key`` does.  The two
sides then differ only by float rounding, which already moves single rows
apart before step 500 (``test_torch_flagship.py``), and lets a threshold
decide a few Gaussians differently at a densify round.  So the discrete
events are held equal (capacity, budget, the pairs the first 50 steps
drop) and the rest within bounds that float drift keeps well inside but a
departure like ROADMAP C.4's (one held-out view 13 dB apart, loss spikes
of 10x) would break: the Gaussians each row within 2%, the mean loss of
the rows after the first densify round within 5%, each held-out view
within 1 dB PSNR and 0.02 SSIM."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from test_torch_flagship import ROOT, finish, read_rows, read_summary, start_jax
from gaussiansplattingmlx_tpu_torch import train_flagship
from gaussiansplattingmlx_tpu_torch.train.trainer import Trainer

SCENE = ["--width", "32", "--height", "32", "--views", "12", "--points", "4000",
         "--sky-points", "500", "--rich"]
# Run (b)'s flags, with the densify window, the reset interval, the initial
# capacity and the budget cut so that 650 steps densify at 500 and 600,
# grow the capacity 512 -> 1024 at 500, reset the opacities at 600 and
# overflow the first 50 steps' budget as run (b) does.
FLAGS = ["--holdout", "2", "--iters", "650", "--sh-degree", "3", "--densify-until", "650",
         "--opacity-reset-interval", "600", "--prune-world-scale", "2.0",
         "--spatial-lr-scale", "auto", "--init-points", "512", "--initial-capacity", "512",
         "--max-pairs", "1024", "--max-pairs-limit", "65536"]
FIRST_DENSIFY = 500
ACTIVE_RTOL = 0.02
MEAN_LOSS_RTOL = 0.05
HOLDOUT_PSNR_ATOL_DB, HOLDOUT_SSIM_ATOL = 1.0, 0.02


def jax_noise_draws(seed: int):
    """``Trainer.densify_noise`` drawing what the JAX trainer draws: one
    split of ``PRNGKey(seed)`` a round, a [capacity, 3] standard normal."""
    key = [jax.random.PRNGKey(seed)]

    def densify_noise(self, capacity: int) -> torch.Tensor:
        key[0], sub = jax.random.split(key[0])
        draw = np.array(jax.random.normal(sub, (capacity, 3), dtype=jnp.float32))
        return torch.from_numpy(draw).to(self.device)

    return densify_noise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("flagship_densify")
    scene = base / "scene"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "make_vendor_scene.py"),
                    "--out", str(scene), *SCENE], check=True, capture_output=True)
    args = ["--dataset-root", str(scene), *FLAGS]
    proc = start_jax(base / "jax", args)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Trainer, "densify_noise", jax_noise_draws(0))
            port = train_flagship.run([*args, "--out", str(base / "port"), "--device", "cpu"])
    except BaseException:
        proc.kill()
        raise
    finish(proc)
    return base / "port", base / "jax", port


def test_past_densify_and_reset_matches_jax(runs):
    port_out, jax_out, port = runs
    assert port.trainer.cfg.densify.from_iter == FIRST_DENSIFY
    rows, jax_rows = read_rows(port_out), read_rows(jax_out)
    hold, jax_hold = read_summary(port_out)["holdout"], read_summary(jax_out)["holdout"]
    after = [r for r in rows if r["iteration"] > FIRST_DENSIFY]
    jax_after = [r for r in jax_rows if r["iteration"] > FIRST_DENSIFY]
    # The numbers compared, port then JAX (pytest -s shows them).
    print("flagship past densify, port / JAX: gaussians",
          [(p["iteration"], p["num_active"], j["num_active"]) for p, j in zip(rows, jax_rows)
           if p["iteration"] >= FIRST_DENSIFY],
          "| pairs dropped by step 50", rows[0]["overflow_pairs_acc"],
          jax_rows[0]["overflow_pairs_acc"],
          "| mean loss after the first round", np.mean([r["loss"] for r in after]),
          np.mean([r["loss"] for r in jax_after]),
          "| lowest row PSNR", min(r["psnr"] for r in rows), min(r["psnr"] for r in jax_rows),
          "| held-out PSNR", hold["psnr_per_view"], jax_hold["psnr_per_view"],
          "SSIM", hold["ssim_per_view"], jax_hold["ssim_per_view"])
    assert [r["iteration"] for r in rows] == [r["iteration"] for r in jax_rows]
    assert rows[-1]["iteration"] == 650
    # The discrete events happen at the same rows.
    assert [r["capacity"] for r in rows] == [r["capacity"] for r in jax_rows]
    assert rows[0]["capacity"] == 512 and rows[-1]["capacity"] == 1024
    assert [r["max_pairs"] for r in rows] == [r["max_pairs"] for r in jax_rows]
    assert rows[0]["overflow_pairs_acc"] == jax_rows[0]["overflow_pairs_acc"] > 0
    for p, j in zip(rows, jax_rows):
        assert abs(p["num_active"] - j["num_active"]) <= ACTIVE_RTOL * j["num_active"], \
            (p["iteration"], p["num_active"], j["num_active"])
    # Densify changed the Gaussians; the reset and the rounds left finite losses.
    assert rows[-1]["num_active"] != rows[0]["num_active"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    np.testing.assert_allclose(np.mean([r["loss"] for r in after]),
                               np.mean([r["loss"] for r in jax_after]), rtol=MEAN_LOSS_RTOL)
    assert hold["views"] == jax_hold["views"] == [0, 6]
    np.testing.assert_allclose(hold["psnr_per_view"], jax_hold["psnr_per_view"],
                               atol=HOLDOUT_PSNR_ATOL_DB)
    np.testing.assert_allclose(hold["ssim_per_view"], jax_hold["ssim_per_view"],
                               atol=HOLDOUT_SSIM_ATOL)
