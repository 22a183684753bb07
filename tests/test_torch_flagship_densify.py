"""The port's flagship campaign (``train_flagship.py``) against the JAX
package's ``scripts/train_flagship_tpu.py`` past the first densify round,
a capacity growth, a pair-budget growth and an opacity reset, on the
independent form's kind of scene: ``scripts/make_vendor_scene.py --rich``
with its sky dome, cut to 12 views at 32x32.

Both sides draw the same densify noise, each on its own: ``PRNGKey(seed)``
split once a round and ``jax.random.normal`` of the half it hands out, the
port through ``utils/prng.py`` (its first draw is held to JAX's here at the
normal draw's tolerance, its key after the run to JAX's after as many
splits).  The two sides then differ only by float rounding, which already moves single rows
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
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from test_torch_flagship import ROOT, finish, read_rows, read_summary, start_jax
from torch_port_helpers import assert_normal_matches
from gaussiansplattingmlx_tpu_torch import train_flagship
from gaussiansplattingmlx_tpu_torch.train.trainer import Trainer
from gaussiansplattingmlx_tpu_torch.utils import prng

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
ROUNDS = 2  # densify at 500 and 600
ACTIVE_RTOL = 0.02
MEAN_LOSS_RTOL = 0.05
HOLDOUT_PSNR_ATOL_DB, HOLDOUT_SSIM_ATOL = 1.0, 0.02


def jax_noise_draws(seed: int):
    """What the JAX trainer draws a densify round: one split of
    ``PRNGKey(seed)`` a round, a [capacity, 3] standard normal."""
    key = [jax.random.PRNGKey(seed)]

    def densify_noise(self, capacity: int) -> torch.Tensor:
        key[0], sub = jax.random.split(key[0])
        draw = np.array(jax.random.normal(sub, (capacity, 3), dtype=jnp.float32))
        return torch.from_numpy(draw).to(self.device)

    return densify_noise


def test_first_draw_is_jax_draw():
    """The Trainer's own first densify draw for seed 0 (its ``next_key`` and
    ``densify_noise`` on a fresh key) against the JAX trainer's."""
    fresh = SimpleNamespace(key=prng.prng_key(0), device=torch.device("cpu"))
    fresh.next_key = lambda: Trainer.next_key(fresh)
    want = jax_noise_draws(0)(fresh, 512)
    assert_normal_matches(Trainer.densify_noise(fresh, 512), want)


def start_runs(base, flags):
    """Write the 32x32 scene under ``base`` and start the JAX script on it
    with ``flags`` (a subprocess).  Returns what ``finish_runs`` takes."""
    scene = base / "scene"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "make_vendor_scene.py"),
                    "--out", str(scene), *SCENE], check=True, capture_output=True)
    args = ["--dataset-root", str(scene), *flags]
    return base, args, start_jax(base / "jax", args)


def finish_runs(base, args, proc):
    """Run the port on the same flags in this process while the JAX script
    runs, then wait for it.  Returns (port out, JAX out, the port's run)."""
    try:
        port = train_flagship.run([*args, "--out", str(base / "port"), "--device", "cpu"])
    except BaseException:
        proc.kill()
        raise
    finish(proc)
    return base / "port", base / "jax", port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return finish_runs(*start_runs(tmp_path_factory.mktemp("flagship_densify"), FLAGS))


def assert_follows_jax(port_out, jax_out, psnr_atol_db=HOLDOUT_PSNR_ATOL_DB):
    """The bars that float drift keeps well inside: the same logged rows
    with the same capacity and budget, the Gaussians each row within 2%,
    finite losses whose mean after the first densify round is within 5%,
    each held-out view within ``psnr_atol_db`` (1 dB) PSNR and 0.02 SSIM.
    Prints the numbers compared, port then JAX (pytest -s shows them).
    Returns both sides' rows."""
    rows, jax_rows = read_rows(port_out), read_rows(jax_out)
    hold, jax_hold = read_summary(port_out)["holdout"], read_summary(jax_out)["holdout"]
    after = [r for r in rows if r["iteration"] > FIRST_DENSIFY]
    jax_after = [r for r in jax_rows if r["iteration"] > FIRST_DENSIFY]
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
    # The discrete events happen at the same rows.
    assert [r["capacity"] for r in rows] == [r["capacity"] for r in jax_rows]
    assert [r["max_pairs"] for r in rows] == [r["max_pairs"] for r in jax_rows]
    for p, j in zip(rows, jax_rows):
        assert abs(p["num_active"] - j["num_active"]) <= ACTIVE_RTOL * j["num_active"], \
            (p["iteration"], p["num_active"], j["num_active"])
    # Densify changed the Gaussians; the rounds left finite losses.
    assert rows[-1]["num_active"] != rows[0]["num_active"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    np.testing.assert_allclose(np.mean([r["loss"] for r in after]),
                               np.mean([r["loss"] for r in jax_after]), rtol=MEAN_LOSS_RTOL)
    assert hold["views"] == jax_hold["views"] == [0, 6]
    np.testing.assert_allclose(hold["psnr_per_view"], jax_hold["psnr_per_view"],
                               atol=psnr_atol_db)
    np.testing.assert_allclose(hold["ssim_per_view"], jax_hold["ssim_per_view"],
                               atol=HOLDOUT_SSIM_ATOL)
    return rows, jax_rows


def test_past_densify_and_reset_matches_jax(runs):
    port_out, jax_out, port = runs
    assert port.trainer.cfg.densify.from_iter == FIRST_DENSIFY
    key = jax.random.PRNGKey(0)
    for _ in range(ROUNDS):
        key, _ = jax.random.split(key)
    np.testing.assert_array_equal(port.trainer.key, np.asarray(key))
    rows, jax_rows = assert_follows_jax(port_out, jax_out)
    assert rows[-1]["iteration"] == 650
    assert rows[0]["capacity"] == 512 and rows[-1]["capacity"] == 1024
    assert rows[0]["overflow_pairs_acc"] == jax_rows[0]["overflow_pairs_acc"] > 0
