"""The port's flagship campaign against the JAX package's
``scripts/train_flagship_tpu.py`` in round 4's SH4 form with SH warm-up
(``--sh-degree 4 --sh-warmup N``: rest band d trains from step d x N), on
``test_torch_flagship_densify.py``'s 32x32 12-view scene with its flags and
bars but one.  At a warm-up of 100 all four rest bands switch on (at 100,
200, 300 and 400) before the densify rounds at 500 and 600.

A band that switches on takes its first Adam steps at full size whatever
its gradients' size, in the sign of each gradient (its moments start at
zero, and eps is 1e-15); so does the opacity after the reset at 600, which
zeroes its moments.  Where a gradient is as small as float rounding, its
sign is rounding's, so two programs part at each switch: the JAX script
alone, ``pallas_interpret`` against its oracle (``reference``) from step 0,
logs losses 8% apart 50 steps after band 2 switches on and 2.2x apart at
step 400, and held-out views 1.7 dB apart at 650.  So the port is held to
JAX past the switches from one state: the JAX script trains from step 0
and checkpoints at 450, all four bands live; the port resumes that
checkpoint (the JAX file format, its densify key included) and trains to
650 through both densify rounds and the opacity reset.  From that one
state the JAX script's two backends still end 1.07 and 1.91 dB apart on
the two held-out views (SSIM 0.009 and 0.008), so the held-out PSNR bar
here is 3 dB, not 1; every other bar is the SH3 run's.  The band mask
itself is held to JAX's at each switch bit for bit.  The initial capacity
is 1,024: at 512 the JAX script's own two backends land on either side of
the capacity growth at step 500 (435 and 436 Gaussians against 0.85 x
512)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flagship import finish
from test_torch_flagship_densify import FLAGS, assert_follows_jax, start_runs
from torch_port_helpers import to_numpy, to_torch
from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu_torch import train_flagship
from gaussiansplattingmlx_tpu_torch.models import gaussians

SH_WARMUP = 100
RESUME_AT = 450
# Above the 1.91 dB that the JAX script's two backends part by from the
# checkpoint; far below a hazed view's 13 dB (ROADMAP C.4).
SH4_HOLDOUT_PSNR_ATOL_DB = 3.0
SH4_FLAGS = [*FLAGS, "--sh-degree", "4", "--sh-warmup", str(SH_WARMUP),
             "--initial-capacity", "1024", "--checkpoint-interval", str(RESUME_AT)]


@pytest.mark.parametrize("step", [0, 99, 100, 199, 200, 300, 399, 400, 650])
def test_sh4_band_mask_matches_jax(step):
    """The warm-up's band mask at SH degree 4 (24 rest rows), on both sides
    of each switch, bit for bit."""
    rest = np.random.default_rng(step).normal(size=(6, 24, 3)).astype(np.float32)
    jp = jax_gaussians.GaussianParams(
        xyz=jnp.zeros((6, 3)), features_dc=jnp.zeros((6, 1, 3)),
        features_rest=jnp.asarray(rest), scales=jnp.zeros((6, 3)),
        rotation=jnp.zeros((6, 4)), opacity=jnp.zeros((6, 1)))
    want = jax_gaussians.apply_sh_warmup(jp, jnp.int32(step), SH_WARMUP, 4).features_rest
    got = gaussians.apply_sh_warmup({"features_rest": to_torch(rest)}, torch.tensor(step),
                                    SH_WARMUP, 4)["features_rest"]
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    live = int((np.abs(to_numpy(got)).sum(axis=(0, 2)) > 0).sum())
    assert live == (min(step // SH_WARMUP, 4) + 1) ** 2 - 1


def test_sh4_warmup_matches_jax(tmp_path):
    base, args, proc = start_runs(tmp_path, SH4_FLAGS)
    finish(proc)
    jax_out, port_out = base / "jax", base / "port"
    # The port's log starts with the JAX run's rows up to the checkpoint, as
    # a run resumed in the JAX run's directory would.
    port_out.mkdir()
    rows = [line for line in (jax_out / "metrics.jsonl").read_text().splitlines()
            if json.loads(line)["iteration"] <= RESUME_AT]
    (port_out / "metrics.jsonl").write_text("\n".join(rows) + "\n")
    port = train_flagship.run([*args, "--resume", str(jax_out / f"ckpt_{RESUME_AT}.npz"),
                               "--out", str(port_out), "--device", "cpu"])
    model = port.trainer.cfg.model
    assert (model.sh_degree, model.sh_warmup_interval) == (4, SH_WARMUP)
    port_rows, _ = assert_follows_jax(port_out, jax_out,
                                      psnr_atol_db=SH4_HOLDOUT_PSNR_ATOL_DB)
    assert port_rows[-1]["iteration"] == 650 and len(port_rows) == 650 // 50
    # Every rest band of the Gaussians the port trained is live.
    rest = port.trainer.state.params.features_rest.detach()[:int(port.trainer.state.num_active)]
    assert bool((rest.abs().sum(dim=(0, 2)) > 0).all())
