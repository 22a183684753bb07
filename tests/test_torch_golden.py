"""The port against the committed golden image (tests/golden_scene.npz, the
JAX oracle's render of tests/test_golden.py's scene), at that test's bars:
color rtol 1e-4 / atol 1e-5, depth rtol 1e-4 / atol 1e-4, alpha rtol 1e-4
/ atol 1e-5, n_contrib mismatch < 0.2%.  The port's oracle
(``backend="reference"``) and its kernels' plain versions (K2 then K1,
serving and training forward) each render it.  Drift that the port and its
parity tests shared would show here.  The file is only read: a missing
golden fails."""

import numpy as np
import pytest

from torch_golden_scene import GOLDEN, golden_errors, render_golden


@pytest.mark.parametrize("backend,inference", [("reference", False), ("auto", True),
                                               ("auto", False)],
                         ids=["reference", "kernels_serving", "kernels_training"])
def test_port_renders_the_golden_image(backend, inference):
    assert GOLDEN.exists(), f"{GOLDEN} is missing"
    want = np.load(GOLDEN)
    got = render_golden("cpu", backend, inference)
    assert got["color"].shape == (64, 64, 3) and got["color"].std() > 0.05
    np.testing.assert_allclose(got["color"], want["color"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=1e-4, atol=1e-5)
    mismatch = np.mean(got["n_contrib"] != want["n_contrib"])
    assert mismatch < 0.002
    err = golden_errors(got, want)
    assert max(err[f"{k}_excess"] for k in ("color", "depth", "alpha")) <= 0
    assert err["ncon_mismatch"] == mismatch
