"""The JAX package's public helpers that the port now has too, against the
JAX functions on the same numpy inputs: bit-equal where the function is
elementwise or an index op (``sh2rgb``, ``num_sh_coeffs``,
``strip_lowerdiag``, ``mask_to_indices``; ``inverse_sigmoid`` up to the
last bit of ``log``); the reductions (``l2_loss``, ``smooth_l1_ohem``) and
``covariance`` at rtol 1e-6 / atol 1e-7."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import scene_numpy, to_numpy

from gaussiansplattingmlx_tpu.models import gaussians as jax_gaussians
from gaussiansplattingmlx_tpu.ops import losses as jax_losses
from gaussiansplattingmlx_tpu.utils import sh as jax_sh
from gaussiansplattingmlx_tpu.utils import transforms as jax_transforms
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.ops import losses
from gaussiansplattingmlx_tpu_torch.utils import sh, transforms


def _bit_equal(got, want):
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _close(got, want):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def _images(seed, shape=(24, 32, 3)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, size=shape).astype(np.float32)
    # Differences on both sides of the smooth-L1 knee at beta 0.25 and 1.
    target = (pred + rng.normal(0, 0.4, size=shape)).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("seed", [0, 1])
def test_l2_loss_matches_jax(seed):
    pred, target = _images(seed)
    _close(losses.l2_loss(torch.as_tensor(pred), torch.as_tensor(target)),
           jax_losses.l2_loss(jnp.asarray(pred), jnp.asarray(target)))


@pytest.mark.parametrize("beta,fraction", [(1.0, 1.0), (1.0, 0.25), (0.25, 0.5),
                                           (0.25, 0.01), (1.0, 1e-6)])
def test_smooth_l1_ohem_matches_jax(beta, fraction):
    """The whole mean, hard-example fractions down to a single element, and
    the same static k (the element count at 1e-6 rounds down to 0 -> 1)."""
    pred, target = _images(3)
    got = losses.smooth_l1_ohem(torch.as_tensor(pred), torch.as_tensor(target), beta, fraction)
    want = jax_losses.smooth_l1_ohem(jnp.asarray(pred), jnp.asarray(target), beta, fraction)
    _close(got, want)
    if fraction < 1.0:
        assert float(got) > float(losses.smooth_l1_ohem(
            torch.as_tensor(pred), torch.as_tensor(target), beta, 1.0))


def test_smooth_l1_ohem_gradient_reaches_only_the_kept_elements():
    pred, target = _images(4, shape=(8, 8))
    p = torch.as_tensor(pred).requires_grad_()
    losses.smooth_l1_ohem(p, torch.as_tensor(target), 1.0, 0.25).backward()
    assert int(torch.count_nonzero(p.grad)) == 16


def test_sh2rgb_and_num_sh_coeffs_match_jax():
    rng = np.random.default_rng(5)
    dc = rng.normal(0, 2, size=(64, 1, 3)).astype(np.float32)
    _bit_equal(sh.sh2rgb(torch.as_tensor(dc)), jax_sh.sh2rgb(jnp.asarray(dc)))
    rgb = rng.uniform(0, 1, size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(to_numpy(sh.sh2rgb(sh.rgb2sh(torch.as_tensor(rgb)))), rgb,
                               rtol=0, atol=1e-6)
    for degree in range(5):
        assert sh.num_sh_coeffs(degree) == jax_sh.num_sh_coeffs(degree) == (degree + 1) ** 2


def test_inverse_sigmoid_matches_jax():
    """log's float32 approximations differ between XLA and torch by up to
    one unit in the last place (about a tenth of these inputs): the odds
    x / (1 - x) are held bit for bit, the logit to 1 ulp."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(1e-6, 1 - 1e-6, size=256),
                        [0.01, 0.1, 0.5, 0.9, 0.99]]).astype(np.float32)
    got = transforms.inverse_sigmoid(torch.as_tensor(x))
    want = jax_transforms.inverse_sigmoid(jnp.asarray(x))
    odds = torch.as_tensor(x) / (1.0 - torch.as_tensor(x))
    _bit_equal(odds, jnp.asarray(x) / (1.0 - jnp.asarray(x)))
    _bit_equal(got, torch.log(odds))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(to_numpy(got), np.asarray(want), maxulp=1)
    np.testing.assert_allclose(to_numpy(torch.sigmoid(got)), x, rtol=1e-5, atol=1e-6)


def test_strip_lowerdiag_matches_jax():
    m = np.random.default_rng(7).normal(size=(5, 4, 3, 3)).astype(np.float32)
    got = transforms.strip_lowerdiag(torch.as_tensor(m))
    _bit_equal(got, jax_transforms.strip_lowerdiag(jnp.asarray(m)))
    assert got.shape == (5, 4, 6)


@pytest.mark.parametrize("case", ["random", "all_false", "all_true", "2d"])
@pytest.mark.parametrize("fill_value", [-1, 7])
def test_mask_to_indices_matches_jax(case, fill_value):
    rng = np.random.default_rng(8)
    mask = {"random": rng.uniform(size=300) < 0.3, "all_false": np.zeros(50, bool),
            "all_true": np.ones(50, bool), "2d": rng.uniform(size=(6, 9)) < 0.5}[case]
    idx, count = transforms.mask_to_indices(torch.as_tensor(mask), fill_value)
    want_idx, want_count = jax_transforms.mask_to_indices(jnp.asarray(mask), fill_value)
    assert isinstance(count, torch.Tensor) and count.dim() == 0
    assert int(count) == int(want_count) == int(mask.sum())
    np.testing.assert_array_equal(to_numpy(idx), np.asarray(want_idx))
    flat = np.flatnonzero(mask.reshape(-1))
    np.testing.assert_array_equal(to_numpy(idx)[:len(flat)], flat)
    assert (to_numpy(idx)[len(flat):] == fill_value).all()


@pytest.mark.parametrize("modifier", [1.0, 0.5])
def test_covariance_matches_jax(modifier):
    params, _ = scene_numpy(n=64, seed=9)
    rng = np.random.default_rng(9)
    params["rotation"] = rng.normal(size=(64, 4)).astype(np.float32)  # unnormalized
    gp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    want = jax_gaussians.covariance(gp, modifier)
    tp = gaussians.params_from_numpy(params, "cpu")
    got = gaussians.covariance(tp, modifier)
    assert got.shape == (64, 6)
    _close(got, want)
    _close(gaussians.covariance(tp.tensors(), modifier), want)
