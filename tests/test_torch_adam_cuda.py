"""Adam as one kernel (``csrc/adam.cu``) against the plain rule, on the card.

Imports no JAX.  Every test is marked ``cuda`` and skips when no CUDA device
is present; on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_adam_cuda.py

Each case steps two copies of the same state on the card, one through
``optimizer.update`` (the kernel) and one through ``optimizer.update_plain``,
and holds p, m and v bit for bit, NaN and inf included: the kernel repeats
the plain rule's correctly rounded operations in its order.  The gradients
arrive as training hands them over: features_dc and features_rest as
column slices of one d shs buffer (row stride 3 x its rows), the others
contiguous.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import require_cuda, scene_numpy

from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
from gaussiansplattingmlx_tpu_torch.models.gaussians import (activations, learning_rates,
                                                             params_from_numpy)
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import optimizer
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

pytestmark = pytest.mark.cuda

STEPS = 3


def _shapes(n, degree):
    k = (degree + 1) ** 2
    return {"xyz": (n, 3), "features_dc": (n, 1, 3), "features_rest": (n, k - 1, 3),
            "scales": (n, 3), "rotation": (n, 4), "opacity": (n, 1)}


def _state(shapes, rng, device):
    params = {k: torch.tensor(rng.normal(size=s).astype(np.float32), device=device)
              for k, s in shapes.items()}
    state = optimizer.init(params)
    for k, s in shapes.items():  # moments of a run under way
        state.m[k].copy_(torch.tensor(rng.normal(size=s).astype(np.float32) * 1e-3))
        state.v[k].copy_(torch.tensor(rng.uniform(0, 1e-5, size=s).astype(np.float32)))
    state.count.fill_(29_999)
    return params, state


def _grads(shapes, rng, device, step, nonfinite, shifted=()):
    """Gradients as training hands them: d shs [N, max(16, K), 3] cut into
    features_dc [N, 1, 3] and features_rest [N, K - 1, 3] views; a tenth of
    the rows zero; NaN, inf and -inf in every leaf where ``nonfinite``; the
    leaves named in ``shifted`` contiguous at a storage offset of one float."""
    n, k = shapes["xyz"][0], shapes["features_rest"][1] + 1
    scale = 10.0 ** (-step)
    d_shs = torch.tensor(rng.normal(size=(n, max(16, k), 3)).astype(np.float32) * scale,
                         device=device)
    grads = {name: torch.tensor(rng.normal(size=s).astype(np.float32) * scale, device=device)
             for name, s in shapes.items() if name not in ("features_dc", "features_rest")}
    grads["features_dc"] = d_shs[:, :1]
    grads["features_rest"] = d_shs[:, 1:k]
    for name in shifted:
        grads[name] = _shifted(grads[name])
    zero = torch.tensor(rng.uniform(size=n) < 0.1, device=device)
    d_shs[zero] = 0.0
    for name, g in grads.items():
        g[zero] = 0.0
        if nonfinite and g.numel():
            flat = g.reshape(-1) if g.is_contiguous() else None
            rows = rng.choice(n, size=3, replace=False)
            for row, val in zip(rows, (float("nan"), float("inf"), float("-inf"))):
                if flat is not None:
                    flat[row * (g.numel() // n)] = val
                else:
                    g[row].view(-1)[0] = val
    return grads


def _shifted(t):
    """A copy of ``t``, contiguous, one float past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


def _step_both(shapes, seed, bias_correction, nonfinite=False, shifted=(), shifted_grads=()):
    """Three steps of the kernel and of the plain rule from one state; asserts
    p, m and v bit-equal after each, one launch and no host sync per
    ``update``.  The
    leaves named in ``shifted`` keep p, m and v, those in ``shifted_grads``
    their gradient, one float past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    params, state = _state(shapes, rng, "cuda")
    for name in shifted:
        for d in (params, state.m, state.v):
            d[name] = _shifted(d[name])
    plain_params = {k: v.clone() for k, v in params.items()}
    plain_state = optimizer.AdamState(m={k: v.clone() for k, v in state.m.items()},
                                      v={k: v.clone() for k, v in state.v.items()},
                                      count=state.count.clone())
    for step in range(STEPS):
        grads = _grads(shapes, rng, "cuda", step, nonfinite, shifted_grads)
        lrs = learning_rates(torch.tensor(30_000 + step, dtype=torch.int32, device="cuda"),
                             40_000, lr_xyz=1.6e-4 * 4.2)
        before = optimizer.KERNEL.launches
        torch.cuda.set_sync_debug_mode("error")  # no host sync: a step stays capturable
        try:
            optimizer.update(params, grads, state, lrs, bias_correction=bias_correction)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert optimizer.KERNEL.launches == before + 1
        optimizer.update_plain(plain_params, grads, plain_state, lrs,
                               bias_correction=bias_correction)
        torch.cuda.synchronize()
        assert int(state.count) == int(plain_state.count)
        for name in shapes:
            for what, got, want in (("p", params[name], plain_params[name]),
                                    ("m", state.m[name], plain_state.m[name]),
                                    ("v", state.v[name], plain_state.v[name])):
                same = _bits(got) == _bits(want)
                assert bool(same.all()), (f"step {step}: {what} {name} differs in "
                                          f"{int((~same).sum())} of {got.numel()}")
    return params


@pytest.mark.parametrize("bias_correction", [False, True])
@pytest.mark.parametrize("n", [1001, 1002])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_adam_kernel_is_the_plain_rule(degree, n, bias_correction):
    """SH degrees 0-4 (features_rest with 0 to 24 rows; empty at 0), N odd
    and N even but not a multiple of 4, bias correction both ways, three
    steps in a row."""
    require_cuda()
    params = _step_both(_shapes(n, degree), seed=100 * degree + n,
                        bias_correction=bias_correction)
    assert all(bool(torch.isfinite(p).all()) for p in params.values())


@pytest.mark.parametrize("bias_correction", [False, True])
def test_adam_kernel_passes_nonfinite_gradients_as_the_plain_rule(bias_correction):
    """NaN, inf and -inf in every leaf's gradient leave the plain rule's
    NaN and inf bits in p, m and v."""
    require_cuda()
    params = _step_both(_shapes(997, 3), seed=7, bias_correction=bias_correction,
                        nonfinite=True)
    assert not all(bool(torch.isfinite(p).all()) for p in params.values())


def test_adam_kernel_unaligned_and_large_leaves():
    """p, m and v one float past a 16-byte boundary (no 16-byte groups: the
    leaf runs in scalars), contiguous gradients one float past it (read as
    rows), beside aligned leaves; every leaf past one block's 4,096 elements
    times 16."""
    require_cuda()
    _step_both(_shapes(70_001, 3), seed=11, bias_correction=False,
               shifted=("xyz", "rotation"), shifted_grads=("scales", "opacity", "rotation"))


def test_adam_launches_once_a_train_step_and_never_in_a_frame():
    """A training step through ``make_train_step`` launches the kernel once;
    a served frame (``render`` without gradients) launches it never."""
    require_cuda()
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.train import trainer

    params, c2w = scene_numpy(n=300, seed=5, sh_degree=3, sh_rest_scale=0.1)
    cam = Camera.from_c2w(100, 72, 60.0, 60.0, c2w)
    images = np.random.default_rng(1).uniform(size=(1, 72, 100, 3)).astype(np.float32)
    cfg = config.TrainConfig(iterations=10, model=config.ModelConfig(sh_degree=3),
                             raster=config.RasterizerConfig(max_pairs=8192))
    raw = {f"param_{k}": v for k, v in params.items()}
    raw.update({f"adam_{m}_{k}": np.zeros_like(v) for k, v in params.items() for m in "mv"})
    raw.update(adam_count=0, num_active=300, grad_accum=np.zeros(300), grad_denom=0.0,
               step=0, overflow_acc=np.zeros(2))
    state = trainer.state_from_numpy(raw, "cuda")
    step = trainer.make_train_step(cfg, 100, 72, 3, 10)
    views = trainer.stack_views(TrainData([cam], images), "cuda")
    for i in range(2):
        before = optimizer.KERNEL.launches
        state, metrics, _ = step(state, views, 0)
        assert optimizer.KERNEL.launches == before + 1
        assert int(state.count) == i + 1 and float(metrics["loss"]) > 0

    gp = params_from_numpy(params, "cuda")
    t = cam.tensors()
    cam_args = [torch.as_tensor(np.asarray(t[k], np.float32)).to("cuda")
                for k in ("view", "proj", "camera_center")]
    cam_args += [float(t[k]) for k in ("fov_x", "fov_y", "focal_x", "focal_y")]
    before = optimizer.KERNEL.launches
    with torch.no_grad():
        out, _ = render(*activations(gp.tensors()), *cam_args, 100, 72, 3,
                        raster_cfg=RasterizerConfig(max_pairs=8192), inference=True)
    torch.cuda.synchronize()
    assert optimizer.KERNEL.launches == before and out.color.shape == (72, 100, 3)
