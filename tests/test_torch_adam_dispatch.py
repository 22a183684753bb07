"""``optimizer.update`` on the CPU: the plain rule, unchanged, and what the
CUDA path packs for its kernel.

On CPU tensors ``update`` must do exactly what ``update_plain`` does and
launch no kernel; the kernel itself is held to the plain rule on the card
(``tests/test_torch_adam_cuda.py``).  The CUDA path's argument checks,
pointer and stride packing and constants are plain Python, tested here.
"""

import ctypes

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from gaussiansplattingmlx_tpu_torch.ops import _kernels
from gaussiansplattingmlx_tpu_torch.train import optimizer

SHAPES = {"xyz": (9, 3), "features_dc": (9, 1, 3), "features_rest": (9, 15, 3),
          "scales": (9, 3), "rotation": (9, 4), "opacity": (9, 1)}


def _case(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    params = {k: torch.tensor(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    state = optimizer.init(params)
    d_shs = torch.tensor(rng.normal(size=(9, 16, 3)).astype(np.float32))
    grads = {k: torch.tensor(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    grads["features_dc"] = d_shs[:, :1]
    grads["features_rest"] = d_shs[:, 1:1 + shapes["features_rest"][1]]
    lrs = {k: torch.tensor(np.float32(rng.uniform(1e-4, 1e-2))) for k in shapes}
    return params, state, grads, lrs


def _copy(params, state):
    return ({k: v.clone() for k, v in params.items()},
            optimizer.AdamState(m={k: v.clone() for k, v in state.m.items()},
                                v={k: v.clone() for k, v in state.v.items()},
                                count=state.count.clone()))


@pytest.mark.parametrize("bias_correction", [False, True])
def test_update_on_cpu_is_the_plain_rule(bias_correction):
    """Three steps of ``update`` and ``update_plain`` from one state: p, m, v
    and the count bit for bit, with the SH gradients as strided views; no
    kernel launched."""
    params, state, grads, lrs = _case(1)
    want_p, want_s = _copy(params, state)
    before = _kernels.launch_counts()
    for _ in range(3):
        optimizer.update(params, grads, state, lrs, bias_correction=bias_correction)
        optimizer.update_plain(want_p, grads, want_s, lrs, bias_correction=bias_correction)
    assert _kernels.launch_counts() == before
    assert int(state.count) == int(want_s.count) == 3
    for k in SHAPES:
        for got, want in ((params[k], want_p[k]), (state.m[k], want_s.m[k]),
                          (state.v[k], want_s.v[k])):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


def test_adam_kernel_packs_leaves_as_rows_of_the_gradient():
    """Each leaf's pointers (p, m, v, g, lr) and sizes (elements, row width,
    gradient row stride): the SH gradients as column slices of d shs at row
    stride 48, without a copy; a gradient whose row is not contiguous copied;
    a leaf with no elements left out."""
    shapes = dict(SHAPES, features_rest=(9, 0, 3))
    params, state, grads, lrs = _case(2, shapes)
    d_shs = torch.zeros(9, 16, 3)
    grads["features_dc"] = d_shs[:, :1]
    grads["xyz"] = torch.zeros(3, 9).t()  # columns contiguous, rows not
    dev = torch.device("cpu")
    leaves = [optimizer._leaf(k, params[k], grads[k], state.m[k], state.v[k], lrs[k], dev)
              for k in shapes]
    count, ptrs, sizes = optimizer.pack(leaves)
    assert count == 5 and len(ptrs) == 25 and len(sizes) == 15
    names = [k for k in shapes if k != "features_rest"]
    got = {k: (list(ptrs[5 * i:5 * i + 5]), list(sizes[3 * i:3 * i + 3]))
           for i, k in enumerate(names)}
    assert got["features_dc"][0][3] == d_shs.data_ptr()
    assert got["features_dc"][1] == [27, 3, 48]
    assert got["xyz"][0][3] != grads["xyz"].data_ptr() and got["xyz"][1] == [27, 3, 3]
    assert got["rotation"][1] == [36, 4, 4] and got["opacity"][1] == [9, 1, 1]
    for k in names:
        assert got[k][0][:3] == [params[k].data_ptr(), state.m[k].data_ptr(),
                                 state.v[k].data_ptr()]
        assert got[k][0][4] == lrs[k].data_ptr()
    rest = optimizer._leaf("features_rest", params["xyz"].new_zeros(9, 15, 3), d_shs[:, 1:],
                           torch.zeros(9, 15, 3), torch.zeros(9, 15, 3), lrs["xyz"], dev)
    assert rest[3].data_ptr() == d_shs.data_ptr() + 12 and rest[3].stride() == (48, 1)


def test_adam_kernel_constants_round_as_torch_rounds_a_python_scalar():
    """b1, b2, 1 - b1, 1 - b2 and eps: the double rounded to float32, which is
    what a float32 tensor op does with the same Python number."""
    beta1, beta2, eps = 0.9, 0.999, 1e-15
    got = np.ctypeslib.as_array(optimizer.constants(beta1, beta2, eps))
    one = torch.ones(1)
    want = [float(one * x) for x in (beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    assert isinstance(optimizer.constants(beta1, beta2, eps), ctypes.Array)


@pytest.mark.parametrize("fault, match", [
    ("shape", "scales: m must be"), ("p_strided", "xyz: parameter must be"),
    ("m_strided", "rotation: m must be"), ("v_strided", "features_rest: v must be"),
    ("dtype", "opacity: parameter must be"), ("grad_shape", "xyz: gradient must be"),
    ("lr_shape", "xyz: learning rate"), ("lr_number", "xyz: learning rate must be a tensor"),
    ("leaves", "at most 8")])
def test_adam_kernel_path_refuses_what_the_kernel_does_not_take(fault, match):
    """Each refusal comes before the count moves and before any launch."""
    params, state, grads, lrs = _case(3)
    if fault == "shape":
        state.m["scales"] = torch.zeros(9, 4)
    elif fault == "p_strided":
        params["xyz"] = torch.zeros(3, 9).t()
    elif fault == "m_strided":
        state.m["rotation"] = torch.zeros(4, 9).t()
    elif fault == "v_strided":
        state.v["features_rest"] = torch.zeros(9, 16, 3)[:, 1:]
    elif fault == "dtype":
        params["opacity"] = params["opacity"].double()
    elif fault == "grad_shape":
        grads["xyz"] = torch.zeros(9, 4)
    elif fault == "lr_shape":
        lrs["xyz"] = torch.zeros(2)
    elif fault == "lr_number":
        lrs["xyz"] = 1.6e-4
    else:
        for i in range(3):
            params[f"extra{i}"] = torch.zeros(2)
    before = _kernels.launch_counts()
    with pytest.raises(ValueError, match=match):
        optimizer.update_cuda(params, grads, state, lrs)
    assert int(state.count) == 0 and _kernels.launch_counts() == before


def test_update_refuses_other_devices():
    meta = {"xyz": torch.empty(4, 3, device="meta")}
    state = optimizer.AdamState(m=dict(meta), v=dict(meta), count=torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        optimizer.update(meta, meta, state, {"xyz": torch.tensor(1e-3)})
