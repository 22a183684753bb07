"""gaussiansplattingmlx_tpu_torch — PyTorch + CUDA port of gaussiansplattingmlx_tpu.

The JAX package stays the reference; this package mirrors its module names
(``config``, ``utils``, ``data``, ``models``, ``ops``, ``render``,
``render_cli``, ``train``) so each module's counterpart is easy to find.  It
imports torch and numpy only: never ``jax`` and never
``gaussiansplattingmlx_tpu``.

Plain tensor code is PyTorch.  The TPU's Pallas kernels on the serving and
training paths are hand-written CUDA C++ for Hopper (``csrc/``), built with
nvcc on first use by ``ops/_kernels.py``.  A wrapper given CPU tensors runs the
kernel's plain PyTorch version; given CUDA tensors it launches the kernel or
raises.
"""
