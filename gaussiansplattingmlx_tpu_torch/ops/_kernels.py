"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``gaussiansplattingmlx_tpu_torch/csrc/*.cu`` expose a plain C
interface.  On first use they are compiled by nvcc for Hopper (``sm_90a``)
into one shared library under ``gaussiansplattingmlx_tpu_torch/_build/``,
named by a hash of the sources and flags, and loaded with ctypes.  Nothing
is built when a module is imported, and nothing here runs for CPU tensors.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``Kernel.launch`` raises on a non-zero code and
otherwise adds one to the kernel's launch counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class _Library:
    """The compiled kernel library, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cdll = None
        self.path: Path | None = None
        self.build_seconds: float | None = None  # None: loaded from _build/
        self.build_log = ""

    def sources(self) -> list[Path]:
        return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))

    def _target(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"libgsplat_kernels_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        target = self._target()
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(s) for s in self.sources() if s.suffix == ".cu"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{self.build_log}"
            )
        os.replace(tmp, target)
        return target

    def cdll(self) -> ctypes.CDLL:
        with self._lock:
            if self._cdll is None:
                self.path = self.build()
                lib = ctypes.CDLL(str(self.path))
                lib.gsplat_error_string.argtypes = [ctypes.c_int]
                lib.gsplat_error_string.restype = ctypes.c_char_p
                self._cdll = lib
            return self._cdll


LIBRARY = _Library()


class Kernel:
    """One C entry point of the library, with its launch counter."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(LIBRARY.cdll(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = LIBRARY.cdll().gsplat_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of the tensor's device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
