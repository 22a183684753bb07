"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``gaussiansplattingmlx_tpu_torch/csrc/*.cu`` expose a plain C
interface.  On first use each is compiled by its own nvcc process for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library under ``gaussiansplattingmlx_tpu_torch/_build/``, named by a
hash of the sources and flags, and loaded with ctypes.  Nothing is built
when a module is imported, and nothing here runs for CPU tensors.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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

    @property
    def loaded(self) -> bool:
        return self._cdll is not None

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
        cu = [s for s in self.sources() if s.suffix == ".cu"]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
            objs = [Path(tmp_dir) / f"{s.stem}.o" for s in cu]
            cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o), str(s)]
                    for s, o in zip(cu, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            self.build_log = "".join(logs)
            for cmd, proc, log in zip(cmds, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            tmp = Path(tmp_dir) / "lib.so"
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            self.build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        self.build_seconds = time.perf_counter() - t0
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
# Every Kernel, in the order their modules created them.
KERNELS: list = []


def launch_counts() -> dict:
    """Each kernel's launch counter, by C symbol."""
    return {k.symbol: k.launches for k in KERNELS}


class Kernel:
    """One C entry point of the library, with its launch counter."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

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
