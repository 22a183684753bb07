"""ctypes bindings of the port's native COLMAP parsers
(``gaussiansplattingmlx_tpu_torch/native/gsplat_io.cpp``; the counterpart
of the JAX package's ``data/native_io.py``).

The library is built at first use with the host C++ compiler (``$CXX``,
else ``c++`` or ``g++``) into the package's git-ignored ``_build/``, named
by a hash of the source and flags, and loaded once per process.  Each
builder writes a temporary file and renames it into place, so processes
that build at once never load a partial library.

Where it cannot be built -- no compiler is found, or ``_build/`` cannot be
created or written -- ``library()`` returns None and says why in one line
on stderr, once per process; the readers in ``data/colmap.py`` then parse
in Python (``read_*_bin_plain``), as the JAX package does when its library
is not built.  A library already in ``_build/`` loads without a compiler.
A failed compile of the source still raises, with the compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "gsplat_io.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None
# Why the library is unavailable in this process (None: not known to be).
_missing: Optional[str] = None


class Unavailable(RuntimeError):
    """The library cannot be built here: no compiler, or no writable
    ``_build/``."""


def _compiler() -> str:
    """The first of ``$CXX``, ``c++`` and ``g++`` that resolves to a file."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise Unavailable("no C++ compiler ($CXX, c++ or g++)")


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgsplat_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser library unless ``_build/`` holds it; its path.
    Raises ``Unavailable`` where it cannot be built, ``RuntimeError`` with
    the compiler's log where the compile fails."""
    target = _target()
    if target.exists():
        return target
    cxx = _compiler()
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    except OSError as exc:
        raise Unavailable(f"{BUILD_DIR} cannot be created or written "
                          f"({exc.strerror or exc})") from exc
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native COLMAP parser failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def library() -> Optional[ctypes.CDLL]:
    """The parser library, built and loaded on the first call; None where
    it cannot be built (the cause printed once on stderr)."""
    global _lib, _missing
    with _lock:
        if _lib is None and _missing is None:
            try:
                path = build()
            except Unavailable as exc:
                _missing = str(exc)
                print(f"native COLMAP parser unavailable: {_missing}; parsing in Python",
                      file=sys.stderr, flush=True)
                return None
            lib = ctypes.CDLL(str(path))
            lib.gsplat_parse_points3d.restype = ctypes.c_int64
            lib.gsplat_parse_points3d.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ]
            lib.gsplat_parse_images.restype = ctypes.c_int64
            lib.gsplat_parse_images.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.gsplat_parse_cameras.restype = ctypes.c_int64
            lib.gsplat_parse_cameras.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        return _lib


def _require() -> ctypes.CDLL:
    lib = library()
    if lib is None:
        raise Unavailable(f"native COLMAP parser unavailable: {_missing}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_points3d(data: bytes):
    """points3D.bin -> (xyz [n, 3] f32, rgb [n, 3] f32 in 0..255)."""
    lib = _require()
    n = lib.gsplat_parse_points3d(data, len(data), None, None)
    if n < 0:
        raise ValueError("corrupt points3D.bin")
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.float32)
    got = lib.gsplat_parse_points3d(data, len(data), _ptr(xyz, ctypes.c_float),
                                    _ptr(rgb, ctypes.c_float))
    if got != n:
        raise ValueError("corrupt points3D.bin")
    return xyz, rgb


def parse_images(data: bytes):
    """images.bin -> list of dicts (image_id, qvec (w, x, y, z), tvec,
    camera_id, name), in file order."""
    lib = _require()
    names_cap = ctypes.c_int64(0)
    n = lib.gsplat_parse_images(data, len(data), None, None, None, None, None, 0,
                                ctypes.byref(names_cap))
    if n < 0:
        raise ValueError("corrupt images.bin")
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_id = np.empty((n,), np.int32)
    image_id = np.empty((n,), np.int32)
    names_buf = ctypes.create_string_buffer(max(1, names_cap.value))
    got = lib.gsplat_parse_images(
        data, len(data), _ptr(image_id, ctypes.c_int32), _ptr(qvec, ctypes.c_double),
        _ptr(tvec, ctypes.c_double), _ptr(cam_id, ctypes.c_int32), names_buf,
        len(names_buf), None)
    if got != n:
        raise ValueError("corrupt images.bin")
    names = names_buf.raw.split(b"\x00")[:n]
    return [
        dict(image_id=int(image_id[i]), qvec=qvec[i], tvec=tvec[i],
             camera_id=int(cam_id[i]), name=names[i].decode("utf-8"))
        for i in range(n)
    ]


def parse_cameras(data: bytes):
    """cameras.bin -> dict camera_id -> intrinsics dict (width, height, fx,
    fy, cx, cy)."""
    lib = _require()
    cap = max(1, len(data) // 24)  # a camera takes at least 24 bytes
    cam_id = np.empty((cap,), np.int32)
    model_id = np.empty((cap,), np.int32)
    width = np.empty((cap,), np.int64)
    height = np.empty((cap,), np.int64)
    params = np.empty((cap, 8), np.float64)
    n = lib.gsplat_parse_cameras(
        data, len(data), _ptr(cam_id, ctypes.c_int32), _ptr(model_id, ctypes.c_int32),
        _ptr(width, ctypes.c_int64), _ptr(height, ctypes.c_int64),
        _ptr(params, ctypes.c_double))
    if n < 0:
        raise ValueError("corrupt cameras.bin, or a camera model other than "
                         "SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL and OPENCV")
    out = {}
    for i in range(n):
        p = params[i]
        if int(model_id[i]) in (0, 2):  # single focal
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        out[int(cam_id[i])] = dict(width=int(width[i]), height=int(height[i]),
                                   fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy))
    return out
