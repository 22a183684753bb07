#!/usr/bin/env python3
"""Times the port's native COLMAP parsers against its Python parsers.

    python3 scripts/torch_colmap_parse_bench.py [--points 1000000] [--images 300]
        [--points2d 5000] [--repeats 3] [--out parse.json]

Writes a COLMAP ``sparse/`` of the stated size from ``--seed`` into a
temporary directory, in bulk with numpy: ``points3D.bin`` with ``--points``
points whose track lengths are drawn from 2..10, ``images.bin`` with
``--images`` images of about ``--points2d`` 2D points each, and
``cameras.bin`` with one PINHOLE camera (a scene shot with one camera).
Builds the native library afresh into a temporary directory (the compile a
fresh checkout pays at first use), checks that ``data/colmap.py``'s readers through
the native library and its Python readers give equal bits on each file,
and times both ``--repeats`` times in turns on the host clock (each a whole
reader call: the file read, the parse and, for images.bin, the poses).
Prints the times (min and median ms), the host's CPU count, the card's
name and power limit where ``nvidia-smi`` is present, and one JSON object
as the last line.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gaussiansplattingmlx_tpu_torch.data import colmap, native_io  # noqa: E402

POINT_HEADER = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                         ("error", "<f8"), ("track_len", "<u8")])  # 51 bytes, packed


def points3d_bytes(n: int, rng: np.random.Generator) -> bytes:
    """points3D.bin of n points with random tracks of 2..10 entries."""
    track = rng.integers(2, 11, n).astype(np.uint64)
    rec = POINT_HEADER.itemsize + 8 * track.astype(np.int64)
    starts = 8 + np.concatenate([[0], np.cumsum(rec)[:-1]])
    out = rng.integers(0, 256, int(8 + rec.sum()), dtype=np.uint8)  # the tracks' bytes
    out[:8] = np.frombuffer(struct.pack("<Q", n), np.uint8)
    head = np.empty(n, POINT_HEADER)
    head["id"] = np.arange(1, n + 1)
    head["xyz"] = rng.normal(0.0, 10.0, (n, 3))
    head["rgb"] = rng.integers(0, 256, (n, 3))
    head["error"] = rng.uniform(0.0, 2.0, n)
    head["track_len"] = track
    raw = head.view(np.uint8).reshape(n, POINT_HEADER.itemsize)
    cols = np.arange(POINT_HEADER.itemsize)
    for lo in range(0, n, 1 << 16):  # bounded index arrays
        hi = min(n, lo + (1 << 16))
        out[starts[lo:hi, None] + cols] = raw[lo:hi]
    return out.tobytes()


def images_bytes(n: int, points2d: int, rng: np.random.Generator) -> bytes:
    parts = [struct.pack("<Q", n)]
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        parts.append(struct.pack("<i7di", i + 1, *q, *rng.normal(size=3), 1))
        parts.append(f"frame_{i:05d}.jpg".encode() + b"\x00")
        npts = int(rng.integers(points2d // 2, points2d * 3 // 2 + 1))
        pts = np.empty(npts, np.dtype([("xy", "<f8", 2), ("id", "<i8")]))
        pts["xy"] = rng.uniform(0.0, 1920.0, (npts, 2))
        pts["id"] = rng.integers(-1, 1 << 20, npts)
        parts.append(struct.pack("<Q", npts) + pts.tobytes())
    return b"".join(parts)


def cameras_bytes() -> bytes:
    return struct.pack("<QiiQQ4d", 1, 1, 1, 1920, 1080, 1500.0, 1501.0, 960.0, 540.0)


def gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--images", type=int, default=300)
    ap.add_argument("--points2d", type=int, default=5000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        sparse = Path(tmp) / "sparse"
        sparse.mkdir()
        t0 = time.perf_counter()
        files = {"cameras.bin": cameras_bytes(),
                 "images.bin": images_bytes(args.images, args.points2d, rng),
                 "points3D.bin": points3d_bytes(args.points, rng)}
        for name, data in files.items():
            (sparse / name).write_bytes(data)
        make_s = time.perf_counter() - t0

        native_io.BUILD_DIR = Path(tmp) / "_build"  # a fresh build, as a new checkout's
        t0 = time.perf_counter()
        native_io.library()
        build_s = time.perf_counter() - t0

        parsers = {
            "cameras.bin": (colmap.read_cameras_bin, colmap.read_cameras_bin_plain),
            "images.bin": (colmap.read_images_bin, colmap.read_images_bin_plain),
            "points3D.bin": (colmap.read_points3d_bin, colmap.read_points3d_bin_plain),
        }
        result = {"points": args.points, "images": args.images,
                  "points2d_per_image": args.points2d, "repeats": args.repeats,
                  "seed": args.seed, "cpu_count": os.cpu_count(),
                  "make_s": make_s, "build_s": build_s, "files": {}}
        for name, (native, plain) in parsers.items():
            native_ms, plain_ms = [], []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                got = native(sparse / name)
                native_ms.append(1e3 * (time.perf_counter() - t0))
                t0 = time.perf_counter()
                want = plain(sparse / name)
                plain_ms.append(1e3 * (time.perf_counter() - t0))
            if not _equal(got, want):
                print(f"{name}: the native parser differs from the Python parser",
                      file=sys.stderr)
                return 1
            result["files"][name] = {
                "bytes": len(files[name]),
                "native_ms_min": min(native_ms), "native_ms_median": float(np.median(native_ms)),
                "plain_ms_min": min(plain_ms), "plain_ms_median": float(np.median(plain_ms))}
    result["gpu"] = gpu_line()
    for name, r in result["files"].items():
        print(f"{name} ({r['bytes']} bytes): native {r['native_ms_min']:.3f} ms, Python "
              f"{r['plain_ms_min']:.3f} ms (min of {args.repeats}, host clock, "
              f"{os.cpu_count()} CPUs) | {result['gpu']}", flush=True)
    print(f"native library built in {build_s:.3f} s | {result['gpu']}", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


def _equal(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


if __name__ == "__main__":
    sys.exit(main())
