#!/usr/bin/env python3
"""A/B of forward-compositing (K1) sources on one NVIDIA GPU.

    python3 scripts/torch_k1_ab.py [--sources a.cu b.cu ...] [--out ab.json]

Builds the port's ``csrc/rasterize_fwd.cu`` and every ``--sources`` file
(each a variant of it that exports the same ``gsplat_raster_fwd`` C entry
point, compiled with the port's nvcc flags into its own library), then on
the serving buffer (``chip_smoke.py``'s bench camera, tile 16, auto budget)
and on the sorted training run's first-step buffers of views 0 and 2 (tile
32, the probed budget): checks each against the plain version (the image
tolerances) and bit for bit against the port's kernel, prints the share of
the pixel-records that a one-pixel-a-thread warp of 32 consecutive pixels
issues and its pixels take (the lanes a stopped pixel leaves idle), and
times every source three times in turns (device time, ``device_ms``),
forwards, backwards, forwards.  Prints ``ptxas`` registers and spills of
each source.  PR 4's kernel, for instance, is
``git show e32fcfd:gaussiansplattingmlx_tpu_torch/csrc/rasterize_fwd.cu``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def build(sources: dict, outdir: Path):
    """name -> ctypes function, name -> ptxas lines; one nvcc per source."""
    from gaussiansplattingmlx_tpu_torch.ops import _kernels, rasterize_cuda

    nvcc = _kernels._nvcc()
    procs = {}
    for name, src in sources.items():
        cmd = [nvcc, *_kernels.NVCC_FLAGS, "-shared", "-I", str(_kernels.CSRC_DIR), "-o",
               str(outdir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{log}")
        ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
        fn = ctypes.CDLL(str(outdir / f"{name}.so")).gsplat_raster_fwd
        fn.argtypes = rasterize_cuda.KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def launch(fn, fargs, out) -> None:
    rec, start, count, grid_w, grid_h, tile_w, tile_h = fargs
    err = fn(rec.data_ptr(), rec.shape[1], start.data_ptr(), count.data_ptr(), grid_w * grid_h,
             grid_w, tile_w, tile_h, 0.99, 1e-4, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gsplat_raster_fwd: CUDA error {err}")


def lane_share(ncon: torch.Tensor) -> float:
    """Pixel-records taken over those a warp of 32 consecutive pixels issues
    (each record while any of its lanes is alive)."""
    warps = ncon.reshape(ncon.shape[0], -1, 32)
    return float(ncon.sum()) / float(warps.max(dim=2).values.sum() * 32)


def buffers(device) -> dict:
    import chip_smoke as smoke
    from gaussiansplattingmlx_tpu_torch.ops import staging

    bufs = {}
    with tempfile.TemporaryDirectory(prefix="k1_ab_") as tmp:
        ply_path = Path(tmp) / "bench_scene.ply"
        smoke.bench_scene(ply_path)
        args, _, st = smoke.bench_geometry(ply_path, device)
        with torch.no_grad():
            sp = staging.stage_pairs_sorted(st, *args)
        grid = (-(-st.image_width // st.tile_w), -(-st.image_height // st.tile_h))
        bufs["serving, tile 16"] = (sp.records_cm, sp.tile_start, sp.tile_count, *grid,
                                    st.tile_w, st.tile_h)
        data = smoke.orbit_targets(ply_path, device)
        trainer, _, _ = smoke.training_setup(ply_path, data, device)
        for view in (0, 2):
            targs, tst = smoke.first_step_geometry(trainer, view)
            with torch.no_grad():
                tsp, _ = staging._stage_train_impl(tst, *targs)
            grid = (-(-tst.image_width // tst.tile_w), -(-tst.image_height // tst.tile_h))
            bufs[f"training view {view}, tile 32"] = (tsp.records_cm, tsp.tile_start,
                                                      tsp.tile_count, *grid, tst.tile_w,
                                                      tst.tile_h)
    return bufs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sources", nargs="*", default=[], help="variant .cu files")
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from gaussiansplattingmlx_tpu_torch.ops import _kernels, rasterize_cuda

    gpu = smoke.gpu_line()
    _kernels.LIBRARY.cdll()  # the staging's kernels
    sources = {"port": _kernels.CSRC_DIR / "rasterize_fwd.cu"}
    sources.update({Path(s).stem: Path(s).resolve() for s in args.sources})
    names = list(sources)
    with tempfile.TemporaryDirectory(prefix="k1_ab_build_") as build_dir:
        fns, ptxas = build(sources, Path(build_dir))
        for name in names:
            print(f"{name}: {sources[name].name}; ptxas {' | '.join(ptxas[name])}", flush=True)
        device = torch.device("cuda:0")
        results = {}
        for bname, fargs in buffers(device).items():
            ntiles, tt = fargs[3] * fargs[4], fargs[5] * fargs[6]
            outs = {n: torch.empty((ntiles, 6, tt), device=device) for n in names}
            for n in names:
                launch(fns[n], fargs, outs[n])
            want = rasterize_cuda.raster_fwd_plain(*fargs)
            torch.cuda.synchronize()
            taken = float(outs["port"][:, 5].sum())
            lim = smoke.bound(4.0 * (11 * int(fargs[2].sum()) + 2 * ntiles + want.numel()),
                              smoke.K1_OPS * taken)
            share = lane_share(outs["port"][:, 5])
            print(f"{bname}: {int(fargs[2].sum())} pairs, {taken:.0f} pixel-records, bound "
                  f"{lim['bound_ms']:.4f} ms; warps of 32 pixels take {share:.3f} of the "
                  f"pixel-records they issue | {gpu}", flush=True)
            entry = {"pixel_records": taken, **lim, "lane_share": share, "sources": {}}
            for n in names:
                got = outs[n]
                torch.testing.assert_close(got[:, :3], want[:, :3], rtol=smoke.COLOR_RTOL,
                                           atol=smoke.COLOR_ATOL)
                torch.testing.assert_close(got[:, 3], want[:, 3], rtol=smoke.DEPTH_RTOL,
                                           atol=smoke.DEPTH_ATOL)
                torch.testing.assert_close(got[:, 4], want[:, 4], rtol=smoke.COLOR_RTOL,
                                           atol=smoke.COLOR_ATOL)
                entry["sources"][n] = {"bit_equal_to_port": smoke.bit_equal(got, outs["port"]),
                                       "ms": []}
            del want
            for order in (names, names[::-1], names):
                for n in order:
                    out = outs[n]
                    entry["sources"][n]["ms"].append(
                        smoke.device_ms(lambda: launch(fns[n], fargs, out)))
            for n in names:
                e = entry["sources"][n]
                print(f"  {n:24s} {' '.join(f'{x:.4f}' for x in e['ms'])} ms, median "
                      f"{np.median(e['ms']):.4f}; bit-equal to the port's: "
                      f"{e['bit_equal_to_port']}", flush=True)
            results[bname] = entry
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"gpu": gpu, "ptxas": ptxas, "buffers": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
