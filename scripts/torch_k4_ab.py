#!/usr/bin/env python3
"""A/B of per-Gaussian segment-sum (K4) sources on one NVIDIA GPU.

    python3 scripts/torch_k4_ab.py [--sources a.cu b.cu ...] [--cli] [--out ab.json]

Runs the port's K4 (``segsum_cuda.segment_sum_sorted``, ``csrc/segsum.cu``
in the port's kernel library) beside every ``--sources`` file (each a
variant that exports the ``gsplat_segsum`` C entry point, compiled with the
port's nvcc flags into its own library; a variant without
``gsplat_segsum_carries`` takes the earlier signature, which has no carry
arrays), then takes K4's inputs (K3's rows for the L1 + SSIM cotangent,
sorted by ``sort_by_gid``) from ``chip_smoke.py``'s bench camera at tile 16
and the sorted training run's first-step buffer at tile 32, and with
``--cli`` from the last buffer of its 800x800 ``train_cli`` run (SH4, tile
16, the default config).  Each buffer is also taken twice more with the
segments cut short: the longest one cut to the 99th percentile of the
non-empty lengths (``cut_longest``), and every one cut to it
(``cut_all``); the cut columns are dropped, the width stays.  On every
buffer it prints the segment profile and the bound, checks each source
against the plain version (``chip_smoke.py``'s K4 tolerance) and two
launches for equal bits, and times every source three times in turns
(device time, ``device_ms``), forwards, backwards, forwards, beside
``torch.segment_reduce``.  Prints ``ptxas`` registers and spills of each
source.  A source whose name starts with ``probe_`` (a stripped-down kernel
that isolates one cost, such as ``scripts/probe_k4_stream.cu``, a plain
streaming read of K4's bytes) is timed but not checked.  The previous K4,
for instance, is ``git show
5b45c3e:gaussiansplattingmlx_tpu_torch/csrc/segsum.cu``.  Imports no JAX.
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


class Source:
    """One compiled K4 source and how to launch it."""

    def __init__(self, lib: ctypes.CDLL):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        self.fn = lib.gsplat_segsum
        self.fn.restype = ctypes.c_int
        self.carries = getattr(lib, "gsplat_segsum_carries", None)
        if self.carries is None:
            self.fn.argtypes = [ptr, i64, ptr, i32, ptr, ptr]
        else:
            self.fn.argtypes = [ptr, i64, ptr, i32, ptr, ptr, ptr, ptr]
            self.carries.argtypes = [i64, i32]
            self.carries.restype = i64

    def __call__(self, rows_s: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        num_rec, cols = offsets.shape[0] - 1, rows_s.shape[1]
        out = torch.empty((num_rec, 16), dtype=torch.float32, device=rows_s.device)
        stream = torch.cuda.current_stream().cuda_stream
        if self.carries is None:
            err = self.fn(rows_s.data_ptr(), cols, offsets.data_ptr(), num_rec, out.data_ptr(),
                          stream)
        else:
            carries = self.carries(cols, num_rec)
            seg = torch.empty(carries, dtype=torch.int32, device=rows_s.device)
            carry = torch.empty((carries, 20), dtype=torch.float32, device=rows_s.device)
            err = self.fn(rows_s.data_ptr(), cols, offsets.data_ptr(), num_rec, out.data_ptr(),
                          seg.data_ptr(), carry.data_ptr(), stream)
        if err != 0:
            from gaussiansplattingmlx_tpu_torch.ops import _kernels

            msg = _kernels.LIBRARY.cdll().gsplat_error_string(err).decode()
            raise RuntimeError(f"gsplat_segsum: CUDA error {err}: {msg}")
        return out


class PortSource:
    """The port's K4 as the program runs it: ``segment_sum_sorted`` through
    the kernel library."""

    def __call__(self, rows_s: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        from gaussiansplattingmlx_tpu_torch.ops import segsum_cuda

        return segsum_cuda.segment_sum_sorted(rows_s, offsets)


def build(sources: dict, outdir: Path):
    """name -> Source, name -> ptxas lines; one nvcc per source."""
    from gaussiansplattingmlx_tpu_torch.ops import _kernels

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
        fns[name] = Source(ctypes.CDLL(str(outdir / f"{name}.so")))
    return fns, ptxas


def k3_rows(smoke, args, st, target, width, height):
    """(K3's rows [16, P] for the L1 + SSIM cotangent, the gid [P]) of a
    training buffer."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, staging

    with torch.no_grad():
        sp, gid = staging._stage_train_impl(st, *args)
    smoke.require(int(sp.overflow_pairs) == 0, "training staging overflows")
    tile = st.tile_w
    block, _ = smoke.loss_cotangent_block(sp.records_cm, sp.tile_start, sp.tile_count,
                                          width, height, tile, target)
    rows = rasterize_cuda.raster_bwd(sp.records_cm, sp.tile_start, sp.tile_count, block,
                                     -(-width // tile), -(-height // tile), tile, tile)
    return rows, gid


def buffers(device, cli: bool) -> dict:
    """name -> (rows_s [10, P], offsets [num_rec + 1]) sorted by gid."""
    import chip_smoke as smoke
    from gaussiansplattingmlx_tpu_torch.ops import segsum_cuda

    bufs = {}
    with tempfile.TemporaryDirectory(prefix="k4_ab_") as tmp:
        ply_path = Path(tmp) / "bench_scene.ply"
        smoke.bench_scene(ply_path)
        args, _, st = smoke.bench_geometry(ply_path, device)
        data = smoke.orbit_targets(ply_path, device)
        target = torch.as_tensor(data.images[0]).to(device)
        rows, gid = k3_rows(smoke, args, st, target, smoke.WIDTH, smoke.HEIGHT)
        bufs["bench camera, tile 16"] = segsum_cuda.sort_by_gid(rows, gid, smoke.N_GAUSSIANS)
        trainer, _, _ = smoke.training_setup(ply_path, data, device)
        targs, tst = smoke.first_step_geometry(trainer)
        rows, gid = k3_rows(smoke, targs, tst, trainer.views["target_rgb"][0], smoke.WIDTH,
                            smoke.HEIGHT)
        bufs["training, tile 32"] = segsum_cuda.sort_by_gid(rows, gid,
                                                            trainer.state.params.capacity)
        del trainer
        if cli:
            counters = {"segsum": segsum_cuda.KERNEL}
            from gaussiansplattingmlx_tpu_torch.ops import merge_cuda, rasterize_cuda
            counters.update(merge_gather=merge_cuda.KERNEL, raster_fwd=rasterize_cuda.KERNEL,
                            raster_bwd=rasterize_cuda.BWD_KERNEL)

            def expect(**launched):
                return {name: launched.get(name, 0) for name in counters}

            trainer, _ = smoke.run_full(Path(tmp), counters, expect, smoke.gpu_line())
            targs, tst = smoke.first_step_geometry(trainer)
            size = trainer.data.width, trainer.data.height
            rows, gid = k3_rows(smoke, targs, tst, trainer.views["target_rgb"][0], *size)
            bufs["800x800 CLI run, tile 16"] = segsum_cuda.sort_by_gid(
                rows, gid, trainer.state.params.capacity)
            del trainer
    return bufs


def cut(rows_s, offsets, cap, only_longest):
    """The buffer with segments cut to ``cap`` columns (only the longest one
    with ``only_longest``): the cut columns dropped, the width kept."""
    lengths = (offsets[1:] - offsets[:-1]).long()
    new = lengths.clamp(max=cap)
    if only_longest:
        new = lengths.clone()
        g = int(lengths.argmax())
        new[g] = min(int(lengths[g]), cap)
    starts = offsets[:-1].long()
    seg = torch.repeat_interleave(torch.arange(lengths.numel(), device=rows_s.device), new)
    first = torch.repeat_interleave(torch.cumsum(new, 0) - new, new)
    keep = starts[seg] + torch.arange(seg.numel(), device=rows_s.device) - first
    out = torch.zeros_like(rows_s)
    out[:, :keep.numel()] = rows_s[:, keep]
    offs = torch.zeros_like(offsets)
    offs[1:] = torch.cumsum(new, 0).to(torch.int32)
    return out, offs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sources", nargs="*", default=[], help="variant .cu files")
    ap.add_argument("--cli", action="store_true",
                    help="also the 800x800 train_cli run's last buffer (~1 min more)")
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k4_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from gaussiansplattingmlx_tpu_torch.ops import _kernels, segsum_cuda

    gpu = smoke.gpu_line()
    _kernels.LIBRARY.cdll()  # the staging's and K3's kernels
    sources = {Path(s).stem: Path(s).resolve() for s in args.sources}
    names = ["port", *sources]
    results = {"gpu": gpu, "buffers": {}}
    # The buffers first: the sources' libraries are loaded after the runs
    # that make them.
    bufs = buffers(torch.device("cuda:0"), args.cli)
    with tempfile.TemporaryDirectory(prefix="k4_ab_build_") as build_dir:
        fns, ptxas = build(sources, Path(build_dir))
        fns["port"] = PortSource()
        print(f"port: csrc/segsum.cu in {_kernels.LIBRARY.path.name}", flush=True)
        for name in sources:
            print(f"{name}: {sources[name].name}; ptxas {' | '.join(ptxas[name])}", flush=True)
        for bname, (rows_s, offsets) in bufs.items():
            profile = smoke.segment_profile(offsets)
            variants = {"as is": (rows_s, offsets)}
            cap = max(1, int(profile["p99"]))
            variants[f"cut_longest to {cap}"] = cut(rows_s, offsets, cap, True)
            variants[f"cut_all to {cap}"] = cut(rows_s, offsets, cap, False)
            for vname, (rs, offs) in variants.items():
                prof = smoke.segment_profile(offs)
                used, num_rec = prof["pairs"], prof["rows"]
                lim = smoke.bound(4.0 * (10 * used + offs.numel() + 16 * num_rec), 10 * used)
                want = segsum_cuda.segment_sum_sorted_plain(rs, offs)
                atol = smoke.SEGSUM_ATOL * float(want.abs().max())
                for n in names:
                    if n.startswith("probe_"):  # timed only: a probe computes no sums
                        continue
                    got, again = fns[n](rs, offs), fns[n](rs, offs)
                    torch.cuda.synchronize()
                    smoke.require(smoke.bit_equal(got, again), f"{n}: two launches differ")
                    torch.testing.assert_close(got, want, rtol=smoke.SEGSUM_RTOL, atol=atol)
                times = {n: [] for n in names}
                for order in (names, names[::-1], names):
                    for n in order:
                        times[n].append(smoke.device_ms(lambda: fns[n](rs, offs)))
                lengths = (offs[1:] - offs[:-1]).long()
                data = rs[:, :used].T.contiguous()
                library_ms = smoke.device_ms(lambda: torch.segment_reduce(
                    data, "sum", lengths=lengths, unsafe=True))
                entry = {"profile": prof, **lim, "library_ms": library_ms,
                         "ms": {n: times[n] for n in names}}
                results["buffers"][f"{bname}, {vname}"] = entry
                ms = ", ".join(f"{n} {float(np.median(times[n])):.4f} "
                               f"({lim['bound_ms'] / float(np.median(times[n])):.0%})"
                               for n in names)
                print(f"{bname}, {vname}: {json.dumps(prof)}; bound {lim['bound_ms']:.4f} ms "
                      f"({lim['bound_by']}); median ms (share of bound) {ms}; "
                      f"torch.segment_reduce {library_ms:.4f} | {gpu}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
