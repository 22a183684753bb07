"""Run one cell of the benchmark once and print its result as the last line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Every run compares what the
timed path produced with the benchmark's plain reference once the window
has closed, and prints each number compared beside its limit as its last
lines on standard error.  The run fails, and prints no result, without
enough CUDA devices or if a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from . import counts, harness


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device):
    """One run of ``cell`` on ``device``: (Outcome, result line)."""
    import torch

    loop = importlib.import_module(f".{cell.kind}_loop", __package__)  # a kind, a file
    torch.zeros((), device=device)  # the device's context, made before the set-up's steps
    harness.note(f"device ready: {device}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = loop.run(cell, seed, seconds, trace_on, device)
    return out, harness.result_line(cell, out, device, trace_on)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT))
    out, line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    print(f"card: {torch.cuda.get_device_name(0)}, power limit {counts.power_limit_w(0)} W",
          flush=True)
    print(json.dumps(line), flush=True)
    harness.print_checks(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
