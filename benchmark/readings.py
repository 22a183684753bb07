"""The readings that the limits of ``benchmark/limits/<workload>.json`` are
set from, on the card at the cell's own size (not run by the benchmark's
own runs):

    python -m benchmark.readings --workload <name> --seeds 1 2 3 [--out file.json]

For each seed, in one process, the numbers the cell's check compares:

* ``program``: the program against the reference (the lower reading);
* ``control``: the reference computed in bfloat16, put in the program's
  place (the configuration states float32 on the CUDA cores, where TF32
  plays no part, so bfloat16 is the nearest lower precision);
* the faults the cell can have, planted in the program: training
  ``half_batch`` (the loss is the mean over half of the view's pixel rows)
  and ``unchanged`` (a step that returns its state unchanged: Adam does
  nothing); serving ``altered`` (one 16 x 16 block of a frame brightened by
  0.1 where the frame is produced).

Training reads the first three steps and needs no window; serving renders
``check_frames`` frames of seeded path cameras, as many as a run compares.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import sys
from pathlib import Path

import torch

from . import harness, serve_loop, train_loop


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def fault(name: str):
    """Plant one of the faults in the program for the duration."""
    if name == "half_batch":
        from gaussiansplattingmlx_tpu_torch.train import trainer

        whole = trainer.view_loss

        def half(cfg, color, depth, take):
            rows = color.shape[0] // 2
            return whole(cfg, color[:rows], depth[:rows], lambda k: take(k)[:rows])

        with patched(trainer, "view_loss", half):
            yield
    elif name == "unchanged":
        from gaussiansplattingmlx_tpu_torch.train import trainer

        with patched(trainer, "adam_step", lambda cfg, state, *a: state.count):
            yield
    elif name == "altered":
        from gaussiansplattingmlx_tpu_torch import render as render_mod

        whole = render_mod.render

        def altered(*args, **kwargs):
            out, aux = whole(*args, **kwargs)
            color = out.color.clone()
            color[:16, :16] += 0.1
            return out._replace(color=color), aux

        with patched(render_mod, "render", altered):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}")


def train_readings(cell, seed: int, device, faults) -> dict:
    inp = train_loop.make_inputs(cell, seed, device)
    got = train_loop.first_steps(train_loop.Program(cell, inp, device), inp, device)
    train_loop.free(device)
    want = train_loop.reference_steps(cell, inp, device)
    out = {"program": train_loop.compare(got, want),
           "program_loss_steps": [abs(p - r) / abs(r) for p, r in zip(got.loss, want.loss)]}
    low = train_loop.reference_steps(cell, inp, device, torch.bfloat16)
    out["control"] = train_loop.compare(low, want)
    for name in faults:
        with fault(name):
            bad = train_loop.first_steps(train_loop.Program(cell, inp, device), inp, device)
        train_loop.free(device)
        out[name] = train_loop.compare(bad, want)
    return out


def serve_readings(cell, seed: int, device, faults) -> dict:
    fit, table, _, budget = serve_loop.make_inputs(cell, seed, device)
    rng = random.Random(seed)
    cams = [rng.randrange(table["view"].shape[0]) for _ in range(cell.traffic["check_frames"])]
    want = serve_loop.reference_frames(cell, fit, table, cams, device)
    frame = serve_loop.renderer(cell, fit, table, budget, [])
    out = {"program": serve_loop.compare([frame(c) for c in cams], want)}
    low = serve_loop.reference_frames(cell, fit, table, cams, device, torch.bfloat16)
    out["control"] = serve_loop.compare(low, want)
    for name in faults:
        with fault(name):
            frame = serve_loop.renderer(cell, fit, table, budget, [])
            out[name] = serve_loop.compare([frame(c) for c in cams], want)
    return out


FAULTS = {"train": ("half_batch",), "serve": ("altered",)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    read = {"train": train_readings, "serve": serve_readings}[cell.kind]
    rows = []
    for seed in args.seeds:
        row = {"seed": seed, **read(cell, seed, "cuda:0", FAULTS[cell.kind])}
        print(json.dumps(row), flush=True)
        rows.append(row)
        train_loop.free("cuda:0")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
