"""One run of the port's flagship campaign with what its summary leaves out:
peak device memory, the wall time of the whole call, device memory over
the run, each kernel's launches in the run, and at the end the device's
busy share of a training step and the host syncs one step makes.

    python scripts/torch_flagship_run.py --report outputs/a/report.json \\
        --keep outputs/a -- \\
        --iters 30000 --out outputs/flagship_a [train_flagship flags]

Everything after ``--`` goes to ``python -m
gaussiansplattingmlx_tpu_torch.train_flagship`` (run in this process).
``--keep DIR`` copies the small outputs (metrics.jsonl, summary.json,
gt_view0.png, loss_curve.png, holdout/) into DIR.  After the run,
PROFILE_STEPS more training steps (they change the trainer's state, never
the files already written) are profiled with ``torch.profiler`` for the
device's busy time a step and timed between device synchronisations for
the wall time a step, and one more runs under
``torch.cuda.set_sync_debug_mode("warn")`` to count its host syncs.  The
report's ``tail`` is the train PSNR / SSIM over the last 20 logged rows (the
JAX records' measure).  A run cut short resumes from the checkpoints in
``--out`` with ``--resume``.
Imports torch, numpy and the port (no JAX).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from gaussiansplattingmlx_tpu_torch import bench, train_flagship  # noqa: E402
from gaussiansplattingmlx_tpu_torch.ops import _kernels  # noqa: E402

KEEP = ("metrics.jsonl", "summary.json", "gt_view0.png", "loss_curve.png", "holdout")
MEMORY_SAMPLE_S = 30.0
# The JAX package's records quote the mean PSNR of the last 20 logged rows
# (BASELINE.md's flagship row); each row is one training view.
TAIL_ROWS = 20
PROFILE_STEPS = 3


def gpu_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def sample_memory(samples: list, stop: threading.Event, t0: float) -> None:
    """(seconds, allocated GiB, reserved GiB) every MEMORY_SAMPLE_S."""
    while not stop.wait(MEMORY_SAMPLE_S):
        samples.append((round(time.perf_counter() - t0, 1),
                        torch.cuda.memory_allocated() / 2**30,
                        torch.cuda.memory_reserved() / 2**30))


def tail_stats(rows: list) -> dict:
    """Train PSNR and SSIM over the last TAIL_ROWS logged rows, with the
    steps and pairs a view at the end."""
    tail = rows[-TAIL_ROWS:]
    if not tail:
        return {}
    psnr = [r["psnr"] for r in tail]
    return {"rows": len(tail), "from_iteration": tail[0]["iteration"],
            "psnr_mean": sum(psnr) / len(psnr), "psnr_max": max(psnr),
            "psnr_min": min(psnr), "ssim_mean": sum(r["ssim"] for r in tail) / len(tail),
            "num_pairs_mean": sum(r["num_pairs"] for r in tail) / len(tail)}


def step_profile(trainer, steps: int) -> dict:
    """Busy device ms a step (profiler), wall ms a step (host clock between
    synchronisations) and host syncs a step, over training steps of the
    trainer's current state on view 0."""

    def step():
        trainer.state, _, _ = trainer.train_step(trainer.state, trainer.views, 0)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    busy_ms, events = bench.device_busy_ms(step, steps)
    syncs = bench.host_syncs(step)
    return {"steps": steps, "wall_ms": wall_ms, "busy_ms": busy_ms, "events": events,
            "idle_share": 1.0 - busy_ms / wall_ms, "host_syncs": sum(syncs.values()),
            "host_syncs_at": syncs, "max_pairs": trainer.cfg.raster.max_pairs,
            "capacity": trainer.state.params.capacity,
            "num_active": int(trainer.state.num_active)}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--report", required=True, help="JSON report path")
    ap.add_argument("--keep", default=None, help="copy the small outputs here")
    args = ap.parse_args(argv[:split])
    flags = argv[split + 1:]
    out = Path(train_flagship.parse_args(flags).out)
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    samples, stop = [], threading.Event()
    t0 = time.perf_counter()
    threading.Thread(target=sample_memory, args=(samples, stop, t0), daemon=True).start()
    torch.cuda.reset_peak_memory_stats()
    before = _kernels.launch_counts()
    try:
        res = train_flagship.run(flags)
    finally:
        stop.set()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _kernels.launch_counts()
    rows, logged_wall = train_flagship.merge_metric_segments(out / "metrics.jsonl")
    report = {
        "gpu": gpu, "flags": flags, "wall_s": wall,
        "last_logged_iteration": rows[-1]["iteration"] if rows else None,
        "last_logged": rows[-1] if rows else None,
        "logged_wall_s": logged_wall,
        "tail": tail_stats(rows),
        "checkpoints": sorted(p.name for p in out.glob("ckpt_*.npz")),
        "launches": {k: after[k] - before[k] for k in after},
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
        "memory_samples": samples,
        "summary": res.summary,
        "end_step_profile": step_profile(res.trainer, PROFILE_STEPS),
    }
    if args.keep:
        keep = Path(args.keep)
        keep.mkdir(parents=True, exist_ok=True)
        for name in KEEP:
            src = out / name
            if src.is_dir():
                shutil.copytree(src, keep / name, dirs_exist_ok=True)
            elif src.exists():
                shutil.copy2(src, keep / name)
    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(json.dumps(report, indent=1))
    brief = {k: report[k] for k in ("wall_s", "last_logged_iteration",
                                    "peak_allocated_gib", "peak_reserved_gib")}
    print(f"flagship run report: {json.dumps(brief)} | {gpu}", flush=True)
    return report


if __name__ == "__main__":
    main()
