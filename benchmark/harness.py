"""What every cell shares: the benchmark's files found by name, the device
checks, the process's age, the check that no JAX module was loaded, the
per-layer metric readers and the result line.

Files, by the names in ``BENCHMARK.json``:

    benchmark/configs/<config>.json     sizes, source, reduced, assumed
    benchmark/traffic/<traffic>.json    a traffic mix: its ``kind`` names
                                        the loop that runs it,
                                        ``benchmark/<kind>_loop.py``
    benchmark/limits/<workload>.json    the limit of each number compared
    benchmark/metrics/<metric>.py       a per-layer metric: ``read(trace,
                                        cell)`` returns a number or None
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplattingmlx_tpu")
_IMPORT_TIME = time.time()


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    spec: dict  # the whole BENCHMARK.json
    root: Path  # where the benchmark's files are

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


@dataclasses.dataclass
class Outcome:
    """What a cell's run measured and compared."""
    metrics: dict  # end-to-end metric -> value
    checks: list  # [(name, value, limit)] numbers compared, each beside its limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None  # trace.Trace of a --trace 1 run


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration, traffic mix and
    limits, from ``root/BENCHMARK.json`` and ``root/benchmark/``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: expected one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(workload, int(w["chips"]), config, traffic, limits, spec, root)


def per_layer(cell: Cell) -> list:
    """The per-layer metrics of ``BENCHMARK.json`` that this cell reports."""
    return [m for m in cell.spec["per_layer"]
            if "workloads" not in m or cell.name in m["workloads"]]


def end_to_end(cell: Cell) -> list:
    return [m for m in cell.spec["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]]


def read_per_layer(cell: Cell, trace) -> dict:
    """Each per-layer metric's reader, ``benchmark/metrics/<name>.py``, on
    the trace; a reader that finds nothing returns None and its metric is
    left out."""
    out = {}
    for m in per_layer(cell):
        path = cell.root / "benchmark" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(trace, cell)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time of the
    process), else since this module was imported."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start, 0.0)
    except (OSError, ValueError, IndexError):
        return time.time() - _IMPORT_TIME


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def note(what: str) -> None:
    """A progress line on standard error, with the process's age."""
    print(f"[{process_age_s():8.2f} s] {what}", file=sys.stderr, flush=True)


def reset_peak(device) -> None:
    """Start the peak of allocated memory afresh: the benchmark's own
    set-up (targets rendered by the reference, the pair-demand probe) does
    not count in the program's peak."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def result_line(cell: Cell, out: Outcome, device, trace_on: bool) -> dict:
    """The last line of a run: correct, attempted, failed, metrics, device,
    (breakdown), and the numbers compared with their limits last."""
    correct = out.failed == 0 and all(v <= lim for _, v, lim in out.checks)
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    line = {"correct": bool(correct), "attempted": int(out.attempted),
            "failed": int(out.failed)}
    if trace_on:
        line["metrics"] = read_per_layer(cell, out.trace)
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        line["device"] = device_info
        line["breakdown"] = out.trace.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in end_to_end(cell)}
        line["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in out.metrics.items()}
        line["device"] = device_info
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line


def print_checks(out: Outcome) -> None:
    for name, value, limit in out.checks:
        verdict = "ok" if value <= limit else "FAILED"
        print(f"check {name} {value!r} limit {limit!r} {verdict}", file=sys.stderr, flush=True)
