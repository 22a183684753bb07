"""Hierarchical wall-clock section profiler and a ``torch.profiler`` trace
helper (torch counterpart of the JAX package's ``utils/profiler.py``).

``IntervalProfiler``: nested ``measure("name")`` scopes with self / total /
count accounting and a top-K report.  The device runs behind the host, so a
section that should hold its device time passes ``sync_on=`` the tensors it
produced: the scope waits for their CUDA devices before it closes.  For
kernel-level analysis, ``trace()`` records a ``torch.profiler`` trace (CPU
and, where there is a card, CUDA activity) and writes it as a Chrome trace
(view it in Perfetto or chrome://tracing).

Nothing on the training or serving path imports this module.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import torch


@dataclass
class _Section:
    total: float = 0.0
    child: float = 0.0
    count: int = 0

    @property
    def self_time(self) -> float:
        return self.total - self.child


def cuda_devices(obj) -> set:
    """The CUDA devices of every tensor in ``obj`` (a tensor, or lists,
    tuples, named tuples and dicts of them)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.device.type == "cuda" else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(cuda_devices(x) for x in obj)) if obj else set()
    return set()


class IntervalProfiler:
    """Nested-scope timer with parent-child attribution."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.sections: Dict[str, _Section] = {}
        self._stack: List[List] = []  # frames: [name, start, child_accum]

    @contextlib.contextmanager
    def measure(self, name: str, sync_on=None):
        """Time a scope.  ``sync_on``: tensors whose CUDA devices are
        synchronised before the scope closes, so that their device time
        lands in this section (CPU tensors need no wait)."""
        if not self.enabled:
            yield
            return
        self._stack.append([name, time.perf_counter(), 0.0])
        try:
            yield
        finally:
            for device in cuda_devices(sync_on):
                torch.cuda.synchronize(device)
            frame = self._stack.pop()
            elapsed = time.perf_counter() - frame[1]
            sec = self.sections.setdefault(name, _Section())
            sec.total += elapsed
            sec.child += frame[2]
            sec.count += 1
            if self._stack:
                self._stack[-1][2] += elapsed

    def report(self, top_k: int = 12) -> str:
        """Top-K sections by self time."""
        rows = sorted(
            self.sections.items(), key=lambda kv: kv[1].self_time, reverse=True
        )[:top_k]
        lines = [f"{'section':40s} {'self(ms)':>10s} {'total(ms)':>10s} {'count':>7s}"]
        for name, sec in rows:
            lines.append(
                f"{name:40s} {sec.self_time * 1e3:10.2f} "
                f"{sec.total * 1e3:10.2f} {sec.count:7d}"
            )
        return "\n".join(lines)

    def reset(self):
        self.sections.clear()


@contextlib.contextmanager
def trace(log_dir: str = "outputs/torch-trace"):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when a card is present) and write it into ``log_dir`` as
    ``trace_<pid>_<n>.json``.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))
    print(f"trace written to {log_dir}")
