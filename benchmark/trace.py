"""Reading a ``torch.profiler`` trace of a window: the device's busy time,
device time by kernel name and by group, each kernel's launches in order,
and the longest idle gaps of the device by what the host was doing.

The window that the busy time, the kernel times and the per-layer metrics
come from is profiled with CUDA activity alone: recording every host
operation as well slows a host-paced step by more than half, and the idle
share would then be mostly the profiler's.  The idle gaps are named from a
second, shorter pass that records host operations too (``host=True``), so
their lengths there include that overhead.

The profiler's Chrome trace is written into the run's temporary directory,
read and deleted.  Device operations are its ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` events; host operations its CPU-side events.  A gap is
the time between two device operations; it is named after the innermost
host operation running at its middle, or ``no_host_operation``.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
# Kernel groups by name, first match wins.  "staging": sorts, scans and
# searches, gathers and scatters (PyTorch's index kernels), the merge kernels
# (K2, K5) and the relayout (K6); "elementwise": PyTorch's other
# elementwise, reduce, concatenation and fill kernels and the device's
# memsets; "copy": memcpys.  Names cannot tell which layer launched a
# kernel: a gather of the projection's backward counts as staging, a
# ``torch.where`` over the pair slots as elementwise.
GROUPS = (
    ("k1", re.compile(r"raster_fwd_kernel")),
    ("k3", re.compile(r"raster_bwd_kernel")),
    ("k4", re.compile(r"segsum(_carry)?_kernel")),
    ("staging", re.compile(r"merge_gather_kernel|merge_ranks_kernel|relayout_kernel|"
                           r"[Ss]ort|[Ss]can|searchsorted|cub::|index_elementwise|"
                           r"indexSelect|index_put|[Gg]ather|[Ss]catter")),
    ("copy", re.compile(r"^Memcpy")),
    ("elementwise", re.compile(r".")),
)
TOP = 10


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if pattern.search(name):
            return group
    return "elementwise"


def short(name: str) -> str:
    """A name cut to 64 characters of letters, digits, '_', '.', ':' and '-'."""
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


@dataclass
class Trace:
    """What one traced window recorded."""
    window_s: float
    busy_s: float
    steps: int
    ops: list  # [(name, start_us, dur_us)] device operations in order
    gaps: list  # [(host operation, seconds)] every idle gap
    extra: dict = field(default_factory=dict)

    def group_s(self, group: str) -> float:
        return sum(d for n, _, d in self.ops if group_of(n) == group) / 1e6

    def launches(self, group: str) -> list:
        """Seconds of each device operation of ``group``, in order."""
        return [d / 1e6 for n, _, d in self.ops if group_of(n) == group]

    def breakdown(self) -> dict:
        by_op, by_gap = {}, {}
        for n, _, d in self.ops:
            by_op[short(n)] = by_op.get(short(n), 0.0) + d / 1e6
        for n, s in self.gaps:
            by_gap[short(n)] = by_gap.get(short(n), 0.0) + s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def _busy_us(ops) -> float:
    """The union of the operations' intervals."""
    busy, end = 0.0, None
    for _, s, d in ops:
        if end is None or s >= end:
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    return busy


def _gaps(ops, host) -> list:
    """Each gap between device operations, named by the innermost host
    operation (latest started, not yet ended) at its middle."""
    out, end = [], None
    mids = []
    for _, s, d in ops:
        if end is not None and s > end:
            mids.append(((s + end) / 2.0, (s - end) / 1e6))
        end = s + d if end is None else max(end, s + d)
    host = sorted(host, key=lambda h: h[1])
    heap, i = [], 0
    for mid, secs in mids:
        while i < len(host) and host[i][1] <= mid:
            name, s, d = host[i]
            heapq.heappush(heap, (-s, s + d, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append((heap[0][2] if heap else "no_host_operation", secs))
    return out


def read_chrome_trace(path: str):
    """(device operations, host operations) of a Chrome trace, each
    [(name, start_us, dur_us)], device operations sorted by start."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") in HOST_CATS:
            host.append(item)
    dev.sort(key=lambda x: x[1])
    return dev, host


@contextlib.contextmanager
def traced(steps: int, device, host: bool = False):
    """Profile the block (CUDA activity on a CUDA ``device``; CPU activity
    too where ``host`` or off the card); yields a dict that holds the
    ``Trace`` once the block has ended.  The block's wall time, ended by a
    device synchronisation, is the traced window."""
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA] if on_card else []
    if host or not on_card:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    box = {}
    with torch.profiler.profile(activities=acts) as prof:
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield box
        if on_card:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ops, host_ops = read_chrome_trace(path)
    finally:
        os.unlink(path)
    box["trace"] = Trace(window_s=window, busy_s=_busy_us(ops) / 1e6, steps=steps, ops=ops,
                         gaps=_gaps(ops, host_ops))


def host_steps(steps: int) -> int:
    """Steps of the pass that names the idle gaps: a quarter of the window's."""
    return max(1, steps // 4)
