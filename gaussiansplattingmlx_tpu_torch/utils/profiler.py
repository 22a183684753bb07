"""Named spans of the training step and the served frame, and a
``torch.profiler`` trace helper.

``span(name)`` marks one layer of the step as a ``torch.profiler``
``record_function`` range while a profiler is recording, and does nothing
otherwise: one flag check, no allocation, never a device synchronisation.
``SPANS`` lists every name the port records.  On the default layout the
forward spans tile a step's forward (``activations``, ``project`` with
``sh`` inside it, ``stage``, ``composite``, ``loss``), ``adam`` holds the
update and its metrics, and the backwards of the staging and of the
rasterizer have spans of their own (``stage.bwd``, ``composite.bwd``).
Autograd's other backward nodes carry no span: a reader of the trace names
them from the span their forward op ran in (``benchmark/spans.py``).

``trace()`` records a ``torch.profiler`` trace (CPU and, where there is a
card, CUDA activity) and writes it as a Chrome trace that shows the spans
beside the kernels they launched (view it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch
from torch.profiler import record_function

SPANS = ("activations", "project", "sh", "stage", "composite", "loss", "adam",
         "stage.bwd", "composite.bwd")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(name)


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
