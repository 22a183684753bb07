"""The arithmetic behind the per-layer metrics' readers
(``benchmark/metrics/<name>.py``), on a traced window (``trace.Trace``) and
its ``extra``: the run's ``mode`` ("train" or "serve"), the compositing
work of each traced step or frame in order (``work``), their operations
(``ops``) and the host syncs a step (``host_syncs``).  Each returns None
where the trace holds nothing for it.
"""

from __future__ import annotations

from . import counts


def _mine(trace, mode: str) -> bool:
    return trace is not None and trace.extra.get("mode") == mode


def idle_share(trace, mode: str):
    """% of the traced window in which no operation ran on the device."""
    if not _mine(trace, mode) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def host_syncs(trace, mode: str):
    """Synchronising CUDA calls a step or frame."""
    return trace.extra.get("host_syncs") if _mine(trace, mode) else None


def group_ms(trace, mode: str, group: str):
    """Device milliseconds a step or frame of one kernel group."""
    if not _mine(trace, mode):
        return None
    s = trace.group_s(group)
    return 1e3 * s / trace.steps if s > 0 else None


_BOUNDS = {"k1": lambda cfg, n, w: counts.k1_bound_s(cfg, w),
           "k3": lambda cfg, n, w: counts.k3_bound_s(cfg, w),
           "k4": lambda cfg, n, w: counts.k4_bound_s(n, w)}


def roofline(trace, mode: str, kernel: str, per_step: int = 1):
    """% of its bound that a kernel reached over the traced window: the sum
    of each step's bound over the kernel's device time.  ``per_step``: the
    kernel's launches a step, or 0 where the number varies (then only the
    total time is read)."""
    if not _mine(trace, mode):
        return None
    times = trace.launches(kernel)
    work = trace.extra["work"]
    if not times or (per_step and len(times) != per_step * len(work)):
        return None
    cfg, n = trace.extra["cfg"], trace.extra["gaussians"]
    return 100.0 * sum(_BOUNDS[kernel](cfg, n, w) for w in work) / sum(times)


def mfu(trace, mode: str):
    """% of the card's float32 peak: the traced steps' operations over the
    traced window."""
    if not _mine(trace, mode) or trace.window_s <= 0:
        return None
    return 100.0 * sum(trace.extra["ops"]) / (trace.window_s * counts.F32_OPS_PER_S)
