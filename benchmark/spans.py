"""Device time and idle gaps by program span, read from a Chrome trace that
recorded host operations beside the device's: the benchmark's host pass
(``trace.traced(..., host=True)``) or the port's ``utils/profiler.trace``.

The program marks its layers with ``torch.profiler.record_function``
ranges (the port's ``utils/profiler.span``), ``user_annotation`` events in
the trace.  Each device operation (kernel, memcpy, memset) goes to one
span, in this order:

1. its ``correlation`` names the runtime call that launched it;
2. the innermost span around that call on the call's thread takes it;
3. else, where the call lies in an autograd node (``autograd::engine::
   evaluate_function: ...``) whose sequence number is that of a forward op
   that ran in span S, ``S.bwd`` takes it (on the card autograd runs the
   backward on a thread of its own, outside the caller's spans);
4. else ``unspanned``.

The sets are disjoint: an operation counts once, for its innermost span.
The sums are of device-operation durations, never wall time, so the host
pass's profiling overhead does not enter them.  Each idle gap of the
device is named alike, by the span open on any thread at its middle.

A forward op's sequence number is the one the next autograd node of its
thread takes; ops that make no node share it with the op that does, which
runs last.  So a number maps to the span of the latest op that carries it.

    python3 -m benchmark.spans --workload <cell> --seed <n>

runs the cell as ``--trace 1`` does (``run.run_cell``), keeps the host
pass's events as ``trace.traced`` reads them, and prints on standard error
device ms a step by span and idle ms a step by span (top 10), then on
standard output one JSON line: the cell's result line, ``spans_ms`` (device
ms a step by span), ``groups_ms`` (each of ``trace.GROUPS``' kernel groups
by span), ``device_ms`` (their sum), ``busy_ms`` and
``window_ms`` (the traced window's, a step), ``host_pass_ms`` (the host
pass's profiled wall time a step), ``idle_ms`` (by span, top 10),
``unspanned_ops_ms`` (the unspanned device operations by name, top 10) and
``spans_seen`` (the span names the host pass recorded).
"""

from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import sys
from collections import defaultdict
from dataclasses import dataclass

from . import counts, harness, run, trace

NODE = "autograd::engine::evaluate_function: "
UNSPANNED = "unspanned"
TOP = 10


@dataclass
class Split:
    """What the trace's spans hold."""
    device_s: dict  # span -> seconds of device operations
    groups: dict  # (span, trace.GROUPS group) -> seconds
    unspanned: dict  # operation name -> seconds, of the unspanned ones
    idle: list  # [(span, seconds)] each idle gap of the device, in order
    wall_s: float  # the profiler's own range (the profiled wall time)


def read_events(path: str) -> list:
    with open(path) as f:
        events = json.load(f)
    return events.get("traceEvents", events) if isinstance(events, dict) else events


def innermost(intervals: dict, points: list) -> dict:
    """For each (key, t, tag) of ``points``, the payload of the interval of
    ``intervals[key]`` ([(start, end, payload)]) that started last and holds
    ``t``; tags without one are left out."""
    out = {}
    by_key = defaultdict(list)
    for key, t, tag in points:
        by_key[key].append((t, tag))
    for key, queries in by_key.items():
        ivs = sorted(intervals.get(key, ()), key=lambda iv: iv[0])
        heap, i = [], 0
        for t, tag in sorted(queries, key=lambda q: q[0]):
            while i < len(ivs) and ivs[i][0] <= t:
                s, e, payload = ivs[i]
                heapq.heappush(heap, (-s, i, e, payload))
                i += 1
            while heap and heap[0][2] < t:
                heapq.heappop(heap)
            if heap:
                out[tag] = heap[0][3]
    return out


def attribute(events: list) -> Split:
    """Device seconds and idle gaps by span (module docstring)."""
    dev, launch, spans, nodes, fwd = [], {}, defaultdict(list), defaultdict(list), []
    wall = 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name, a = e.get("cat"), e.get("name", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e["dur"])
        tid = (e.get("pid"), e.get("tid"))
        if cat in trace.DEVICE_CATS:
            dev.append((ts, dur, a.get("correlation"), name))
        elif (cat or "").startswith("cuda_") and "correlation" in a:  # a CUDA API call
            launch[a["correlation"]] = (tid, ts)
        elif cat == "user_annotation":
            spans[tid].append((ts, ts + dur, name))
        elif cat == "cpu_op" and "Sequence number" in a:
            if name.startswith(NODE):
                nodes[tid].append((ts, ts + dur, a["Sequence number"]))
            elif not a.get("Fwd thread id"):
                fwd.append((tid, ts, a["Sequence number"]))
        elif name.startswith("PyTorch Profiler"):
            wall = dur / 1e6
    # Each sequence number -> the span of the latest forward op carrying it.
    fwd.sort(key=lambda f: f[1])
    at = innermost(spans, [(tid, ts, k) for k, (tid, ts, _) in enumerate(fwd)])
    seq_span = {seq: at.get(k) for k, (_, _, seq) in enumerate(fwd)}

    def backward_of(seq):
        s = seq_span.get(seq)
        return f"{s}.bwd" if s is not None else None

    calls = [(*launch[c], k) for k, (_, _, c, _) in enumerate(dev) if c in launch]
    in_span = innermost(spans, calls)
    in_node = innermost(nodes, calls)
    device_s, groups, unspanned = defaultdict(float), defaultdict(float), defaultdict(float)
    for k, (_, dur, _, op_name) in enumerate(dev):
        name = in_span.get(k) or backward_of(in_node.get(k)) or UNSPANNED
        device_s[name] += dur / 1e6
        groups[name, trace.group_of(op_name)] += dur / 1e6
        if name == UNSPANNED:
            unspanned[trace.short(op_name)] += dur / 1e6

    dev.sort(key=lambda d: d[0])
    mids, end = [], None
    for ts, dur, _, _ in dev:
        if end is not None and ts > end:
            mids.append(((ts + end) / 2.0, (ts - end) / 1e6))
        end = ts + dur if end is None else max(end, ts + dur)
    points = [(0, mid, k) for k, (mid, _) in enumerate(mids)]
    gap_span, gap_node = innermost(_merged(spans), points), innermost(_merged(nodes), points)
    idle = [(gap_span.get(k) or backward_of(gap_node.get(k)) or UNSPANNED, secs)
            for k, (_, secs) in enumerate(mids)]
    return Split(device_s=dict(device_s), groups=dict(groups), unspanned=dict(unspanned),
                 idle=idle, wall_s=wall)


def _merged(by_thread: dict) -> dict:
    """Every thread's intervals under one key."""
    return {0: [iv for ivs in by_thread.values() for iv in ivs]}


def idle_by_span(split: Split) -> dict:
    out = defaultdict(float)
    for name, secs in split.idle:
        out[name] += secs
    return dict(out)


@contextlib.contextmanager
def kept_events():
    """Within the block, every trace that ``trace.traced`` reads is also
    kept as raw events, in order (the benchmark's files are read as they
    are, and a traced run's last pass is its host pass)."""
    kept = []
    read = trace.read_chrome_trace

    def read_keeping(path):
        kept.append(read_events(path))
        return read(path)

    trace.read_chrome_trace = read_keeping
    try:
        yield kept
    finally:
        trace.read_chrome_trace = read


def report(out, events: list) -> dict:
    """Per-step numbers of a traced run's window (``out.trace``) and its
    host pass (``events``)."""
    window = out.trace
    steps = trace.host_steps(window.steps)
    split = attribute(events)

    def per(secs):
        return 1e3 * secs / steps

    idle = sorted(idle_by_span(split).items(), key=lambda kv: -kv[1])[:TOP]
    groups = defaultdict(dict)
    for (name, group), secs in sorted(split.groups.items()):
        groups[group][name] = per(secs)
    return {"spans_ms": {k: per(v) for k, v in sorted(split.device_s.items())},
            "groups_ms": dict(groups),
            "device_ms": per(sum(split.device_s.values())),
            "busy_ms": 1e3 * window.busy_s / window.steps,
            "window_ms": 1e3 * window.window_s / window.steps,
            "host_pass_ms": per(split.wall_s), "host_steps": steps,
            "spans_seen": sorted({e.get("name") for e in events
                                  if e.get("cat") == "user_annotation"}),
            "idle_ms": {k: per(v) for k, v in idle},
            "unspanned_ops_ms": {k: per(v) for k, v in sorted(split.unspanned.items(),
                                                              key=lambda kv: -kv[1])[:TOP]}}


def run_with_spans(cell, seed: int, seconds: float, device):
    """A traced run of ``cell`` (``run.run_cell``): (Outcome, result line,
    ``report``)."""
    with kept_events() as kept:
        out, line = run.run_cell(cell, seed, seconds, True, device)
    return out, line, report(out, kept[-1])


def print_report(rep: dict, file=sys.stderr) -> None:
    total = rep["device_ms"] or 1.0
    print(f"device ms a step by span ({rep['host_steps']} steps of the host pass; "
          f"{rep['device_ms']:.3f} ms of device operations, window busy {rep['busy_ms']:.3f}):",
          file=file)
    for name, ms in sorted(rep["spans_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:16s} {ms:10.3f} ms  {100 * ms / total:6.2f}%", file=file)
    print("kernel groups (trace.GROUPS), ms a step by span (top 5):", file=file)
    for group, by_span in rep["groups_ms"].items():
        top = sorted(by_span.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {group} ({sum(by_span.values()):.3f} ms): "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in top), file=file)
    print(f"idle ms a step by span (top {TOP}):", file=file)
    for name, ms in rep["idle_ms"].items():
        print(f"  {name:16s} {ms:10.3f} ms", file=file)
    print(f"unspanned device operations, ms a step (top {TOP}):", file=file)
    for name, ms in rep["unspanned_ops_ms"].items():
        print(f"  {ms:10.3f} ms  {name}", file=file)
    file.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark.spans: needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT))
    out, line, rep = run_with_spans(cell, args.seed, cell.spec["run_seconds"], "cuda:0")
    print_report(rep)
    harness.print_checks(out)
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "card": torch.cuda.get_device_name(0),
                      "power_limit_w": counts.power_limit_w(0), "result": line, **rep}),
          flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
