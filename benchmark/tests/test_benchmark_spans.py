"""benchmark/spans.py: device time and idle gaps by program span on a
Chrome trace written by hand, with known answers, and a traced run of each
cell on the CPU at a tiny size, whose host pass holds the program's spans."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, spans, trace

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
MAIN, AUTOGRAD, CARD = 10, 20, 7  # the caller's thread, autograd's, the device's stream


def op(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1 if tid != CARD else 0, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def launch(ts, corr):
    return op("cuda_runtime", "cudaLaunchKernel", None, ts, 1, correlation=corr)


def kernel(ts, dur, corr):
    return op("kernel", f"k{corr}", CARD, ts, dur, correlation=corr)


def fwd(name, ts, seq):
    return op("cpu_op", name, MAIN, ts, 2, **{"Sequence number": seq, "Fwd thread id": 0})


def node(name, ts, dur, seq):
    return op("cpu_op", spans.NODE + name, AUTOGRAD, ts, dur,
              **{"Sequence number": seq, "Fwd thread id": 1})


def on(tid, ev):
    ev["tid"] = tid
    return ev


# A step: project (with sh inside) and stage forward on the caller's
# thread, then the backward on autograd's.  Device ops (ts, dur): k1 (32, 3)
# sh, k2 (50, 4) project, k3 (130, 10) stage, k4 (150, 2) unspanned, k5
# (306, 6) project.bwd, k6 (334, 4) stage.bwd (its explicit span inside a
# node whose forward op was in project), k7 (352, 5) sh.bwd, k8 (385, 1)
# unspanned (AccumulateGrad carries no sequence number).
EVENTS = [
    op("user_annotation", "project", MAIN, 0, 100),
    fwd("aten::mul", 10, 5),
    op("user_annotation", "sh", MAIN, 20, 20),
    fwd("aten::add", 25, 6),
    on(MAIN, launch(30, 1)),
    on(MAIN, launch(45, 2)),
    op("user_annotation", "stage", MAIN, 100, 100),
    fwd("_Stage", 110, 7),
    on(MAIN, launch(120, 3)),
    on(MAIN, launch(250, 4)),
    node("MulBackward0", 300, 20, 5),
    on(AUTOGRAD, launch(305, 5)),
    node("AddBackward0", 321, 44, 5),
    op("user_annotation", "stage.bwd", AUTOGRAD, 330, 30),
    on(AUTOGRAD, launch(340, 6)),
    node("AddBackward0", 370, 10, 6),
    on(AUTOGRAD, launch(372, 7)),
    op("cpu_op", spans.NODE + "torch::autograd::AccumulateGrad", AUTOGRAD, 385, 5),
    on(AUTOGRAD, launch(386, 8)),
    kernel(32, 3, 1), kernel(50, 4, 2), kernel(130, 10, 3), kernel(150, 2, 4),
    kernel(306, 6, 5), kernel(334, 4, 6), kernel(352, 5, 7), kernel(385, 1, 8),
    op("Trace", "PyTorch Profiler (0)", None, 0, 500),
]


def test_a_kernel_goes_to_its_innermost_span():
    got = spans.attribute(EVENTS).device_s
    assert got["sh"] == pytest.approx(3e-6) and got["project"] == pytest.approx(4e-6)
    assert got["stage"] == pytest.approx(10e-6)


def test_a_backward_kernel_goes_to_its_forward_span():
    got = spans.attribute(EVENTS).device_s
    assert got["project.bwd"] == pytest.approx(6e-6)
    assert got["sh.bwd"] == pytest.approx(5e-6)


def test_an_explicit_backward_span_wins_over_the_sequence_number():
    got = spans.attribute(EVENTS).device_s
    assert got["stage.bwd"] == pytest.approx(4e-6)


def test_a_launch_outside_every_span_is_unspanned():
    got = spans.attribute(EVENTS).device_s
    assert got[spans.UNSPANNED] == pytest.approx(3e-6)
    assert spans.attribute(EVENTS).unspanned == pytest.approx({"k4": 2e-6, "k8": 1e-6})


def test_the_disjoint_sums_are_the_device_time():
    split = spans.attribute(EVENTS)
    device = [e["dur"] for e in EVENTS if e["cat"] in trace.DEVICE_CATS]
    assert sum(split.device_s.values()) == pytest.approx(sum(device) / 1e6)
    assert set(split.device_s) == {"sh", "project", "stage", "unspanned", "project.bwd",
                                   "stage.bwd", "sh.bwd"}
    assert split.wall_s == pytest.approx(500e-6)
    assert sum(split.groups.values()) == pytest.approx(sum(device) / 1e6)
    assert split.groups["stage", "elementwise"] == pytest.approx(10e-6)


def test_idle_gaps_are_named_by_the_span_at_their_middle():
    """Gaps (middle): 35-50 (42.5) and 54-130 (92) in project, 140-150 in
    stage, 152-306 in none, 312-334 (323) in a node of project's, 338-352
    (345) in stage.bwd, 357-385 (371) in a node of sh's."""
    idle = spans.attribute(EVENTS).idle
    assert [n for n, _ in idle] == ["project", "project", "stage", "unspanned",
                                    "project.bwd", "stage.bwd", "sh.bwd"]
    assert [s * 1e6 for _, s in idle] == pytest.approx([15, 76, 10, 154, 22, 14, 28])
    by_span = spans.idle_by_span(spans.attribute(EVENTS))
    assert by_span["project"] == pytest.approx(91e-6)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_cell_keeps_its_host_pass(tiny_root, workload):
    """The host pass of a traced run holds the program's spans; the report
    of it is numbers (the CPU runs no device operation)."""
    from gaussiansplattingmlx_tpu_torch.utils.profiler import SPANS

    cell = harness.load_cell(workload, tiny_root)
    read = trace.read_chrome_trace
    out, line, rep = spans.run_with_spans(cell, 2 ** 31 + 5, 0.3, "cpu")
    assert trace.read_chrome_trace is read
    assert line["correct"], line["checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for key in ("device_ms", "busy_ms", "window_ms", "host_pass_ms"):
        assert isinstance(rep[key], float) and rep[key] >= 0.0, key
    assert rep["host_pass_ms"] > 0 and rep["host_steps"] == trace.host_steps(out.trace.steps)
    assert all(isinstance(v, float) for v in rep["spans_ms"].values())
    want = set(SPANS) if cell.kind == "train" else {"project", "sh", "stage", "composite"}
    assert set(rep["spans_seen"]) == want
