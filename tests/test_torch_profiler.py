"""The port's IntervalProfiler and trace (utils/profiler.py): the cases of
tests/test_profiler.py against the port's profiler, the report's format
against the JAX package's on the same sections, sync_on (no wait for CPU
tensors; one synchronize per CUDA device), and a CPU trace written as a
Chrome trace file."""

import json
import time

import torch

from gaussiansplattingmlx_tpu.utils import profiler as jax_profiler
from gaussiansplattingmlx_tpu.utils.profiler import IntervalProfiler as JaxIntervalProfiler
from gaussiansplattingmlx_tpu_torch.utils import profiler
from gaussiansplattingmlx_tpu_torch.utils.profiler import IntervalProfiler


def test_nested_attribution():
    p = IntervalProfiler()
    with p.measure("outer"):
        time.sleep(0.02)
        with p.measure("inner"):
            time.sleep(0.03)
    outer = p.sections["outer"]
    inner = p.sections["inner"]
    assert outer.count == 1 and inner.count == 1
    # Outer total includes inner; outer self excludes it.
    assert outer.total >= inner.total
    assert outer.self_time < outer.total
    assert abs((outer.total - outer.self_time) - inner.total) < 5e-3


def test_report_and_reset():
    p = IntervalProfiler()
    for _ in range(3):
        with p.measure("a"):
            pass
    rep = p.report(top_k=5)
    assert "a" in rep and "section" in rep
    p.reset()
    assert not p.sections


def test_disabled_profiler_is_noop():
    p = IntervalProfiler(enabled=False)
    with p.measure("x"):
        pass
    assert not p.sections


def test_report_matches_jax_format():
    """The same section times give the JAX profiler's report, line for line."""
    ours, theirs = IntervalProfiler(), JaxIntervalProfiler()
    for p, section in ((ours, profiler._Section), (theirs, jax_profiler._Section)):
        for name, total, child, count in (("step", 0.5, 0.2, 4), ("render", 0.2, 0.0, 4),
                                          ("io", 0.05, 0.0, 1)):
            p.sections[name] = section(total=total, child=child, count=count)
    assert ours.report(top_k=2) == theirs.report(top_k=2)
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[1].startswith("step")


def test_sync_on_waits_only_for_cuda_devices(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    p = IntervalProfiler()
    x = torch.ones(3)
    with p.measure("cpu", sync_on={"a": [x, (x, 2)], "b": None}):
        x = x * 2
    assert calls == [] and p.sections["cpu"].count == 1
    assert profiler.cuda_devices([x, {"y": x}]) == set()
    # Tensors on a CUDA device (faked here): that device is waited for once.
    monkeypatch.setattr(profiler, "cuda_devices", lambda obj: {torch.device("cuda:0")})
    with p.measure("gpu", sync_on=[x, x]):
        pass
    assert calls == [torch.device("cuda:0")]


def test_trace_writes_chrome_trace(tmp_path, capsys):
    with profiler.trace(str(tmp_path / "trace")) as prof:
        a = torch.randn(32, 32)
        (a @ a).sum()
    assert prof is not None
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert f"trace written to {tmp_path / 'trace'}" in capsys.readouterr().out
