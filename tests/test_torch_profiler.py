"""The port's trace helper (utils/profiler.py): a CPU trace written as a
Chrome trace file."""

import json

import torch

from gaussiansplattingmlx_tpu_torch.utils import profiler


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
