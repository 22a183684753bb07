"""The port's layer spans (utils/profiler.span) on the CPU, the kernels'
plain versions, a tiny scene: no profiler, no record_function; under a
profiler a train step records every span of ``SPANS`` (the forward spans
once, ``sh`` inside ``project``, the backward spans on autograd's
backward) and a served frame only its forward spans in every layout;
every autograd node of the step maps through its sequence number to a
forward op inside a span; and a step gives the same bits with the
profiler on and off."""

import json

import numpy as np
import pytest
import torch

from benchmark import spans as bench_spans
from torch_port_helpers import CHUNK, TILE, H, W, scene_numpy

from gaussiansplattingmlx_tpu_torch import config
from gaussiansplattingmlx_tpu_torch.models import gaussians
from gaussiansplattingmlx_tpu_torch.render import render
from gaussiansplattingmlx_tpu_torch.train import optimizer, trainer
from gaussiansplattingmlx_tpu_torch.utils import profiler
from gaussiansplattingmlx_tpu_torch.utils.camera import Camera, camera_args

N, SH = 80, 1
RASTER = dict(tile_h=TILE, tile_w=TILE, max_pairs=4096, chunk_size=CHUNK)
FORWARD = [n for n in profiler.SPANS if not n.endswith(".bwd")]
SERVED = ("project", "sh", "stage", "composite")
LAYOUTS = {"fused": ({}, None), "split": ({"staging": "split"}, None),
           "reference": ({}, "reference")}


def _state():
    params, _ = scene_numpy(n=N, seed=3, sh_degree=SH, sh_rest_scale=0.1)
    gp = gaussians.params_from_numpy(params, "cpu")
    adam0 = optimizer.init(gp.tensors())
    return trainer.TrainState(
        params=gp, m=adam0.m, v=adam0.v, count=adam0.count,
        num_active=torch.tensor(N, dtype=torch.int32),
        grad_accum=torch.zeros((N,), dtype=torch.float32),
        grad_denom=torch.zeros((), dtype=torch.float32),
        step=torch.tensor(0, dtype=torch.int32),
        overflow_acc=torch.zeros((2,), dtype=torch.float32))


def _camera():
    _, c2w = scene_numpy(n=N, seed=3)
    return Camera.from_c2w(W, H, 60.0, 60.0, c2w).tensors()


def _views():
    t = _camera()
    views = {k: torch.as_tensor(np.asarray(t[k], np.float32))[None]
             for k in ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x",
                       "focal_y")}
    views["target_rgb"] = torch.as_tensor(
        np.random.default_rng(5).uniform(size=(1, H, W, 3)).astype(np.float32))
    views["target_depth"] = torch.zeros((1, H, W))
    views["depth_mask"] = torch.zeros((1, H, W))
    return views


def _train_step():
    cfg = config.TrainConfig(iterations=100, model=config.ModelConfig(sh_degree=SH),
                             raster=config.RasterizerConfig(**RASTER))
    step = trainer.make_train_step(cfg, W, H, SH, 100)
    views = _views()
    return lambda state: step(state, views, 0)


def _served_frame(layout="fused"):
    selectors, backend = LAYOUTS[layout]
    act = gaussians.activations(_state().params.tensors())
    cam = camera_args(_camera(), "cpu")
    rcfg = config.RasterizerConfig(**RASTER, **selectors)
    return lambda: render(*act, *cam, W, H, SH, raster_cfg=rcfg, inference=True,
                          backend=backend)


def _profiled(fn, tmp_path):
    """fn()'s result and the raw events of its CPU profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = fn()
    path = tmp_path / f"trace_{len(list(tmp_path.iterdir()))}.json"
    prof.export_chrome_trace(str(path))
    return result, json.loads(path.read_text())["traceEvents"]


def _ranges(events, pred):
    """[(name, tid, start, end)] of the complete events that ``pred`` keeps."""
    return [(e["name"], e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and "dur" in e and pred(e)]


def _spans(events):
    return _ranges(events, lambda e: e.get("cat") == "user_annotation")


def _inside(inner, outer) -> bool:
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


@pytest.fixture(scope="module")
def step_events(tmp_path_factory):
    step = _train_step()
    state = step(_state())[0]  # a first step outside the profile
    _, events = _profiled(lambda: step(state), tmp_path_factory.mktemp("step"))
    return events


@pytest.mark.parametrize("what", ["train", "serve"])
def test_no_profiler_never_enters_record_function(monkeypatch, what):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiler, "record_function", refuse)
    if what == "train":
        step = _train_step()
        state, metrics, _ = step(_state())
        assert torch.isfinite(metrics["loss"])
    else:
        out, _ = _served_frame()()
        assert torch.isfinite(out.color).all()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered with no profiler"):
            profiler.span("stage")


@pytest.mark.parametrize("name", profiler.SPANS)
def test_train_step_records_span(step_events, name):
    got = [s for s in _spans(step_events) if s[0] == name]
    assert got, f"no {name!r} span in a train step"
    if name in FORWARD:
        assert len(got) == 1, got
    if name == "sh":
        project = [s for s in _spans(step_events) if s[0] == "project"]
        assert _inside(got[0], project[0])
    if name.endswith(".bwd"):
        nodes = _ranges(step_events, lambda e: e["name"].startswith(bench_spans.NODE))
        assert all(any(_inside(s, n) for n in nodes) for s in got)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_served_frame_records_only_its_forward_spans(tmp_path, layout):
    (out, _), events = _profiled(_served_frame(layout), tmp_path)
    names = [s[0] for s in _spans(events)]
    assert sorted(names) == sorted(SERVED), names
    assert torch.isfinite(out.color).all()


def test_backward_nodes_map_to_forward_ops_in_spans(step_events):
    """Autograd's nodes carry no span of their own: each one that carries a
    sequence number (AccumulateGrad carries none) maps to the latest
    forward op of that number, which ran inside a span."""
    args = {id(e): e.get("args") or {} for e in step_events}
    ops = [e for e in step_events if e.get("cat") == "cpu_op" and "Sequence number" in args[id(e)]]
    nodes = [e for e in ops if e["name"].startswith(bench_spans.NODE)]
    forward = sorted((e for e in ops if not args[id(e)].get("Fwd thread id")),
                     key=lambda e: float(e["ts"]))
    assert nodes and forward
    by_thread = {}
    for name, tid, s, t in _spans(step_events):
        by_thread.setdefault(tid, []).append((s, t, name))
    at = bench_spans.innermost(by_thread, [(e.get("tid"), float(e["ts"]), k)
                                           for k, e in enumerate(forward)])
    seq_span = {args[id(e)]["Sequence number"]: at.get(k) for k, e in enumerate(forward)}
    unmapped = [n["name"] for n in nodes
                if seq_span.get(args[id(n)]["Sequence number"]) is None]
    assert not unmapped, unmapped


def test_step_is_bit_equal_with_the_profiler_on(tmp_path):
    step = _train_step()
    a_state, a_metrics, a_color = step(_state())
    (b_state, b_metrics, b_color), _ = _profiled(lambda: step(_state()), tmp_path)
    assert torch.equal(a_metrics["loss"], b_metrics["loss"])
    assert torch.equal(a_color, b_color)
    for n in gaussians.PARAM_NAMES:
        assert torch.equal(getattr(a_state.params, n), getattr(b_state.params, n)), n
        assert torch.equal(a_state.m[n], b_state.m[n]), n
        assert torch.equal(a_state.v[n], b_state.v[n]), n
    for f in ("count", "grad_accum", "grad_denom", "step", "overflow_acc"):
        assert torch.equal(getattr(a_state, f), getattr(b_state, f)), f
