"""The ``train`` traffic kind: training late in a run, one view a step.

Set-up draws the seed's scene, renders the targets of the cell's views with
the plain reference, moves the scene off its fit (``jitter``) and hands that
state to the program's training step (``train.trainer.make_train_step``:
render, L1 + SSIM, gradients, Adam), with the learning rates of step
``start_step`` of ``iterations`` (the position rate at its floor) and a pair
budget of the views' largest demand x ``budget_headroom``.  The step runs
its first three views, whose loss, first gradient (from Adam's first moment)
and parameter change are kept for the check, then ``warmup_steps`` more.
The window runs steps for ``--seconds`` on views in seeded epochs (each
epoch every view once), and the rate is its steps over its wall time, ended
by ``torch.cuda.synchronize()``.  A traced run profiles ``trace_steps``
steps instead, then a quarter as many with the host's operations recorded,
which name the idle gaps (``trace.traced``).

The check, once the window has closed and the program's state is freed:
the reference runs the same first three steps from the same state, and the
program is held to it by each step's loss, the norm of each leaf's first
gradient, the norm of each leaf's change after three steps (by the worst
leaf, against the larger of the reference's norm of that leaf and of the
median leaf), the first step's image, and the pairs the budget dropped.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import statistics
import sys
import time

import torch

from . import counts, harness, scene
from . import reference as ref
from .harness import Outcome
from .trace import host_steps, traced

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone, and its change is not compared.
STILL_LEAF = 1e-3
FIRST = 3  # steps held to the reference


def view_order(seed: int, views: int, steps: int) -> list:
    """``steps`` view indices, in seeded epochs that each hold every view once."""
    rng = random.Random(seed)
    order = []
    while len(order) < steps:
        epoch = list(range(views))
        rng.shuffle(epoch)
        order.extend(epoch)
    return order[:steps]


def spatial_scale(cams) -> float:
    """1.1 x the largest distance of a camera from the cameras' centroid."""
    c = torch.stack([cam.center.double().cpu() for cam in cams])
    return float(1.1 * torch.linalg.vector_norm(c - c.mean(0), dim=1).max())


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""
    cams: list  # reference.Camera of each view
    targets: torch.Tensor  # [V, H, W, 3]
    start: dict  # the jittered state's leaves, on the host
    order: list  # the views of the first steps and the warm-up
    demand: int
    budget: int
    spatial: float


def make_inputs(cell, seed: int, device) -> Inputs:
    cfg, tr = cell.config, cell.traffic
    deg, tile, white = cfg["sh_degree"], cfg["tile"], bool(cfg["white_background"])
    fit = scene.draw_scene(cfg, seed, device)
    cams = scene.train_cameras(cfg, device)
    targets = torch.stack([ref.render(fit, c, deg, tile, white) for c in cams])
    harness.note("targets rendered")
    start = scene.jitter(fit, tr["jitter"], seed)
    del fit
    with torch.no_grad():
        demand = max(ref.pair_count(ref.project(start, c, deg), c.width, c.height, tile)
                     for c in cams)
    return Inputs(cams=cams, targets=targets, start={k: x.cpu() for k, x in start.items()},
                  order=view_order(seed, len(cams), FIRST + tr["warmup_steps"]),
                  demand=demand,
                  budget=counts.pair_budget(demand, cfg["chunk"], tr["budget_headroom"]),
                  spatial=spatial_scale(cams))


class Program:
    """The program's training step and state, built from the inputs."""

    def __init__(self, cell, inp: Inputs, device):
        from gaussiansplattingmlx_tpu_torch import config as pcfg
        from gaussiansplattingmlx_tpu_torch.models.gaussians import GaussianParams
        from gaussiansplattingmlx_tpu_torch.train import optimizer, trainer

        cfg, tr = cell.config, cell.traffic
        n = int(cfg["scene"]["gaussians"])
        self.cfg = pcfg.TrainConfig(
            iterations=tr["iterations"], white_background=bool(cfg["white_background"]),
            model=pcfg.ModelConfig(sh_degree=cfg["sh_degree"]),
            raster=pcfg.RasterizerConfig(max_pairs=inp.budget, tile_w=cfg["tile"],
                                         tile_h=cfg["tile"], chunk_size=cfg["chunk"]),
            optim=pcfg.OptimizerConfig(spatial_lr_scale=inp.spatial, **tr["optimizer"]))
        params = GaussianParams(**{k: inp.start[k].to(device, copy=True)
                                   for k in ref.PARAM_NAMES})
        adam0 = optimizer.init(params.tensors())
        i32 = dict(dtype=torch.int32, device=device)
        self.state = trainer.TrainState(
            params=params, m=adam0.m, v=adam0.v, count=adam0.count,
            num_active=torch.tensor(n, **i32),
            grad_accum=torch.zeros((n,), dtype=torch.float32, device=device),
            grad_denom=torch.zeros((), dtype=torch.float32, device=device),
            step=torch.tensor(tr["start_step"], **i32),
            overflow_acc=torch.zeros((2,), dtype=torch.float32, device=device))
        cams, targets = inp.cams, inp.targets
        zeros = torch.zeros(targets.shape[:3], dtype=torch.float32, device=device)
        self.views = {"view": torch.stack([c.view for c in cams]),
                      "proj": torch.stack([c.proj for c in cams]),
                      "camera_center": torch.stack([c.center for c in cams]),
                      "target_rgb": targets, "target_depth": zeros, "depth_mask": zeros}
        for key in ("fov_x", "fov_y", "focal_x", "focal_y"):
            self.views[key] = torch.tensor([getattr(c, key) for c in cams],
                                           dtype=torch.float32, device=device)
        self.step_fn = trainer.make_train_step(self.cfg, cfg["image_width"],
                                               cfg["image_height"], cfg["sh_degree"],
                                               tr["iterations"])
        self.metrics = None

    def step(self, view: int):
        self.state, self.metrics, color = self.step_fn(self.state, self.views, view)
        return color


@dataclasses.dataclass
class Reading:
    """What the first steps gave: each step's loss, each leaf's first
    gradient's norm, each leaf's change after the steps, the first image."""
    loss: list
    grad: dict
    change: dict
    image: torch.Tensor


def first_steps(prog: Program, inp: Inputs, device) -> Reading:
    """The program's first steps, read as far as the next step keeps them:
    the first gradient from Adam's first moment after one step (m = (1 -
    beta1) g from zero moments)."""
    loss = []
    beta1 = prog.cfg.optim.beta1
    for k in range(FIRST):
        color = prog.step(inp.order[k])
        loss.append(float(prog.metrics["loss"]))
        if k == 0:
            image = color.cpu()
            grad = {n: float(torch.linalg.vector_norm(prog.state.m[n])) / (1.0 - beta1)
                    for n in ref.PARAM_NAMES}
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(
            getattr(prog.state.params, n).detach() - inp.start[n].to(device)))
            for n in ref.PARAM_NAMES}
    return Reading(loss, grad, change, image)


def learning_rates(tr: dict, step: int, spatial: float) -> dict:
    """Adam's learning rate of each leaf at ``step``: the position rate
    decays linearly to its floor share over ``iterations`` (float32)."""
    o = tr["optimizer"]

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    t = f32(step) / float(tr["iterations"])
    xyz = f32(o["lr_xyz"] * spatial) * torch.maximum(1.0 - t, f32(o["xyz_lr_floor"]))
    return {"xyz": float(xyz), "features_dc": o["lr_features_dc"],
            "features_rest": o["lr_features_rest"], "scales": o["lr_scales"],
            "rotation": o["lr_rotation"], "opacity": o["lr_opacity"]}


def reference_steps(cell, inp: Inputs, device, dtype=torch.float32) -> Reading:
    """The reference's first steps from the same state, in ``dtype``."""
    cfg, tr = cell.config, cell.traffic
    params = {k: x.to(device=device, dtype=dtype, copy=True) for k, x in inp.start.items()}
    m = {k: torch.zeros_like(x) for k, x in params.items()}
    v = {k: torch.zeros_like(x) for k, x in params.items()}
    loss = []
    for k in range(FIRST):
        view = inp.order[k]
        out = ref.train_step(params, m, v, inp.cams[view], inp.targets[view], cfg["sh_degree"],
                             cfg["tile"], bool(cfg["white_background"]),
                             learning_rates(tr, tr["start_step"] + k, inp.spatial))
        loss.append(out.loss)
        if k == 0:
            image = out.image.float().cpu()
            grad = {n: float(torch.linalg.vector_norm(g.float())) for n, g in out.grads.items()}
        del out
    change = {n: float(torch.linalg.vector_norm(params[n].float() - inp.start[n].to(device)))
              for n in ref.PARAM_NAMES}
    return Reading(loss, grad, change, image)


def _gap(p: float, r: float, scale: float) -> float:
    if scale > 0:
        return abs(p - r) / scale
    return 0.0 if p == r else math.inf


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's |norm_got - norm_want| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want.values())
    return max(_gap(got[n], want[n], max(want[n], med)) for n in keep)


def compare(got: Reading, want: Reading) -> dict:
    """The numbers the check compares, ``got`` against the reference's
    ``want``.  Leaves whose reference gradient is under STILL_LEAF of the
    median leaf's are left out of the change."""
    med = statistics.median(want.grad.values())
    keep = [n for n in ref.PARAM_NAMES if want.grad[n] >= STILL_LEAF * med]
    return {
        "loss_gap": max(_gap(p, r, abs(r)) for p, r in zip(got.loss, want.loss)),
        "grad_gap": leaf_gap(got.grad, want.grad, ref.PARAM_NAMES),
        "change_gap": leaf_gap(got.change, want.change, keep),
        "image_gap": float(torch.max(torch.abs(got.image - want.image))),
    }


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace_on: bool, device) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    n = int(cfg["scene"]["gaussians"])
    inp = make_inputs(cell, seed, device)
    harness.note("inputs made")
    harness.reset_peak(device)
    prog = Program(cell, inp, device)
    views = len(inp.cams)
    print(f"set-up: {n} Gaussians, {views} views, demand {inp.demand} pairs, budget "
          f"{inp.budget}, spatial scale {inp.spatial!r}", flush=True)
    got = first_steps(prog, inp, device)
    harness.note("first steps read")
    for v in inp.order[FIRST:]:
        prog.step(v)
    harness.sync(device)
    harness.note("warmed up")

    pairs_v0, trace, order = [], None, view_order(seed + 2, views, views)
    if trace_on:
        steps = tr["trace_steps"]
        order = view_order(seed + 2, views, steps)
        geom = {k: getattr(prog.state.params, k).detach().clone()
                for k in ("xyz", "scales", "rotation", "opacity", "features_dc")}
        geom["features_rest"] = torch.zeros((n, 0, 3), dtype=torch.float32, device=device)
        with traced(steps, device) as box:
            for v in order:
                prog.step(v)
        with traced(host_steps(steps), device, host=True) as named:
            for v in order[:host_steps(steps)]:
                prog.step(v)
        box["trace"].gaps = named["trace"].gaps
        syncs = [counts.host_syncs(lambda: prog.step(order[i]), device)
                 for i in range(tr["sync_steps"])]
    else:
        setup_s = harness.process_age_s()
        t0 = time.perf_counter()
        steps = 0
        while True:
            if steps == len(order):
                order += view_order(seed + 3 + steps, views, views)
            prog.step(order[steps])
            if order[steps] == 0:
                pairs_v0.append(prog.metrics["num_pairs"])
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(device)
        window = time.perf_counter() - t0
    peak = harness.peak_bytes(device)
    dropped = float(prog.state.overflow_acc[0])
    finite = bool(torch.isfinite(prog.metrics["loss"]))
    if pairs_v0:
        print(f"view 0 pairs: first step {int(pairs_v0[0])}, last step {int(pairs_v0[-1])} "
              f"({len(pairs_v0)} of {steps} steps on view 0)", flush=True)
    del prog
    free(device)

    harness.note("window closed")
    if trace_on:
        trace = box["trace"]
        work = {v: ref.work(geom, inp.cams[v], cfg["tile"]) for v in sorted(set(order))}
        del geom
        trace.extra = {"mode": "train", "gaussians": n, "cfg": cfg,
                       "work": [work[v] for v in order],
                       "ops": [counts.train_step_ops(cfg, work[v]) for v in order],
                       "host_syncs": None if None in syncs else sum(syncs) / len(syncs)}

    want = reference_steps(cell, inp, device)
    harness.note("reference done")
    print(f"losses: program {got.loss}, reference {want.loss}", file=sys.stderr, flush=True)
    checks = [(k, v, cell.limits[k]) for k, v in compare(got, want).items()]
    checks.append(("pairs_dropped", dropped, 0.0))
    metrics = {}
    if not trace_on:
        metrics = {"train_steps_per_s": steps / window, "peak_mem_gib": peak / 2 ** 30,
                   "setup_s": setup_s}
    return Outcome(metrics=metrics, checks=checks, attempted=steps,
                   failed=0 if finite else steps, memory_peak_bytes=peak, trace=trace)
