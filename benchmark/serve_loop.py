"""The ``serve`` traffic kind: viewers at a fixed frame rate over one scene.

Set-up draws the seed's scene, computes its activations once, lays out the
closed camera path through every training pose (``per_pose`` steps between
two poses) on the device, and sets the pair budget to the largest demand of
every ``probe_every``-th pose x ``budget_headroom``.  Each of ``viewers``
viewers walks that path from its own seeded start, ``speeds[k]`` positions
a frame, and asks for a frame ``frames_per_s_per_viewer`` times a second,
whether or not its last one has come (an open loop), the viewers evenly
staggered, so every seed offers the same arrivals.  One server answers the
requests first come, first served: the program's ``render.render(...,
inference=True)``, the 8-bit frame made on the device and copied to the
host.  A frame's latency runs from the time its request was due to its copy
on the host, so a stall counts against every request it delays.  The window
serves every request due in ``--seconds``; ``frame_ms_p95`` is the 95th
percentile of all their latencies.  A traced run profiles ``trace_frames``
frames served back to back instead, so that its idle share is the host's
within frames and not the gaps between arrivals, then a quarter as many
with the host's operations recorded, which name the idle gaps.

The check, once the window has closed: ``check_frames`` served frames,
drawn from the seed over all that were served, against the reference's
frames of the same cameras, by the largest and the mean gap in 8-bit
levels.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from . import counts, harness, scene
from . import reference as ref
from .harness import Outcome
from .trace import host_steps, traced


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] colour -> 8-bit levels (round to nearest)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def camera_table(cfg: dict, per_pose: int, device) -> dict:
    """The path's cameras stacked on ``device`` (``render``'s arguments)."""
    cams = [scene.camera_at(cfg, p, "cpu") for p in scene.orbit_positions(cfg, per_pose)]
    c = cams[0]
    return {"view": torch.stack([x.view for x in cams]).to(device),
            "proj": torch.stack([x.proj for x in cams]).to(device),
            "center": torch.stack([x.center for x in cams]).to(device),
            "scalars": (c.fov_x, c.fov_y, c.focal_x, c.focal_y), "cams": cams}


def reference_frames(cell, fit: dict, table: dict, cams: list, device,
                     dtype=torch.float32) -> list:
    """The reference's 8-bit frames of the path cameras ``cams``, in
    ``dtype``."""
    cfg = cell.config
    params = {k: x.to(dtype) for k, x in fit.items()}
    return [to_uint8(ref.render(params, ref.on(table["cams"][c], device), cfg["sh_degree"],
                                cfg["tile"], bool(cfg["white_background"])).float()).cpu()
            for c in cams]


def compare(got: list, want: list) -> dict:
    """The largest gap in 8-bit levels over the frames, and the mean of
    each frame's mean gap."""
    d = [torch.abs(a.to(torch.int16) - b.to(torch.int16)) for a, b in zip(got, want)]
    return {"level_gap_max": float(max(int(x.max()) for x in d)),
            "level_gap_mean": float(np.mean([float(x.float().mean()) for x in d]))}


def make_inputs(cell, seed: int, device):
    """(the seed's scene, the path's camera table, pair demand, budget)."""
    cfg, tr = cell.config, cell.traffic
    fit = scene.draw_scene(cfg, seed, device)
    table = camera_table(cfg, tr["per_pose"], device)
    with torch.no_grad():
        demand = max(ref.pair_count(ref.project(fit, ref.on(cam, device), 0), cam.width,
                                    cam.height, cfg["tile"])
                     for cam in table["cams"][::tr["probe_every"]])
    return fit, table, demand, counts.pair_budget(demand, cfg["chunk"], tr["budget_headroom"])


def renderer(cell, fit: dict, table: dict, budget: int, dropped: list):
    """The program's frame of path camera ``i`` as 8-bit levels on the host
    (``render.render(..., inference=True)`` on activations computed once);
    each frame's pairs over the budget go to ``dropped``."""
    from gaussiansplattingmlx_tpu_torch import config as pcfg
    from gaussiansplattingmlx_tpu_torch import render as render_mod
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations

    cfg = cell.config
    w, h, deg, tile = cfg["image_width"], cfg["image_height"], cfg["sh_degree"], cfg["tile"]
    rcfg = pcfg.RasterizerConfig(max_pairs=budget, tile_w=tile, tile_h=tile,
                                 chunk_size=cfg["chunk"])
    with torch.no_grad():
        act = activations({k: x.clone() for k, x in fit.items()})

    def frame(i: int) -> torch.Tensor:
        out, aux = render_mod.render(*act, table["view"][i], table["proj"][i],
                                     table["center"][i], *table["scalars"], w, h, deg,
                                     raster_cfg=rcfg,
                                     white_background=bool(cfg["white_background"]),
                                     inference=True)
        dropped.append(aux.overflow_pairs)
        return to_uint8(out.color).cpu()

    return frame


def run(cell, seed: int, seconds: float, trace_on: bool, device) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    n = int(cfg["scene"]["gaussians"])
    fit, table, demand, budget = make_inputs(cell, seed, device)
    count = table["view"].shape[0]
    print(f"set-up: {n} Gaussians, {count} path cameras, demand {demand} pairs, "
          f"budget {budget}", flush=True)
    harness.note("inputs made")
    harness.reset_peak(device)
    dropped = []  # each frame's pairs over the budget, read after the window
    frame = renderer(cell, fit, table, budget, dropped)

    rng = random.Random(seed)
    viewers = int(tr["viewers"])
    speeds = tr["speeds"]
    pos = [(rng.randrange(count) + k * count // viewers) % count for k in range(viewers)]
    for k in range(tr["warmup_frames"]):
        frame(pos[k % viewers])
    harness.sync(device)
    harness.note("warmed up")

    kept, seen = [], 0  # reservoir of (camera, frame)
    lat, served = [], []
    gap = 1.0 / (viewers * float(tr["frames_per_s_per_viewer"]))

    def serve(t0: float, until, gap: float) -> None:
        """Request i comes from viewer i % viewers and is due at t0 + i *
        gap (each viewer at its fixed rate, the viewers evenly staggered);
        the server answers each once it is due, in order, while
        ``until(i, due)``."""
        nonlocal seen
        i = 0
        while until(i, t0 + i * gap):
            due = t0 + i * gap
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            k = i % viewers
            cam = pos[k]
            img = frame(cam)
            lat.append(time.perf_counter() - due)
            served.append(cam)
            seen += 1
            if len(kept) < tr["check_frames"]:
                kept.append((cam, img))
            else:
                j = rng.randrange(seen)
                if j < tr["check_frames"]:
                    kept[j] = (cam, img)
            pos[k] = (cam + speeds[k]) % count
            i += 1

    trace = None
    if trace_on:
        frames = int(tr["trace_frames"])
        with traced(frames, device) as box:
            # Back to back: the idle share is then the host's within frames.
            serve(time.perf_counter(), lambda i, due: i < frames, 0.0)
        traced_cams = list(served)
        with traced(host_steps(frames), device, host=True) as named:
            serve(time.perf_counter(), lambda i, due: i < host_steps(frames), 0.0)
        box["trace"].gaps = named["trace"].gaps
        syncs = [counts.host_syncs(lambda: frame(served[i]), device)
                 for i in range(tr["sync_frames"])]
    else:
        setup_s = harness.process_age_s()
        t0 = time.perf_counter()
        serve(t0, lambda i, due: due < t0 + seconds, gap)  # every request due in the window
        harness.sync(device)
    peak = harness.peak_bytes(device)
    dropped = float(torch.stack(dropped).sum())
    attempted = len(lat)
    del frame
    if trace_on:
        trace = box["trace"]
        geom = {k: x for k, x in fit.items() if k != "features_rest"}
        geom["features_rest"] = torch.zeros((n, 0, 3), dtype=torch.float32, device=device)
        work = {c: ref.work(geom, ref.on(table["cams"][c], device), cfg["tile"])
                for c in set(traced_cams)}
        trace.extra = {"mode": "serve", "gaussians": n, "cfg": cfg,
                       "work": [work[c] for c in traced_cams],
                       "ops": [counts.frame_ops(cfg, work[c]) for c in traced_cams],
                       "host_syncs": None if None in syncs else sum(syncs) / len(syncs)}

    harness.note("window closed")
    want = reference_frames(cell, fit, table, [cam for cam, _ in kept], device)
    harness.note("reference done")
    checks = [(k, v, cell.limits[k])
              for k, v in compare([img for _, img in kept], want).items()]
    checks.append(("pairs_dropped", dropped, 0.0))
    metrics = {}
    if not trace_on:
        metrics = {"frame_ms_p95": float(np.percentile(np.asarray(lat) * 1e3, 95)),
                   "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return Outcome(metrics=metrics, checks=checks, attempted=attempted, failed=0,
                   memory_peak_bytes=peak, trace=trace)
