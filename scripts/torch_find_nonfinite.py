"""Find the step and the operation that first make a live Gaussian of a
flagship run non-finite (ROADMAP C.5), and record what the CPU needs to
replay that step's stages against the JAX package.

    python3 scripts/torch_find_nonfinite.py --start 22500 --until 25000 \\
        --record outputs/c5/record.npz --fixture outputs/c5/fixture.npz -- \\
        --dataset-root outputs/vendor_scene_800 --holdout 4 --iters 30000 \\
        --opacity-reset-interval 3000 --prune-world-scale 2.0 --spatial-lr-scale auto \\
        --max-pairs-limit 16777216 --seed 2 --out outputs/c4_s2

The flags after ``--`` are ``train_flagship``'s, the run's own: ``--iters``
keeps the run's learning-rate schedule.  The finder builds that run
(``train_flagship.prepare``) and resumes ``<out>/ckpt_<start>.npz``; where
the file is missing it first trains the run from scratch to step
``--start`` in this process (``Trainer.run``) and writes it.  Then it takes
the steps after ``--start`` one at a time, as ``Trainer.run`` takes them
once densify and the opacity resets have stopped (the step, and the
pair-budget handling at log steps), and after each it reads on the host
whether any live row holds a NaN or an infinity in a parameter or an Adam
moment.  The host read is this diagnostic's alone.

At the first step S that leaves such a row, it restores the state from
before S and replays S with taps on the projection, the record packing, the
compositing backward (K3), the segment sum (K4) and Adam.  For the first
such row it records the row's parameters and moments before S, its
gradient at S, its projection intermediates (t, depth t2, w_den, det, the
cov2d and conic, |dirs|, the SH basis), the cotangents that K4 hands to the
projection (means2d, conic, colour, opacity, depth), the K3 rows of each of
its pairs, Adam's update, and the first of those values, in the step's
order, that is non-finite or at least 2^64 in magnitude (its square
overflows float32).  For every tile that the row touches it holds K3's
rows and K4's sum, as the step launched them, against their plain versions
run on CPU copies of the same buffers (for at most ``PLAIN_SECONDS``).
The record (``.npz``, compressed) also holds the touched tiles' records and
cotangent blocks, up to ``RECORD_BYTES``; ``--fixture`` writes a smaller
file (``FIXTURE_BYTES``) with the row's inputs and the tiles that matter
most, for ``tests/test_torch_nonfinite.py``.  A start state that already
holds such a row is reported at the start step, with no replay.

The last line of the output is one JSON object (the step, the rows, the
first non-finite value, the kernel checks).  ``--device`` defaults to
``cuda``; on ``cpu`` the kernels' plain versions run on both sides.
Imports torch, numpy and the port (no JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# A magnitude whose square overflows float32 (its largest value is ~2^128).
OVERFLOW = 2.0 ** 64
# Most bytes of tile records the record and the fixture keep (a card run
# returns at most 64 MiB of output; a test fixture stays near a megabyte),
# and the time cap of the plain versions' run over the row's tiles.
RECORD_BYTES = 24_000_000
FIXTURE_BYTES = 1_500_000
PLAIN_SECONDS = 900.0


def parse_args(argv):
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = []
    if "--" in argv:
        cut = argv.index("--")
        argv, flags = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--start", type=int, default=22500,
                    help="resume <out>/ckpt_<start>.npz (trained to first when missing)")
    ap.add_argument("--until", type=int, default=25000, help="last step to take")
    ap.add_argument("--record", default="outputs/c5/record.npz")
    ap.add_argument("--fixture", default=None,
                    help="also write the CPU test's fixture here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.flags = flags
    return args


@dataclasses.dataclass
class Snapshot:
    """A training state copied on its device, and the train step of its
    pair budget."""
    tensors: dict
    train_step: object


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by a flat name."""
    out = {f"param_{n}": t for n, t in state.params.tensors().items()}
    out.update({f"m_{n}": t for n, t in state.m.items()})
    out.update({f"v_{n}": t for n, t in state.v.items()})
    for name in ("count", "num_active", "grad_accum", "grad_denom", "step", "overflow_acc"):
        out[name] = getattr(state, name)
    return out


def restore_state(state, tensors: dict):
    """A TrainState like ``state`` holding copies of ``tensors``."""
    import torch

    from gaussiansplattingmlx_tpu_torch.models.gaussians import GaussianParams, PARAM_NAMES

    with torch.no_grad():
        params = GaussianParams(**{n: tensors[f"param_{n}"].clone() for n in PARAM_NAMES})
    return dataclasses.replace(
        state, params=params,
        m={n: tensors[f"m_{n}"].clone() for n in PARAM_NAMES},
        v={n: tensors[f"v_{n}"].clone() for n in PARAM_NAMES},
        **{k: tensors[k].clone() for k in ("count", "num_active", "grad_accum",
                                            "grad_denom", "step", "overflow_acc")})


def nonfinite_rows(state, n: int):
    """Live rows (of the first ``n``) with a NaN or an infinity in a
    parameter or an Adam moment, as a sorted int64 tensor."""
    import torch

    bad = torch.zeros(n, dtype=torch.bool, device=state.step.device)
    for name, t in state_tensors(state).items():
        if name.startswith(("param_", "m_", "v_")):
            bad |= ~torch.isfinite(t[:n]).reshape(n, -1).all(dim=1)
    return torch.nonzero(bad).reshape(-1)


class Taps:
    """Wraps the stages of one training step while it runs: the projection,
    the record packing, the compositing backward (K3), the segment sum (K4)
    and Adam, keeping their inputs and outputs (and, through a hook, the
    packed records' gradient, ``row``'s only).  A context manager around
    one call of a train step."""

    def __init__(self, row: int):
        self.row = row
        self.seen = {}
        self._undo = []

    def _patch(self, module, name, make):
        orig = getattr(module, name)
        self._undo.append((module, name, orig))
        setattr(module, name, make(orig))

    def __enter__(self):
        import torch

        from gaussiansplattingmlx_tpu_torch.ops import (projection, rasterize_cuda,
                                                        rasterize_ref, segsum_cuda)
        from gaussiansplattingmlx_tpu_torch.train import optimizer

        seen, row = self.seen, self.row

        def project(orig):
            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                # Copies: Adam later updates the parameters in place.
                seen["project_args"] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                                             for a in args)
                seen["project_kwargs"] = kwargs
                seen["projection"] = out
                return out
            return wrapped

        def pack(orig):
            def wrapped(*args):
                out = orig(*args)
                seen["packed"] = out.detach()
                if out.requires_grad:
                    out.register_hook(lambda g: seen.__setitem__("d_packed", g[row].clone()))
                return out
            return wrapped

        def raster_bwd(orig):
            def wrapped(records_cm, tile_start, tile_count, cot_block, *geom, **consts):
                out = orig(records_cm, tile_start, tile_count, cot_block, *geom, **consts)
                seen["k3"] = dict(records=records_cm, start=tile_start, count=tile_count,
                                  block=cot_block, geom=geom, consts=consts, out=out)
                return out
            return wrapped

        def segment_reduce(orig):
            def wrapped(g_cm, gid, num_rec):
                out = orig(g_cm, gid, num_rec)
                seen["k4"] = dict(gid=gid, out=out)
                return out
            return wrapped

        def update(orig):
            def wrapped(params, grads, state, lrs, **kw):
                row_grads = {n: grads[n][row].clone() for n in params}
                orig(params, grads, state, lrs, **kw)
                seen["adam"] = dict(grads=row_grads, lrs={n: float(v) for n, v in lrs.items()},
                                    options=kw)
            return wrapped

        self._patch(projection, "project_gaussians", project)
        self._patch(rasterize_ref, "pack_gaussians", pack)
        self._patch(rasterize_cuda, "raster_bwd", raster_bwd)
        self._patch(segsum_cuda, "segment_reduce", segment_reduce)
        self._patch(optimizer, "update", update)
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        return False


def _np(t):
    return t.detach().cpu().numpy()


def same_bits(a, b) -> bool:
    """Equal tensors, NaN equal to NaN."""
    import torch

    return bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def flagged(x) -> np.ndarray:
    """Entries that are non-finite or at least ``OVERFLOW`` in magnitude."""
    x = np.asarray(x, np.float64)
    return ~np.isfinite(x) | (np.abs(np.nan_to_num(x)) >= OVERFLOW)


def sh_basis(degree: int, dirs):
    """The SH basis values [K] at ``dirs`` [1, 3] (unnormalised, as the
    projection evaluates it): ``eval_sh`` of each one-hot coefficient."""
    import torch

    from gaussiansplattingmlx_tpu_torch.utils import sh as sh_utils

    k = sh_utils.num_sh_coeffs(degree)
    onehot = torch.eye(k, dtype=dirs.dtype, device=dirs.device)[:, :, None].expand(k, k, 3)
    return sh_utils.eval_sh(degree, onehot, dirs.expand(k, 3))[:, 0]


def projection_intermediates(seen, row: int, active_row) -> dict:
    """The row's projection values, from the projection's own inputs: the
    function itself on the one row (it is per-row arithmetic; the values are
    checked against the step's), and t, t2, w_den and det written as the
    projection writes them."""
    import torch

    from gaussiansplattingmlx_tpu_torch.ops import projection
    from gaussiansplattingmlx_tpu_torch.utils import transforms

    args, kwargs = seen["project_args"], dict(seen["project_kwargs"])
    means3d, scales, quats, shs, view, proj, center = (a.detach() for a in args[:7])
    rest = args[7:]
    sh_degree = rest[-1]
    kwargs["active"] = active_row
    with torch.no_grad():
        sel = slice(row, row + 1)
        one = projection.project_gaussians(means3d[sel], scales[sel], quats[sel], shs[sel],
                                           view, proj, center, *rest, **kwargs)
        x = means3d[sel]
        p_view = projection._rowvec_mm(transforms.homogeneous(x), view)
        p_clip = projection._rowvec_mm(p_view, proj)
        t = projection._rowvec_mm(x, view[:3, :3]) + view[3, :3]
        cov2d = one.cov2d[0]
        dirs = x - center[None, :]
        basis = sh_basis(sh_degree, dirs)
    full = seen["projection"]
    return {
        "t": _np(t[0]), "t2": _np(t[0, 2]),
        "w_den": _np(p_clip[0, 3] + kwargs.get("ndc_w_eps", 1e-6)),
        "cov2d": _np(cov2d), "det": _np(cov2d[0] * cov2d[3] - cov2d[1] * cov2d[2]),
        "conic": _np(one.conic[0]), "means2d": _np(one.means2d[0]), "depth": _np(one.depths[0]),
        "radius": _np(one.radii[0]), "colors": _np(one.colors[0]),
        "dirs": _np(dirs[0]), "dirs_norm": _np(torch.linalg.vector_norm(dirs[0])),
        "sh_basis": _np(basis), "sh_basis_max": _np(torch.max(torch.abs(basis))),
        "same_as_step": all(same_bits(getattr(one, k)[0], getattr(full, k)[row].detach())
                            for k in ("means2d", "depths", "conic", "colors", "radii")),
    }


def row_vjp(seen, row: int, step, warmup: int, sh_degree: int, params_row: dict, d_packed):
    """The row's parameter gradients through the activations, the SH
    warm-up, the projection and the packing, at the cotangent ``d_packed``
    [11] that K4 handed the step: autograd on the one row."""
    import torch

    from gaussiansplattingmlx_tpu_torch.models import gaussians
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref

    args, kwargs = seen["project_args"], dict(seen["project_kwargs"])
    kwargs["active"] = torch.ones(1, dtype=torch.float32, device=d_packed.device)
    with torch.enable_grad():
        leaves = {n: p[None].clone().requires_grad_() for n, p in params_row.items()}
        p = gaussians.apply_sh_warmup(leaves, step, warmup, sh_degree)
        means3d, shs, opacity, scales, rots = gaussians.activations(p, kwargs["active"])
        out = projection.project_gaussians(means3d, scales, rots, shs,
                                           *(a.detach() for a in args[4:7]), *args[7:],
                                           **kwargs)
        packed = rasterize_ref.pack_gaussians(out.means2d, out.conic, out.colors, opacity,
                                              out.depths)
        names = list(leaves)
        grads = torch.autograd.grad(packed, [leaves[n] for n in names],
                                    grad_outputs=d_packed[None], allow_unused=True)
    return {n: (torch.zeros_like(leaves[n][0]) if g is None else g[0])
            for n, g in zip(names, grads)}


def tile_of_columns(start, count, cols):
    """The tile of each record column (tile t holds [start[t], start[t] +
    count[t]))."""
    import torch

    t = torch.searchsorted(start.to(torch.int64), cols, right=True) - 1
    if not bool(torch.all(cols < start[t].to(torch.int64) + count[t].to(torch.int64))):
        raise RuntimeError("a pair column of the row lies in no tile's range")
    return t


def plain_k3_on_tiles(k3, cols, tiles, deadline):
    """K3's plain version on CPU copies of the step's records and cotangent
    block, one tile of ``tiles`` at a time (each cut at its pixels' largest
    n_contrib: no later record takes part in the tile's forward or
    backward).  Returns (the plain rows [16, len(cols)] of the record
    columns ``cols``, zero in tiles not done; the tiles done before
    ``deadline``)."""
    import torch

    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda

    start, count = k3["start"].cpu(), k3["count"].cpu()
    block = k3["block"].cpu()
    ncon_max = block[:, :, 6].amax(dim=1).to(torch.int32)
    cols = cols.cpu()
    out = torch.zeros((rasterize_cuda.REC_DIM, cols.numel()), dtype=torch.float32)
    done = []
    for t in sorted(set(tiles)):
        if time.time() > deadline:
            break
        s, c = int(start[t]), int(min(count[t], ncon_max[t]))
        if c > 0:
            # The tile alone, its kept records from column 0.
            one_start = torch.zeros_like(start)
            one_count = torch.zeros_like(count)
            one_count[t] = c
            rec = k3["records"][:, s:s + c].cpu().contiguous()
            g = rasterize_cuda.raster_bwd_plain(rec, one_start, one_count, block,
                                                *k3["geom"], **k3["consts"])
            inside = (cols >= s) & (cols < s + c)
            out[:, inside] = g[:, cols[inside] - s]
        done.append(int(t))
    return out, done


def first_flagged(stages):
    """The first (stage name, flat index, value) whose value is flagged, in
    the order given, or None."""
    for name, value in stages:
        f = flagged(value).reshape(-1)
        if f.any():
            i = int(np.flatnonzero(f)[0])
            return name, i, float(np.asarray(value, np.float64).reshape(-1)[i])
    return None


def analyse(trainer, snap: Snapshot, post_tensors: dict, view_idx: int, rows, step_s: int,
            args) -> tuple:
    """Replay step S from ``snap`` under ``Taps`` and build (the record dict
    of numpy arrays, the summary dict)."""
    import torch

    from gaussiansplattingmlx_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, segsum_cuda

    row = int(rows[0])
    cfg = trainer.cfg
    pre = restore_state(trainer.state, snap.tensors)
    pre_row = {n: snap.tensors[f"param_{n}"][row].clone() for n in PARAM_NAMES}
    with Taps(row) as taps:
        new_state, _, _ = snap.train_step(pre, trainer.views, view_idx)
    seen = taps.seen
    replay_equal = all(same_bits(t[row], post_tensors[k][row])
                       for k, t in state_tensors(new_state).items()
                       if k.startswith(("param_", "m_", "v_")))
    rec = {"step": np.int64(step_s), "view": np.int64(view_idx), "row": np.int64(row),
           "rows": np.asarray(_np(rows), np.int64),
           "num_active": np.int64(int(snap.tensors["num_active"])),
           "capacity": np.int64(trainer.state.params.capacity),
           "max_pairs": np.int64(cfg.raster.max_pairs),
           "adam_count": np.int64(int(snap.tensors["count"])),
           "replay_equal": np.bool_(replay_equal)}
    for n in PARAM_NAMES:
        rec[f"pre_param_{n}"] = _np(pre_row[n])
        rec[f"pre_m_{n}"] = _np(snap.tensors[f"m_{n}"][row])
        rec[f"pre_v_{n}"] = _np(snap.tensors[f"v_{n}"][row])
        rec[f"post_param_{n}"] = _np(post_tensors[f"param_{n}"][row])
        rec[f"post_m_{n}"] = _np(post_tensors[f"m_{n}"][row])
        rec[f"post_v_{n}"] = _np(post_tensors[f"v_{n}"][row])
    adam = seen["adam"]
    for n in PARAM_NAMES:
        rec[f"grad_{n}"] = _np(adam["grads"][n])
        rec[f"lr_{n}"] = np.float32(adam["lrs"][n])
    for k, v in adam["options"].items():
        rec[f"adam_{k}"] = np.asarray(v)
    # The camera and the render settings of the step.
    pargs, pkw = seen["project_args"], seen["project_kwargs"]
    for name, a in zip(("view_matrix", "proj_matrix", "camera_center"), pargs[4:7]):
        rec[name] = _np(a)
    for name, a in zip(("fov_x", "fov_y", "focal_x", "focal_y"), pargs[7:11]):
        rec[name] = np.float32(float(a))
    rec["image_width"], rec["image_height"], rec["sh_degree"] = (np.int64(v) for v in pargs[11:14])
    for k, v in pkw.items():
        if k != "active":
            rec[f"projection_{k}"] = np.float32(v)
    rec["sh_warmup"] = np.int64(cfg.model.sh_warmup_interval)
    rec["white_background"] = np.bool_(cfg.white_background)
    active_row = torch.ones(1, dtype=torch.float32, device=pre_row["xyz"].device)
    inter = projection_intermediates(seen, row, active_row)
    for k, v in inter.items():
        rec[f"proj_{k}"] = np.asarray(v)
    rec["packed_row"] = _np(seen["packed"][row])

    # K3: the row's pair columns, the card's rows and the plain version's.
    k3, k4 = seen["k3"], seen["k4"]
    for k, v in k3["consts"].items():
        rec[f"raster_{k}"] = np.float32(v)
    rec["grid"] = np.asarray(k3["geom"], np.int64)
    gid = k4["gid"]
    cols = torch.nonzero(gid == row).reshape(-1)
    tiles = tile_of_columns(k3["start"], k3["count"], cols)
    k3_rows = k3["out"][:, cols]
    deadline = time.time() + PLAIN_SECONDS
    plain_rows, done = plain_k3_on_tiles(k3, cols, [int(t) for t in tiles.tolist()], deadline)
    checked = torch.as_tensor([int(t) in set(done) for t in tiles.tolist()])
    rec.update(cols=_np(cols), col_tiles=_np(tiles), k3_rows=_np(k3_rows),
               k3_plain_rows=_np(plain_rows), k3_plain_checked=_np(checked))
    # K4: the step's sum for the row, its plain version over the card's K3
    # columns and over the plain K3 columns (CPU).
    live = list(segsum_cuda.LIVE_ROWS)
    offsets = torch.tensor([0, cols.numel()], dtype=torch.int32)
    k4_row = k4["out"][row]
    k4_plain = segsum_cuda.segment_sum_sorted_plain(
        k3_rows[live].cpu().contiguous(), offsets)[0]
    k4_plain_of_plain = segsum_cuda.segment_sum_sorted_plain(
        plain_rows[live].contiguous(), offsets)[0]
    perm = list(rasterize_cuda.PERM)
    rec.update(k4_row=_np(k4_row), k4_plain=_np(k4_plain),
               k4_plain_of_plain=_np(k4_plain_of_plain),
               d_packed=_np(seen["d_packed"]))
    d_packed = seen["d_packed"]
    # The row's VJP on its own, from the step's cotangent.
    vjp = row_vjp(seen, row, snap.tensors["step"], cfg.model.sh_warmup_interval,
                  cfg.model.sh_degree, pre_row, d_packed)
    for n in PARAM_NAMES:
        rec[f"row_vjp_{n}"] = _np(vjp[n])

    def agree(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        same_pattern = bool(np.array_equal(np.isfinite(a), np.isfinite(b)))
        fin = np.isfinite(a) & np.isfinite(b)
        diff = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.0
        scale = float(np.max(np.abs(b[fin]))) if fin.any() else 0.0
        return {"same_finite_pattern": same_pattern, "max_abs_diff": diff, "scale": scale,
                "bit_equal": bool(np.array_equal(a, b, equal_nan=True))}

    chk = np.asarray(rec["k3_plain_checked"], bool)
    summary_checks = {
        "k3_vs_plain": agree(rec["k3_rows"][:, chk], rec["k3_plain_rows"][:, chk]),
        "k3_tiles_checked": int(chk.sum()), "k3_tiles": int(len(set(tiles.tolist()))),
        "k3_pairs": int(cols.numel()),
        "k4_vs_plain": agree(rec["k4_row"], rec["k4_plain"]),
        "k4_of_plain_k3": agree(rec["k4_row"], rec["k4_plain_of_plain"]),
        "k4_is_d_packed": agree(rec["k4_row"][perm], rec["d_packed"]),
        "row_vjp_vs_step": {n: agree(rec[f"row_vjp_{n}"], rec[f"grad_{n}"])
                            for n in PARAM_NAMES},
        "replay_equal": replay_equal,
        "projection_same_as_step": inter["same_as_step"],
    }

    # Adam, written out as the update computes it.
    beta1, beta2, eps = (float(adam["options"][k]) for k in ("beta1", "beta2", "eps"))
    stages = [(f"param {n}", rec[f"pre_param_{n}"]) for n in PARAM_NAMES]
    stages += [(f"adam m {n}", rec[f"pre_m_{n}"]) for n in PARAM_NAMES]
    stages += [(f"adam v {n}", rec[f"pre_v_{n}"]) for n in PARAM_NAMES]
    with np.errstate(over="ignore"):
        scales_exp = np.exp(rec["pre_param_scales"].astype(np.float32))
    stages.append(("activation scales exp", scales_exp))
    stages += [(f"projection {name}", rec[f"proj_{key}"]) for name, key in (
        ("t", "t"), ("t2", "t2"), ("w_den", "w_den"), ("cov2d", "cov2d"), ("det", "det"),
        ("conic", "conic"), ("means2d", "means2d"), ("depth", "depth"),
        ("|dirs|", "dirs_norm"), ("SH basis", "sh_basis"), ("colour", "colors"))]
    stages.append(("K3 rows of the row's pairs", rec["k3_rows"]))
    stages += [(f"K4 sum: d {name}", rec["d_packed"][a:b]) for name, a, b in (
        ("means2d", 0, 2), ("conic", 2, 6), ("colour", 6, 9), ("opacity", 9, 10),
        ("depth", 10, 11))]
    stages += [(f"gradient {n}", rec[f"grad_{n}"]) for n in PARAM_NAMES]
    for n in PARAM_NAMES:
        g = rec[f"grad_{n}"].astype(np.float32)
        with np.errstate(all="ignore"):
            m = np.float32(beta1) * rec[f"pre_m_{n}"] + np.float32(1.0 - beta1) * g
            v = np.float32(beta2) * rec[f"pre_v_{n}"] + np.float32(1.0 - beta2) * (g * g)
            stages += [(f"adam g*g {n}", g * g), (f"adam m' {n}", m), (f"adam v' {n}", v),
                       (f"adam step {n}", rec[f"lr_{n}"] * m / (np.sqrt(v) + np.float32(eps)))]
    stages += [(f"param' {n}", rec[f"post_param_{n}"]) for n in PARAM_NAMES]
    first = first_flagged(stages)
    summary = {"step": step_s, "view": view_idx, "row": row, "rows": [int(r) for r in rows],
               "first_flagged": None if first is None else
               {"stage": first[0], "index": first[1], "value": first[2]},
               "post_nonfinite": {n: int((~np.isfinite(rec[f"post_param_{n}"])).sum())
                                  for n in PARAM_NAMES},
               "checks": summary_checks}
    rec["first_flagged"] = np.asarray(json.dumps(summary["first_flagged"]))

    # Tile records: the touched tiles, those that flag the row first, then
    # by the row's largest K3 entry; each cut at its largest n_contrib.
    order = tile_priority(rec, tiles)
    ncon_max = k3["block"][:, :, 6].amax(dim=1).to(torch.int32).cpu()
    start, count = k3["start"].cpu(), k3["count"].cpu()
    block = k3["block"]

    def tile_entry(t):
        s, c = int(start[t]), int(min(count[t], ncon_max[t]))
        return {"tile": t, "start": s, "count": int(count[t]), "kept": c,
                "records": _np(k3["records"][:11, s:s + c]), "block": _np(block[t])}

    rec_tiles, used = [], 0
    for t in order:
        e = tile_entry(t)
        size = e["records"].nbytes + e["block"].nbytes
        if used + size > RECORD_BYTES:
            continue
        rec_tiles.append(e)
        used += size
    add_tiles(rec, rec_tiles)
    summary["tiles_recorded"] = [e["tile"] for e in rec_tiles]
    fixture = None
    if args.fixture:
        fixture = {k: v for k, v in rec.items() if not k.startswith("tile_")}
        fx_tiles, used = [], sum(np.asarray(v).nbytes for v in fixture.values())
        for e in rec_tiles:
            size = e["records"].nbytes + e["block"].nbytes
            if used + size > FIXTURE_BYTES:
                continue
            fx_tiles.append(e)
            used += size
        add_tiles(fixture, fx_tiles)
        summary["tiles_in_fixture"] = [e["tile"] for e in fx_tiles]
    return rec, fixture, summary


def tile_priority(rec, tiles) -> list:
    """The row's tiles, those whose K3 rows for the row are flagged first
    (or whose plain rows are), then by the row's largest K3 magnitude."""
    col_tiles = np.asarray(rec["col_tiles"])
    k3 = np.asarray(rec["k3_rows"], np.float64)
    plain = np.asarray(rec["k3_plain_rows"], np.float64)
    bad = flagged(k3).any(axis=0) | flagged(plain).any(axis=0)
    mag = np.nan_to_num(np.abs(k3), nan=np.inf).max(axis=0)
    keys = sorted(range(len(col_tiles)), key=lambda j: (not bad[j], -mag[j]))
    seen, order = set(), []
    for j in keys:
        t = int(col_tiles[j])
        if t not in seen:
            seen.add(t)
            order.append(t)
    return order


def add_tiles(out: dict, entries) -> None:
    """Tile entries as flat arrays: ids, starts, full and kept counts, the
    kept records concatenated [11, sum kept], the blocks [T, TT, 8]."""
    out["tile_ids"] = np.asarray([e["tile"] for e in entries], np.int64)
    out["tile_starts"] = np.asarray([e["start"] for e in entries], np.int64)
    out["tile_counts"] = np.asarray([e["count"] for e in entries], np.int64)
    out["tile_kept"] = np.asarray([e["kept"] for e in entries], np.int64)
    out["tile_records"] = (np.concatenate([e["records"] for e in entries], axis=1)
                           if entries else np.zeros((11, 0), np.float32))
    out["tile_blocks"] = (np.stack([e["block"] for e in entries]) if entries
                          else np.zeros((0, 0, 8), np.float32))


def scan(trainer, window, n: int):
    """Take the steps of ``window`` as ``Trainer.run`` takes them where no
    maintenance falls (the camera draw, the step, the pair-budget handling
    at log steps) and after each read on the host whether one of the first
    ``n`` rows holds a NaN or an infinity.  Returns (the step, its view, the
    rows, a ``Snapshot`` of the state before it) at the first step that
    leaves such a row, else None; the Trainer's state is the one after the
    last step taken."""
    nv = trainer.data.num_views
    snap = Snapshot({k: t.clone() for k, t in state_tensors(trainer.state).items()},
                    trainer.train_step)
    t0 = time.time()
    for it in window:
        view_idx = int(trainer.rng.integers(0, nv))
        trainer.state, metrics, _ = trainer.train_step(trainer.state, trainer.views, view_idx)
        if it % trainer.cfg.log_interval == 0:
            trainer._maybe_grow_raster({k: float(v) for k, v in metrics.items()})
        rows = nonfinite_rows(trainer.state, n)
        if rows.numel():
            return it, view_idx, rows, snap
        for k, t in state_tensors(trainer.state).items():
            snap.tensors[k].copy_(t)
        snap.train_step = trainer.train_step
        if it % 500 == 0:
            print(f"step {it}: no non-finite row ({time.time() - t0:.1f} s)", flush=True)
    return None


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from gaussiansplattingmlx_tpu_torch import train_flagship

    camp = train_flagship.prepare([*args.flags, "--device", args.device])
    trainer = camp.trainer
    device = trainer.device
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    ckpt = camp.out_dir / f"ckpt_{args.start}.npz"
    t0 = time.time()
    if ckpt.exists():
        trainer.restore_checkpoint(ckpt)
        print(f"resumed {ckpt} at step {int(trainer.state.step)}", flush=True)
    else:
        def progress(m):
            if m["iteration"] % 2500 == 0:
                print(f"replay: step {m['iteration']} loss {m['loss']:.4f} "
                      f"n {m['num_active']} {time.time() - t0:.1f} s", flush=True)
        trainer.run(iterations=args.start, on_metrics=progress)
        if not ckpt.exists():
            trainer.save_checkpoint(args.start)
        print(f"replayed to step {args.start} in {time.time() - t0:.1f} s", flush=True)
    if int(trainer.state.step) != args.start:
        raise SystemExit(f"state at step {int(trainer.state.step)}, not {args.start}")
    d = trainer.cfg.densify
    window = range(args.start + 1, args.until + 1)
    busy = [it for it in window
            if (it % d.interval == 0 and (d.from_iter <= it <= d.until_iter or (
                trainer.prune_step is not None and it <= d.prune_until_iter)))
            or (d.opacity_reset_interval > 0 and it % d.opacity_reset_interval == 0
                and it <= d.until_iter)]
    if busy:
        raise SystemExit(f"steps {args.start + 1}..{args.until} hold maintenance "
                         f"(first at {busy[0]}): the finder takes only plain steps")

    n = int(trainer.state.num_active)
    rows = nonfinite_rows(trainer.state, n)
    result = {"start": args.start, "until": args.until, "num_active": n}
    if rows.numel():
        # The checkpoint itself holds the row: name it at its step.
        print(f"the state at step {args.start} already holds non-finite rows "
              f"{_np(rows).tolist()}", flush=True)
        result.update(found=True, step=args.start, rows=_np(rows).tolist(),
                      in_start_state=True)
        write_npz(args.record, {"step": np.int64(args.start), "rows": _np(rows),
                                "in_start_state": np.bool_(True)})
        print(json.dumps(result), flush=True)
        return result

    t1 = time.time()
    found = scan(trainer, window, n)
    if found is None:
        print(f"no non-finite row through step {args.until}", flush=True)
        result.update(found=False)
        print(json.dumps(result), flush=True)
        return result

    step_s, view_idx, rows, snap = found
    print(f"step {step_s} (view {view_idx}) leaves rows {_np(rows).tolist()} non-finite "
          f"({time.time() - t1:.1f} s of stepping)", flush=True)
    post = {k: t.clone() for k, t in state_tensors(trainer.state).items()}
    rec, fixture, summary = analyse(trainer, snap, post, view_idx, rows, step_s, args)
    write_npz(args.record, rec)
    if fixture is not None:
        write_npz(args.fixture, fixture)
    result.update(found=True, in_start_state=False, **summary)
    report(rec, summary)
    print(json.dumps(result), flush=True)
    return result


def report(rec, summary) -> None:
    """The record's numbers as lines, for the log."""
    from gaussiansplattingmlx_tpu_torch.models.gaussians import PARAM_NAMES

    np.set_printoptions(precision=9, linewidth=160)
    print(f"row {summary['row']}: first flagged value: {summary['first_flagged']}")
    for n in PARAM_NAMES:
        first = {k: rec[f"{k}_{n}"].reshape(-1)[:6] for k in
                 ("pre_param", "post_param", "grad", "pre_m", "pre_v")}
        print(f"  {n}: param {first['pre_param']} -> {first['post_param']}; "
              f"grad {first['grad']}; m {first['pre_m'][:3]} v {first['pre_v'][:3]}")
    for k in ("t", "t2", "w_den", "det", "conic", "means2d", "depth", "radius",
              "dirs_norm", "sh_basis_max", "colors"):
        print(f"  projection {k}: {rec[f'proj_{k}']}")
    print(f"  d_packed (K4): {rec['d_packed']}")
    print(f"  K3 pairs {summary['checks']['k3_pairs']} over {summary['checks']['k3_tiles']} "
          f"tiles; flagged pair columns {int(flagged(rec['k3_rows']).any(axis=0).sum())}")
    print(f"  checks: {json.dumps(summary['checks'])}")


def write_npz(path, arrays: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({path.stat().st_size} bytes)", flush=True)


if __name__ == "__main__":
    main()
