"""Training: the single-device train step and the host loop (torch
counterpart of the JAX package's ``train/trainer.py``).

One step runs activations -> render (training path: staging, forward and
backward compositing, per-Gaussian segment sum) -> L1 + SSIM (+ depth) loss
-> backward -> Adam on the device; its metrics stay device tensors, and the
host reads them only at log steps.  Parameters live in fixed-capacity
buffers with an active count, as in the JAX package.

Not ported yet (``ROADMAP.md`` queue A): densify and prune, opacity reset
and capacity growth (A.4); previews, PLY snapshots and checkpoints (A.5);
data-parallel and pixel-band training (A.7).  A run whose iterations would
reach one of them raises ``NotImplementedError`` instead of skipping it.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..data.dataset import TrainData
from ..models import gaussians
from ..models.gaussians import GaussianParams, PARAM_NAMES
from ..ops import losses as losses_mod
from ..render import render as render_fn
from ..utils.point_cloud import PointCloud
from . import optimizer as adam


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    m: dict  # Adam first moments, keyed by PARAM_NAMES
    v: dict  # Adam second moments
    count: torch.Tensor  # [] int32 Adam step count
    num_active: torch.Tensor  # [] int32
    grad_accum: torch.Tensor  # [capacity] accumulated |d xyz|
    grad_denom: torch.Tensor  # [] float32
    step: torch.Tensor  # [] int32
    # Run totals of (pairs, gaussians) lost to the pair budget, accumulated
    # on the device every step so that overflow between log steps is seen.
    overflow_acc: torch.Tensor  # [2] float32

    @property
    def adam(self) -> adam.AdamState:
        return adam.AdamState(m=self.m, v=self.v, count=self.count)


# Keys of the JAX package's checkpoint files, used by state_{from,to}_numpy.
_COUNTERS = {"adam_count": ("count", np.int32), "num_active": ("num_active", np.int32),
             "grad_accum": ("grad_accum", np.float32),
             "grad_denom": ("grad_denom", np.float32), "step": ("step", np.int32),
             "overflow_acc": ("overflow_acc", np.float32)}


def state_from_numpy(src, device) -> TrainState:
    """Carry a training state given as numpy arrays under the JAX package's
    checkpoint keys (``param_<name>``, ``adam_m_<name>``, ``adam_v_<name>``,
    ``adam_count``, ``num_active``, ``grad_accum``, ``grad_denom``, ``step``,
    ``overflow_acc``; e.g. ``np.load`` of its ``ckpt_*.npz``) into the port.
    The tensors are copies: training updates them in place."""
    device = torch.device(device)

    def tensor(key, dtype):
        return torch.tensor(np.asarray(src[key], dtype), device=device)

    params = gaussians.params_from_numpy(
        {n: src[f"param_{n}"] for n in PARAM_NAMES}, device)
    fields = {attr: tensor(key, dt) for key, (attr, dt) in _COUNTERS.items()}
    return TrainState(
        params=params,
        m={n: tensor(f"adam_m_{n}", np.float32) for n in PARAM_NAMES},
        v={n: tensor(f"adam_v_{n}", np.float32) for n in PARAM_NAMES},
        **fields,
    )


def state_to_numpy(state: TrainState) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_numpy``: a dict of numpy arrays under the
    JAX package's checkpoint keys."""
    out = {}
    for n in PARAM_NAMES:
        out[f"param_{n}"] = getattr(state.params, n).detach().cpu().numpy()
        out[f"adam_m_{n}"] = state.m[n].cpu().numpy()
        out[f"adam_v_{n}"] = state.v[n].cpu().numpy()
    for key, (attr, dt) in _COUNTERS.items():
        out[key] = np.asarray(getattr(state, attr).cpu().numpy(), dt)
    return out


VIEW_KEYS = ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x",
             "focal_y", "target_rgb", "target_depth", "depth_mask")


def stack_views(data: TrainData, device) -> Dict[str, torch.Tensor]:
    """Every view's camera tensors and targets stacked on ``device``,
    indexed by view id."""
    stacked = {k: [] for k in VIEW_KEYS}
    for i in range(data.num_views):
        t = data.view_tensors(i)
        for k in VIEW_KEYS:
            stacked[k].append(np.asarray(t[k], np.float32))
    return {k: torch.as_tensor(np.stack(v)).to(device) for k, v in stacked.items()}


def make_train_step(cfg: TrainConfig, image_width: int, image_height: int,
                    sh_degree: int, total_iterations: int) -> Callable:
    """Build ``train_step(state, views, view_idx) -> (state, metrics, color)``.

    The step updates the parameters and Adam moments in place and returns
    the state with its counters advanced; ``metrics`` are 0-d device tensors
    and ``color`` the rendered [H, W, 3] image (detached)."""
    warmup = int(cfg.model.sh_warmup_interval)
    optim = cfg.optim

    def train_step(state: TrainState, views: Dict, view_idx: int):
        def take(k):
            return views[k][view_idx]

        leaves = state.params.tensors()
        active = gaussians.active_mask(state.params.capacity, state.num_active)
        params = gaussians.apply_sh_warmup(leaves, state.step, warmup, sh_degree)
        means3d, shs, opacity, scales, rotations = gaussians.activations(params, active)
        out, aux = render_fn(
            means3d, shs, opacity, scales, rotations,
            take("view"), take("proj"), take("camera_center"),
            take("fov_x"), take("fov_y"), take("focal_x"), take("focal_y"),
            image_width, image_height, sh_degree,
            raster_cfg=cfg.raster, white_background=cfg.white_background,
            active=active,
        )
        loss, parts = losses_mod.total_loss(
            out.color, take("target_rgb"), out.depth, take("target_depth"),
            take("depth_mask"),
            lambda_dssim=cfg.loss.lambda_dssim, lambda_depth=cfg.loss.lambda_depth,
            ssim_window=cfg.loss.ssim_window, ssim_sigma=cfg.loss.ssim_sigma,
        )
        names = list(PARAM_NAMES)
        grad_list = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(names, grad_list)}

        with torch.no_grad():
            # Densification statistic: accumulated per-point |d xyz|.
            grad_accum = state.grad_accum + torch.sqrt(
                torch.sum(grads["xyz"] * grads["xyz"], dim=1))
            grad_denom = state.grad_denom + 1.0
            lrs = gaussians.learning_rates(
                state.step, total_iterations,
                lr_xyz=optim.lr_xyz * optim.spatial_lr_scale,
                lr_features_dc=optim.lr_features_dc,
                lr_features_rest=optim.lr_features_rest,
                lr_scales=optim.lr_scales,
                lr_rotation=optim.lr_rotation,
                lr_opacity=optim.lr_opacity,
                xyz_lr_floor=optim.xyz_lr_floor,
            )
            opt = state.adam
            adam.update(leaves, grads, opt, lrs, beta1=optim.beta1,
                        beta2=optim.beta2, eps=optim.eps,
                        bias_correction=optim.bias_correction)
            overflow_acc = state.overflow_acc + torch.stack(
                [aux.overflow_pairs, aux.overflow_gaussians]).to(torch.float32)
            color = out.color.detach()
            covered = torch.sum(torch.where(active > 0, (grad_accum > 0).to(torch.float32), 0.0))
            metrics = {
                "loss": loss.detach(), "l1": parts["l1"].detach(),
                "ssim": parts["ssim"].detach(), "depth": parts["depth"].detach(),
                "psnr": losses_mod.psnr(color, take("target_rgb")),
                "num_pairs": aux.num_pairs,
                "overflow_pairs": aux.overflow_pairs,
                "overflow_gaussians": aux.overflow_gaussians,
                "overflow_pairs_acc": overflow_acc[0],
                "overflow_gaussians_acc": overflow_acc[1],
                # Fraction of active gaussians with any position gradient:
                # near 0 means gradients are not reaching the gaussians.
                "grad_coverage": covered / torch.clamp_min(
                    state.num_active.to(torch.float32), 1.0),
            }
        new_state = dataclasses.replace(
            state, count=opt.count, grad_accum=grad_accum, grad_denom=grad_denom,
            step=state.step + 1, overflow_acc=overflow_acc,
        )
        return new_state, metrics, color

    return train_step


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA device is available")
    return device


class Trainer:
    """Host loop on one device: camera sampling from numpy's default_rng
    (the JAX package's stream), log lines, pair-budget auto-grow/shrink and
    early stop.  ``device`` defaults to ``cuda``; pass ``"cpu"`` to train on
    the CPU with the kernels' plain versions."""

    def __init__(self, config: TrainConfig, data: TrainData,
                 point_cloud: PointCloud, device="cuda"):
        par = config.parallel
        if par.data_parallel != 1 or par.tile_parallel != 1:
            raise NotImplementedError(
                "data- and tile-parallel training is not ported yet: see "
                "ROADMAP.md queue A.7")
        self.cfg = config
        self.data = data
        self.device = _resolve_device(device)
        self.rng = np.random.default_rng(config.seed)
        pc = point_cloud.random_sample(config.init_points, seed=config.seed)
        capacity = max(config.model.initial_capacity, _next_pow2(pc.size))
        params, n = gaussians.create_from_points(
            pc.coords, pc.colors / 255.0,
            sh_degree=config.model.sh_degree,
            capacity=capacity,
            init_opacity=config.model.init_opacity,
            dist2_floor=config.model.dist2_floor,
            knn_k=config.model.knn_k,
            device=self.device,
        )
        opt = adam.init(params.tensors())
        dev = self.device
        self.state = TrainState(
            params=params, m=opt.m, v=opt.v, count=opt.count,
            num_active=torch.tensor(n, dtype=torch.int32, device=dev),
            grad_accum=torch.zeros((capacity,), dtype=torch.float32, device=dev),
            grad_denom=torch.zeros((), dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            overflow_acc=torch.zeros((2,), dtype=torch.float32, device=dev),
        )
        self.views = stack_views(data, dev)
        self.history: list = []
        # Overflow total already handled (host mirror of overflow_acc[0]).
        self._overflow_handled = 0.0
        # Auto-shrink window: the configured budget is the floor; peak and
        # observation count since the last budget change.
        self._initial_max_pairs = config.raster.max_pairs
        self._pairs_peak = 0.0
        self._pairs_obs = 0
        self._build_train_step()

    def _build_train_step(self):
        self.train_step = make_train_step(
            self.cfg, self.data.width, self.data.height,
            self.cfg.model.sh_degree, self.cfg.iterations,
        )

    def set_max_pairs(self, max_pairs: int) -> None:
        """Set the pair budget (for example from a probe of the views) and
        make it the auto-shrink floor."""
        self.cfg = dataclasses.replace(
            self.cfg, raster=dataclasses.replace(self.cfg.raster, max_pairs=max_pairs))
        self._initial_max_pairs = max_pairs
        self._build_train_step()

    def _check_ported(self, start: int, iterations: int) -> None:
        """Raise if iterations (start, iterations] reach a part of the JAX
        trainer that is not ported yet."""
        cfg = self.cfg
        d = cfg.densify
        its = range(start + 1, iterations + 1)
        prune_only = d.prune_until_iter > d.until_iter
        if d.interval > 0 and any(
            it % d.interval == 0
            and (d.from_iter <= it <= d.until_iter
                 or (prune_only and d.until_iter < it <= d.prune_until_iter))
            for it in its
        ):
            raise NotImplementedError(
                "densify/prune steps are not ported yet (ROADMAP.md queue A.4): "
                "set densify.from_iter past the run's iterations")
        if d.opacity_reset_interval > 0 and any(
                it % d.opacity_reset_interval == 0 and it <= d.until_iter for it in its):
            raise NotImplementedError(
                "opacity reset is not ported yet (ROADMAP.md queue A.4)")
        if cfg.output_dir:
            for name, every in (("preview", cfg.preview_interval),
                                ("snapshot", cfg.snapshot_interval),
                                ("checkpoint", cfg.checkpoint_interval)):
                if every and any(it % every == 0 for it in its):
                    raise NotImplementedError(
                        f"{name} writing is not ported yet (ROADMAP.md queue A.5): "
                        f"set output_dir to '' or the {name} interval past the run")

    def _maybe_grow_raster(self, metrics: Dict) -> None:
        """Pair-budget overflow since the last handling (the in-graph run
        total) grows max_pairs: to 1.3x the logged step's demand when that
        step overflowed, else double, in 512-slot quanta, up to the limit."""
        r = self.cfg.raster
        if not r.auto_grow:
            return
        acc = metrics.get("overflow_pairs_acc", metrics.get("overflow_pairs", 0))
        new_overflow = acc - self._overflow_handled
        if new_overflow <= 0:
            self._maybe_shrink_raster(metrics)
            return
        if r.max_pairs < r.max_pairs_limit:
            step_overflow = float(metrics.get("overflow_pairs", 0.0))
            if step_overflow > 0:
                demand = float(metrics.get("num_pairs", 0.0)) + step_overflow
                target = max(int(demand * 1.3), int(r.max_pairs * 1.25))
            else:
                target = r.max_pairs * 2
            target = ((target + 511) // 512) * 512
            new = dataclasses.replace(
                r, max_pairs=min(max(target, r.max_pairs + 512), r.max_pairs_limit))
            print(
                f"WARNING: pair-budget overflow by step {int(self.state.step)} "
                f"(pairs dropped since last growth {int(new_overflow)}, "
                f"gaussians affected this step "
                f"{int(metrics.get('overflow_gaussians', 0))}); "
                f"growing max_pairs {r.max_pairs}->{new.max_pairs}",
                file=sys.stderr, flush=True,
            )
            self.cfg = dataclasses.replace(self.cfg, raster=new)
            self._build_train_step()
        else:
            print(
                f"WARNING: pair-budget overflow by step {int(self.state.step)} "
                f"but max_pairs_limit reached (max_pairs={r.max_pairs}); "
                f"output is truncated — raise raster limits",
                file=sys.stderr, flush=True,
            )
        self._overflow_handled = acc
        self._pairs_peak = 0.0
        self._pairs_obs = 0

    def _maybe_shrink_raster(self, metrics: Dict) -> None:
        """Shrink an oversized pair budget toward the observed peak: after
        >= 8 logged observations, when the peak is under 1/2.2 of the budget,
        to peak * 1.4 in 512-slot quanta, never below the configured
        budget.  With no overflow the rendered outputs do not depend on the
        budget."""
        r = self.cfg.raster
        if not r.auto_shrink:
            return
        self._pairs_peak = max(self._pairs_peak, float(metrics.get("num_pairs", 0.0)))
        self._pairs_obs += 1
        floor = min(self._initial_max_pairs, r.max_pairs)
        if (self._pairs_obs < 8 or r.max_pairs <= floor
                or self._pairs_peak * 2.2 >= r.max_pairs):
            return
        snug = max(((int(self._pairs_peak * 1.4) + 511) // 512) * 512, floor)
        if snug >= r.max_pairs:
            return
        print(
            f"pair budget underused by step {int(self.state.step)} "
            f"(window peak {int(self._pairs_peak)} vs budget {r.max_pairs}); "
            f"shrinking max_pairs {r.max_pairs}->{snug}",
            file=sys.stderr, flush=True,
        )
        self.cfg = dataclasses.replace(self.cfg, raster=dataclasses.replace(r, max_pairs=snug))
        self._build_train_step()
        self._pairs_peak = 0.0
        self._pairs_obs = 0

    def run(self, iterations: Optional[int] = None,
            on_metrics: Optional[Callable] = None) -> Dict:
        """Train up to ``iterations`` (default ``cfg.iterations``); returns the
        last logged metrics (host floats)."""
        cfg = self.cfg
        iterations = iterations if iterations is not None else cfg.iterations
        start = int(self.state.step)
        self._check_ported(start, iterations)
        last_log, last_step = time.time(), start
        final = {}
        for it in range(start + 1, iterations + 1):
            view_idx = int(self.rng.integers(0, self.data.num_views))
            self.state, metrics, _ = self.train_step(self.state, self.views, view_idx)
            if it % cfg.log_interval == 0 or it == iterations:
                m = {k: float(v) for k, v in metrics.items()}
                self._maybe_grow_raster(m)
                if m["grad_coverage"] < 0.01 and int(self.state.num_active) > 1000:
                    print(f"WARNING: grad_coverage {m['grad_coverage']:.4f} at step "
                          f"{it}: almost no gaussians receive gradients",
                          file=sys.stderr, flush=True)
                now = time.time()
                m["iters_per_s"] = (it - last_step) / max(now - last_log, 1e-9)
                m["num_active"] = int(self.state.num_active)
                m["iteration"] = it
                last_log, last_step = now, it
                self.history.append(m)
                final = m
                if on_metrics:
                    on_metrics(m)
                if m["loss"] < cfg.early_stop_loss:
                    break
        return final
