"""Training: the single-device train step, the maintenance steps and the
host loop (torch counterpart of the JAX package's ``train/trainer.py``).

One step runs activations -> render (training path: staging, forward and
backward compositing, per-Gaussian segment sum) -> L1 + SSIM (+ depth) loss
-> backward -> Adam on the device; its metrics stay device tensors, and the
host reads them only at log steps.  Parameters live in fixed-capacity
buffers with an active count, as in the JAX package.  Densify/prune and the
opacity reset write into those buffers in place; only capacity growth
allocates new ones.

``Trainer.run`` does what the JAX package's does, in its order within an
iteration: train step, preview, snapshot, densify or prune-only round (then
capacity growth), opacity reset, log (pair-budget grow/shrink, early stop),
checkpoint.  It refreshes the supervisor heartbeat (``metrics.jsonl``'s
mtime) where the JAX package does, whenever the train step is rebuilt, and
before the port's long pauses: the kernels' build at first use and a
capacity growth.  The training CLI (``train_cli.py``) draws the loss curve
after the run (``save_loss_curve``).

Under a process group (``parallel/``) the Trainer of each rank runs the
data- and tile-parallel step of its (data, tile) mesh position: every rank
draws the same camera vector from the same seeded stream and takes its own
entry, every decision (densify schedule, budget growth and shrink, capacity
growth, early stop) is taken from replicated state or reduced metrics, the
state is checked to be identical on every rank after each maintenance step,
and only rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..data import ply
from ..data.dataset import TrainData
from ..models import gaussians
from ..models.gaussians import GaussianParams, INACTIVE_OPACITY, PARAM_NAMES
from ..ops import _kernels
from ..ops import losses as losses_mod
from ..parallel import multihost, sharding
from ..render import render as render_fn
from ..utils import prng
from ..utils.chart import two_axis_chart
from ..utils.png import write_png
from ..utils.point_cloud import PointCloud
from ..utils.profiler import span
from . import densify as densify_mod
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
    stacked = stack_views_host(data, range(data.num_views))
    return {k: torch.as_tensor(v).to(device) for k, v in stacked.items()}


def stack_views_host(data: TrainData, view_ids) -> Dict[str, np.ndarray]:
    """The given views' camera tensors and targets stacked as numpy arrays,
    in ``view_ids`` order: the batched-views store of a rank keeps only its
    own data shard's views."""
    stacked = {k: [] for k in VIEW_KEYS}
    for i in view_ids:
        t = data.view_tensors(int(i))
        for k in VIEW_KEYS:
            stacked[k].append(np.asarray(t[k], np.float32))
    return {k: np.stack(v) for k, v in stacked.items()}


def render_view(cfg: TrainConfig, state: TrainState, take: Callable, image_width: int,
                image_height: int, sh_degree: int, backend: Optional[str] = None, **band):
    """Activations (with the SH warm-up) and the training render of one view,
    or of one pixel band of it (``band``: ``render``'s ``pixel_y_offset``
    and ``full_image_height``), with ``render``'s ``backend``.  ``take(key)``
    reads the view's tensors.  Returns (parameter leaves, active mask,
    RenderOutputs, RenderAux)."""
    with span("activations"):
        leaves = state.params.tensors()
        active = gaussians.active_mask(state.params.capacity, state.num_active)
        params = gaussians.apply_sh_warmup(leaves, state.step,
                                           int(cfg.model.sh_warmup_interval), sh_degree)
        means3d, shs, opacity, scales, rotations = gaussians.activations(params, active)
    out, aux = render_fn(
        means3d, shs, opacity, scales, rotations,
        take("view"), take("proj"), take("camera_center"),
        take("fov_x"), take("fov_y"), take("focal_x"), take("focal_y"),
        image_width, image_height, sh_degree,
        raster_cfg=cfg.raster, white_background=cfg.white_background,
        active=active, backend=backend, **band,
    )
    return leaves, active, out, aux


def view_loss(cfg: TrainConfig, color: torch.Tensor, depth: torch.Tensor, take: Callable):
    """The L1 + SSIM (+ depth) loss of a full rendered view against its
    targets.  Returns (loss, parts)."""
    with span("loss"):
        return losses_mod.total_loss(
            color, take("target_rgb"), depth, take("target_depth"), take("depth_mask"),
            lambda_dssim=cfg.loss.lambda_dssim, lambda_depth=cfg.loss.lambda_depth,
            ssim_window=cfg.loss.ssim_window, ssim_sigma=cfg.loss.ssim_sigma,
        )


def param_grads(loss: torch.Tensor, leaves: dict) -> dict:
    """d loss / d parameter for every name of ``PARAM_NAMES`` (zeros where
    the loss does not reach one)."""
    names = list(PARAM_NAMES)
    grad_list = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(leaves[n]))
            for n, g in zip(names, grad_list)}


@torch.no_grad()
def adam_step(cfg: TrainConfig, state: TrainState, leaves: dict, grads: dict,
              total_iterations: int) -> torch.Tensor:
    """The Adam update of the parameters and moments at the state's step's
    learning rates, in place.  Returns the new Adam count."""
    optim = cfg.optim
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
    adam.update(leaves, grads, opt, lrs, beta1=optim.beta1, beta2=optim.beta2,
                eps=optim.eps, bias_correction=optim.bias_correction)
    return opt.count


def grad_coverage(active: torch.Tensor, grad_accum: torch.Tensor,
                  num_active: torch.Tensor) -> torch.Tensor:
    """Fraction of active gaussians with any accumulated position gradient:
    near 0 means gradients are not reaching the gaussians."""
    covered = torch.sum(torch.where(active > 0, (grad_accum > 0).to(torch.float32), 0.0))
    return covered / torch.clamp_min(num_active.to(torch.float32), 1.0)


def make_train_step(cfg: TrainConfig, image_width: int, image_height: int,
                    sh_degree: int, total_iterations: int,
                    backend: Optional[str] = None) -> Callable:
    """Build ``train_step(state, views, view_idx) -> (state, metrics, color)``,
    rendering with ``backend`` (None: ``cfg.raster.backend``).

    The step updates the parameters and Adam moments in place and returns
    the state with its counters advanced; ``metrics`` are 0-d device tensors
    and ``color`` the rendered [H, W, 3] image (detached)."""

    def train_step(state: TrainState, views: Dict, view_idx: int):
        def take(k):
            return views[k][view_idx]

        leaves, active, out, aux = render_view(cfg, state, take, image_width, image_height,
                                               sh_degree, backend)
        loss, parts = view_loss(cfg, out.color, out.depth, take)
        grads = param_grads(loss, leaves)

        with span("adam"), torch.no_grad():
            # Densification statistic: accumulated per-point |d xyz|.
            grad_accum = state.grad_accum + torch.sqrt(
                torch.sum(grads["xyz"] * grads["xyz"], dim=1))
            grad_denom = state.grad_denom + 1.0
            count = adam_step(cfg, state, leaves, grads, total_iterations)
            overflow_acc = state.overflow_acc + torch.stack(
                [aux.overflow_pairs, aux.overflow_gaussians]).to(torch.float32)
            color = out.color.detach()
            metrics = {
                "loss": loss.detach(), "l1": parts["l1"].detach(),
                "ssim": parts["ssim"].detach(), "depth": parts["depth"].detach(),
                "psnr": losses_mod.psnr(color, take("target_rgb")),
                "num_pairs": aux.num_pairs,
                "overflow_pairs": aux.overflow_pairs,
                "overflow_gaussians": aux.overflow_gaussians,
                "overflow_pairs_acc": overflow_acc[0],
                "overflow_gaussians_acc": overflow_acc[1],
                "grad_coverage": grad_coverage(active, grad_accum, state.num_active),
            }
            new_state = dataclasses.replace(
                state, count=count, grad_accum=grad_accum, grad_denom=grad_denom,
                step=state.step + 1, overflow_acc=overflow_acc,
            )
        return new_state, metrics, color

    return train_step


def densify_options(cfg: TrainConfig) -> dict:
    """The thresholds and factors of ``densify.split_and_prune`` that
    ``cfg`` sets."""
    d = cfg.densify
    return dict(
        grad_threshold=d.grad_threshold, max_scale=d.max_scale,
        min_opacity=d.min_opacity, split_scale_div=d.split_scale_div,
        split_noise_factor=d.split_noise_factor, clone_noise_std=d.clone_noise_std,
        max_gaussians=cfg.model.max_gaussians, prune_world_scale=d.prune_world_scale,
        prune_near_cameras=d.prune_near_cameras, prune_needle_ratio=d.prune_needle_ratio,
    )


def make_densify_step(cfg: TrainConfig, camera_centers: Optional[torch.Tensor] = None,
                      allow_densify: bool = True) -> Callable:
    """Build ``densify_step(state, noise) -> (state, DensifyStats)``, one
    densify/prune round (``densify.split_and_prune``) written into the
    state's parameter and moment tensors in place; ``noise`` is the
    [capacity, 3] draw.  With ``reset_optimizer_state`` (the reference's
    behaviour) Adam restarts from zero moments and count; otherwise the
    moments follow the gather map.  ``allow_densify=False`` builds the
    prune-only variant (``DensifyConfig.prune_until_iter``): no split or
    clone, and the moments always follow the map, which is lossless with no
    new rows.  The gradient statistic restarts from zero."""
    reset_adam = cfg.densify.reset_optimizer_state and allow_densify
    options = densify_options(cfg)

    @torch.no_grad()
    def densify_step(state: TrainState, noise: torch.Tensor):
        new, stats, gather_idx, noise_mode = densify_mod.split_and_prune(
            state.params, state.num_active, state.grad_accum, state.grad_denom, noise,
            allow_densify=allow_densify, camera_centers=camera_centers, **options)
        if not reset_adam:
            m = densify_mod.remap_optimizer_moments(state.m, gather_idx, noise_mode)
            v = densify_mod.remap_optimizer_moments(state.v, gather_idx, noise_mode)
        for n in PARAM_NAMES:
            getattr(state.params, n).copy_(new[n])
            if reset_adam:
                state.m[n].zero_()
                state.v[n].zero_()
            else:
                state.m[n].copy_(m[n])
                state.v[n].copy_(v[n])
        if reset_adam:
            state.count.zero_()
        state.num_active.copy_(stats.num_active)
        state.grad_accum.zero_()
        state.grad_denom.zero_()
        return state, stats

    return densify_step


def make_opacity_reset_step(cfg: TrainConfig) -> Callable:
    """Build ``opacity_reset_step(state) -> state``: live opacities clamped
    to <= ``opacity_reset_value`` and the opacity moments zeroed, so Adam
    does not at once re-saturate them; in place."""

    @torch.no_grad()
    def opacity_reset_step(state: TrainState):
        op = state.params.opacity
        op.copy_(densify_mod.reset_opacity(op, state.num_active,
                                           cfg.densify.opacity_reset_value))
        state.m["opacity"].zero_()
        state.v["opacity"].zero_()
        return state

    return opacity_reset_step


@torch.no_grad()
def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """The state padded to ``new_capacity`` slots in new tensors: zeros,
    identity quaternions (a zero quaternion puts NaN into the normalize
    backward) and opacity ``INACTIVE_OPACITY`` in the padding rows."""
    old = state.params.capacity
    if new_capacity <= old:
        return state
    pad_n = new_capacity - old

    def pad(x, fill=0.0):
        return torch.cat([x.detach(), x.new_full((pad_n,) + tuple(x.shape[1:]), fill)])

    quat_pad = state.params.rotation.new_zeros((pad_n, 4))
    quat_pad[:, 0] = 1.0
    p = state.params
    params = GaussianParams(
        xyz=pad(p.xyz), features_dc=pad(p.features_dc),
        features_rest=pad(p.features_rest), scales=pad(p.scales),
        rotation=torch.cat([p.rotation.detach(), quat_pad]),
        opacity=pad(p.opacity, INACTIVE_OPACITY),
    )
    return dataclasses.replace(
        state, params=params,
        m={n: pad(x) for n, x in state.m.items()},
        v={n: pad(x) for n, x in state.v.items()},
        grad_accum=pad(state.grad_accum),
    )


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; a CUDA device that is missing is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA device is available")
    return device


class Trainer:
    """Host loop on one device: camera sampling from numpy's default_rng
    (the JAX package's stream), previews, PLY snapshots, densify/prune
    rounds and capacity growth, opacity resets, log lines, pair-budget
    auto-grow/shrink, early stop and checkpoints.  ``device`` defaults to
    ``cuda``; pass ``"cpu"`` to train on the CPU with the kernels' plain
    versions.  The densify noise is the JAX package's stream: a threefry2x32
    key from ``config.seed`` (``utils/prng.py``), split once a densify or
    prune-only round, drawn on the device (``densify_noise``)."""

    def __init__(self, config: TrainConfig, data: TrainData,
                 point_cloud: PointCloud, device="cuda", mesh=None,
                 batched_views: Optional[bool] = None, backend: Optional[str] = None):
        """``backend``: the rasterizer of every step (``render``'s; None:
        ``config.raster.backend``).

        ``mesh`` (``parallel.sharding.Mesh``): train this rank's part of the
        data- and tile-parallel step, ``mesh.shape["data"]`` views a step.
        Without one, the Trainer builds the mesh from ``config.parallel``
        when that asks for more than one rank or a process group of several
        ranks exists (all of them, with the default 1 x 1).

        ``batched_views``: each rank keeps only its data shard's views, on
        the host, and moves its view of a step to the device
        (``parallel/multihost.py``); the same training as the replicated
        view store.  Default: on when the group spans several hosts."""
        par = config.parallel
        if config.densify.prune_near_cameras > 0 and multihost.host_count() > 1:
            # Per-host camera subsets would give each host another prune
            # mask and break the replicated state.
            raise NotImplementedError(
                "prune_near_cameras needs the full camera set on every host; it is "
                "not supported under multi-host training")
        if mesh is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if par.data_parallel != 1 or par.tile_parallel != 1 or world > 1:
                dp = par.data_parallel
                if world > 1 and dp == 1 and par.tile_parallel == 1:
                    # The default config under a group spans every rank.
                    dp = 0
                mesh = sharding.make_mesh(dp, par.tile_parallel)
        self.mesh = mesh
        self.cfg = config
        self.backend = backend
        self.data = data
        self.device = resolve_device(device)
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
        self.batched_views = False
        if mesh is not None:
            self.data_parallel = mesh.shape["data"]
            self.batched_views = (multihost.host_count() > 1 if batched_views is None
                                  else bool(batched_views))
            sharding.replicate_state(self.state, mesh)
            if self.batched_views:
                self._build_local_store()
                self.views = None
            else:
                self.views = stack_views(data, dev)
        else:
            self.views = stack_views(data, dev)
        self.out_dir = Path(config.output_dir)
        self.key = prng.prng_key(config.seed)
        cam_centers = None
        if config.densify.prune_near_cameras > 0:
            cam_centers = torch.stack([
                torch.as_tensor(np.asarray(c.tensors()["camera_center"], np.float32)).reshape(3)
                for c in data.cameras]).to(dev)
        self.densify_step = make_densify_step(config, cam_centers)
        self.prune_step = (
            make_densify_step(config, cam_centers, allow_densify=False)
            if config.densify.prune_until_iter > config.densify.until_iter else None)
        self.opacity_reset_step = make_opacity_reset_step(config)
        if config.densify.opacity_reset_interval > 0 and config.densify.reset_optimizer_state:
            # The reference's per-densify Adam restart (no bias correction)
            # makes the first steps after a round ~3.16x lr; right after an
            # opacity reset the gradients are small and noisy.
            print("NOTE: opacity_reset_interval with reset_optimizer_state=True "
                  "(reference Adam semantics) amplifies post-densify steps on a "
                  "freshly-reset model — INRIA pairs resets with moment carry-over "
                  "(reset_optimizer_state=False, implemented)", file=sys.stderr, flush=True)
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
        self._touch_heartbeat()
        cfg, data = self.cfg, self.data
        if self.mesh is not None:
            self.train_step = sharding.make_dp_train_step(
                cfg, data.width, data.height, cfg.model.sh_degree, cfg.iterations,
                self.mesh, batched_views=self.batched_views, backend=self.backend)
        else:
            self.train_step = make_train_step(
                cfg, data.width, data.height, cfg.model.sh_degree, cfg.iterations,
                self.backend)

    def _build_local_store(self) -> None:
        """Batched views: each data shard samples from a contiguous block of
        the views (wrap-padded, so every shard samples uniformly), and this
        rank stacks on the host only its own shard's views."""
        ndata, nv = self.data_parallel, self.data.num_views
        per = -(-nv // ndata)
        self.shard_views = [(np.arange(s * per, (s + 1) * per) % nv).astype(np.int64)
                            for s in range(ndata)]
        self.local_shards, _ = multihost.local_data_shards(self.mesh)
        local_ids = np.unique(np.concatenate([self.shard_views[s] for s in self.local_shards]))
        self.local_ids = local_ids
        self.local_store = stack_views_host(self.data, local_ids)

    def _batched_step(self):
        """One batched-views step: every rank draws the whole per-shard
        vector of view ids from the same stream and moves only its own
        shard's view to the device.  Returns (chosen, metrics, image)."""
        chosen = np.asarray([
            self.shard_views[s][int(self.rng.integers(0, len(self.shard_views[s])))]
            for s in range(self.data_parallel)], np.int64)
        local_batch = multihost.select_local_batch(self.local_store, self.local_ids,
                                                   chosen[self.local_shards])
        batch = multihost.make_global_view_batch(local_batch, self.mesh, self.device)
        self.state, metrics, image = self.train_step(self.state, batch)
        return chosen, metrics, image

    @property
    def is_writer(self) -> bool:
        """Only rank 0 writes previews, snapshots, checkpoints, the heartbeat
        and curves."""
        return not dist.is_initialized() or dist.get_rank() == 0

    def _check_replicated(self, what: str) -> None:
        if self.mesh is not None:
            sharding.assert_replicated(self.state, self.mesh, what)

    def set_max_pairs(self, max_pairs: int) -> None:
        """Set the pair budget (for example from a probe of the views) and
        make it the auto-shrink floor."""
        self.cfg = dataclasses.replace(
            self.cfg, raster=dataclasses.replace(self.cfg.raster, max_pairs=max_pairs))
        self._initial_max_pairs = max_pairs
        self._build_train_step()

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

    def next_key(self) -> np.ndarray:
        """Split the key as the JAX trainer does: keep the first half, return
        the second."""
        self.key, sub = prng.split(self.key)
        return sub

    def densify_noise(self, capacity: int) -> torch.Tensor:
        """The [capacity, 3] standard-normal draw of one densify round: JAX's
        ``jax.random.normal(next_key(), (capacity, 3))``."""
        return prng.normal(self.next_key(), (capacity, 3), self.device)

    def run(self, iterations: Optional[int] = None,
            on_metrics: Optional[Callable] = None) -> Dict:
        """Train up to ``iterations`` (default ``cfg.iterations``); returns the
        last logged metrics (host floats)."""
        cfg = self.cfg
        d = cfg.densify
        iterations = iterations if iterations is not None else cfg.iterations
        start = int(self.state.step)  # nonzero when resumed from a checkpoint
        if self.device.type == "cuda" and not _kernels.LIBRARY.loaded:
            self._touch_heartbeat()
            _kernels.LIBRARY.cdll()
        last_log, last_step = time.time(), start
        final = {}
        for it in range(start + 1, iterations + 1):
            if self.mesh is not None and self.batched_views:
                chosen, metrics, image = self._batched_step()
                view_idx = int(chosen[0])
            elif self.mesh is not None:
                idxs = self.rng.integers(0, self.data.num_views, size=self.data_parallel)
                view_idx = int(idxs[0])
                self.state, metrics, image = self.train_step(
                    self.state, self.views, sharding.shard_view_idx(idxs, self.mesh))
            else:
                view_idx = int(self.rng.integers(0, self.data.num_views))
                self.state, metrics, image = self.train_step(self.state, self.views, view_idx)
            # Rank 0 is data shard 0: its image is view_idx's.
            if it % cfg.preview_interval == 0 and cfg.output_dir and self.is_writer:
                self.save_preview(it, image, view_idx)
            if it % cfg.snapshot_interval == 0 and cfg.output_dir:
                self.save_snapshot(it)

            in_densify = d.from_iter <= it <= d.until_iter
            in_prune_only = self.prune_step is not None and d.until_iter < it <= d.prune_until_iter
            if it % d.interval == 0 and (in_densify or in_prune_only):
                step_fn = self.densify_step if in_densify else self.prune_step
                noise = self.densify_noise(self.state.params.capacity)
                self.state, _ = step_fn(self.state, noise)
                self._check_replicated(f"after the densify round at step {it}")
                self.maybe_grow()

            if d.opacity_reset_interval > 0 and it % d.opacity_reset_interval == 0 \
                    and it <= d.until_iter:
                self.state = self.opacity_reset_step(self.state)
                self._check_replicated(f"after the opacity reset at step {it}")

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
            if cfg.checkpoint_interval and it % cfg.checkpoint_interval == 0 and cfg.output_dir:
                self.save_checkpoint(it)
        return final

    def maybe_grow(self) -> None:
        """Double the capacity (up to the power of two that holds
        ``max_gaussians``) once more than 85% of it is live."""
        cap = self.state.params.capacity
        n = int(self.state.num_active)
        if n > 0.85 * cap and cap < self.cfg.model.max_gaussians:
            new_cap = min(cap * 2, _next_pow2(self.cfg.model.max_gaussians))
            self._touch_heartbeat()
            self.state = grow_capacity(self.state, new_cap)
            self._check_replicated(f"after the capacity growth to {new_cap}")

    def _touch_heartbeat(self) -> None:
        """Refresh the supervisor heartbeat (``metrics.jsonl``'s mtime in the
        output directory) before a long pause, so that a supervisor reading
        a stale heartbeat as a stall does not kill and restart the run into
        the same pause."""
        if self.cfg.output_dir and self.is_writer:
            try:
                (self.out_dir / "metrics.jsonl").touch()
            except OSError:
                pass

    def save_loss_curve(self) -> None:
        """Loss (left axis) and PSNR (right axis) against iteration over the
        logged steps, as an 800x400 RGB PNG, ``loss_curve.png`` in the output
        directory."""
        if not self.history or not self.is_writer:
            return
        img = two_axis_chart([m["iteration"] for m in self.history],
                             [m["loss"] for m in self.history],
                             [m["psnr"] for m in self.history],
                             "loss", "psnr (dB)", "iteration")
        write_png(self.out_dir / "loss_curve.png", img)

    def save_preview(self, iteration: int, image: torch.Tensor, view_idx: int) -> None:
        """The rendered image beside its target, as one PNG under previews/."""
        d = self.out_dir / "previews"
        d.mkdir(parents=True, exist_ok=True)
        rendered = np.clip(image.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        gt = np.clip(self.data.images[view_idx] * 255.0, 0, 255).astype(np.uint8)
        write_png(d / f"iter_{iteration:06d}_v{view_idx}.png",
                  np.concatenate([rendered, gt], axis=1))

    def save_snapshot(self, iteration: int) -> None:
        """The live rows' raw parameters as a Gaussian PLY."""
        if not self.is_writer:
            return
        n = int(self.state.num_active)
        p = self.state.params.to_numpy()
        ply.write_gaussian_ply(
            self.out_dir / f"iteration_{iteration}.ply",
            p["xyz"][:n], p["features_dc"][:n], p["features_rest"][:n],
            p["opacity"][:n], p["scales"][:n], p["rotation"][:n],
        )

    def save_checkpoint(self, iteration: int) -> None:
        from . import checkpoint

        if not self.is_writer:
            return
        checkpoint.save(self.out_dir / f"ckpt_{iteration}.npz", self.state, self.cfg,
                        host_rng=self.rng, key=self.key)

    def restore_checkpoint(self, path) -> None:
        """Resume from a checkpoint of either package: the camera sequence
        and the densify noise replay.  A port checkpoint older than the key
        (no ``jax_key``) restarts the key from the seed."""
        from . import checkpoint

        self.state, host_rng, key = checkpoint.load(path, self.device)
        if host_rng is not None:
            self.rng = host_rng
        if key is not None:
            self.key = key
        else:
            self.key = prng.prng_key(self.cfg.seed)
            print(f"NOTE: {path} holds no densify noise key (jax_key): the key restarts "
                  "from the seed and the noise will not replay the saved run's",
                  file=sys.stderr, flush=True)
        # Overflow accumulated before the checkpoint was handled then.
        self._overflow_handled = float(self.state.overflow_acc[0])
        # An auto-grown pair budget is run-time state that the saved config
        # records: adopt it when larger, or the resumed run would truncate
        # (and grow) its way through the same overflows again.
        saved = checkpoint.load_config(path)
        if saved is not None and saved.raster.max_pairs > self.cfg.raster.max_pairs:
            self.cfg = dataclasses.replace(self.cfg, raster=dataclasses.replace(
                self.cfg.raster, max_pairs=saved.raster.max_pairs))
            self._build_train_step()
        self._check_replicated(f"after restoring {path}")
