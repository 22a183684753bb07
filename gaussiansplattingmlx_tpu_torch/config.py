"""Configuration: the port's copies of the JAX package's config dataclasses
(same fields, same defaults; a test pins the two packages' fields).

The port keeps its own copy so that it never imports the JAX package.
``RasterizerConfig`` checks its selectors when it is built: every value of
the JAX package's is accepted, anything else raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Static-shape rasterizer / tile-binning configuration."""

    # Pixel tile size (the CUDA compositing kernel runs one thread per pixel,
    # so tile_h * tile_w <= 1024).
    tile_h: int = 16
    tile_w: int = 16
    # Global (gaussian, tile) pair budget: the one truncating capacity.
    # Binning reports overflow_pairs when the exact pair total exceeds it.
    max_pairs: int = 2 ** 20
    auto_grow: bool = True
    max_pairs_limit: int = 2 ** 23
    auto_shrink: bool = True
    # Ownership quantum of the chunk-aligned layouts (each tile owns whole
    # chunks), trailing zero columns of the sorted buffers, and the budget
    # quantum of render_cli's auto pair budget.
    chunk_size: int = 128
    # Per-Gaussian gradient reduction: "segsum" (gid sort + kernel K4) or
    # "scatter" (a scatter-add of each record column into its gaussian's
    # row, ``rasterize_cuda.scatter_reduce``).
    grad_reduce: str = "segsum"
    # Compositing constants.
    alpha_clamp: float = 0.99
    transmittance_eps: float = 1e-4
    undo_denom_floor: float = 1e-6
    # Projection constants.
    ndc_w_eps: float = 1e-6
    z_cull: float = 0.2
    cov2d_dilation: float = 0.3
    tanfov_clip: float = 1.3
    radius_eigen_eps: float = 1e-5
    quat_norm_eps: float = 1e-8
    # "auto", "pallas" and "pallas_interpret" all mean the port's kernels on
    # CUDA tensors and their plain versions on CPU tensors; "reference" is
    # the oracle rasterizer (``ops/rasterize_ref.rasterize_reference``, plain
    # torch on any device).  The JAX package's "auto" means "reference" off
    # a TPU; the port's does not, because its kernels' plain versions are
    # the JAX kernels' counterparts on the CPU and the tests hold them to
    # the JAX package there: the oracle is chosen by name.
    backend: str = "auto"
    # "fused": merge-gather staging (``ops/staging.py``); inference always
    # composites sorted-order records.  "split": ``binning.bin_gaussians``
    # then the chunk-aligned record gather (``rasterize_cuda.rasterize_split``),
    # for inference and training.
    staging: str = "fused"
    # Training layout under fused staging: "sorted" (sorted-order records,
    # backward K3) or "aligned" (chunk-aligned relayout K6, backward K7).
    train_staging: str = "sorted"

    def __post_init__(self):
        for name, values in SELECTORS.items():
            value = getattr(self, name)
            if value not in values:
                raise ValueError(
                    f"RasterizerConfig.{name}={value!r}: expected one of {values}")


# The values of each RasterizerConfig selector.
SELECTORS = {
    "backend": ("auto", "pallas", "pallas_interpret", "reference"),
    "grad_reduce": ("segsum", "scatter"),
    "staging": ("fused", "split"),
    "train_staging": ("sorted", "aligned"),
}


# The RasterizerConfig fields that select each record layout: "sorted" the
# default, "aligned" and "split" the JAX package's other two.
LAYOUTS = {
    "sorted": {},
    "aligned": {"train_staging": "aligned"},
    "split": {"staging": "split"},
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 4
    init_opacity: float = 0.1
    knn_k: int = 3
    dist2_floor: float = 1e-7
    # Fixed parameter capacity; inactive slots are culled by the projection.
    initial_capacity: int = 2 ** 14
    max_gaussians: int = 1_000_000
    # SH band warmup: band d trains from iteration d * interval (0 = off).
    sh_warmup_interval: int = 0


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam without bias correction, eps inside the denominator, one
    learning rate per parameter (``train/optimizer.py``)."""

    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    bias_correction: bool = False
    # Per-parameter LR table; xyz decays linearly to lr_xyz * xyz_lr_floor.
    lr_xyz: float = 1.6e-4
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 2.5e-3 / 20.0
    lr_scales: float = 5e-3
    lr_rotation: float = 1e-3
    lr_opacity: float = 2.5e-2
    xyz_lr_floor: float = 0.01
    spatial_lr_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Split/clone/prune cadence and thresholds (``train/densify.py``):
    densify rounds every ``interval`` iterations in [from_iter, until_iter],
    prune-only rounds after it up to ``prune_until_iter``, opacity resets
    every ``opacity_reset_interval`` iterations up to ``until_iter``."""

    interval: int = 100
    from_iter: int = 500
    until_iter: int = 15000
    grad_threshold: float = 2e-4
    max_scale: float = 0.01
    min_opacity: float = 5e-3
    split_scale_div: float = 1.6
    split_noise_factor: float = 0.1
    clone_noise_std: float = 0.01
    reset_optimizer_state: bool = True
    opacity_reset_interval: int = 0
    opacity_reset_value: float = 0.01
    prune_world_scale: float = 0.0
    prune_near_cameras: float = 0.0
    prune_needle_ratio: float = 0.0
    prune_until_iter: int = 0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    lambda_dssim: float = 0.2
    lambda_depth: float = 0.0
    ssim_window: int = 11
    ssim_sigma: float = 1.5
    ssim_c1: float = 0.01 ** 2
    ssim_c2: float = 0.03 ** 2


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    znear: float = 0.1
    zfar: float = 100.0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    tile_axis: str = "tile"
    data_parallel: int = 1
    tile_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    iterations: int = 30000
    resize_factor: float = 0.5
    init_points: int = 16384
    white_background: bool = False
    snapshot_interval: int = 100
    log_interval: int = 10
    preview_interval: int = 20
    early_stop_loss: float = 1e-4
    seed: int = 0
    output_dir: str = "outputs"
    checkpoint_interval: int = 1000

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    raster: RasterizerConfig = dataclasses.field(default_factory=RasterizerConfig)
    optim: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    densify: DensifyConfig = dataclasses.field(default_factory=DensifyConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "TrainConfig":
        """Build from JSON; unknown keys are ignored, missing keys default."""

        def build(cls, data):
            names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {}
            for key, value in data.items():
                if key not in names:
                    continue
                sub = _NESTED.get(key)
                kwargs[key] = build(sub, value) if sub and isinstance(value, dict) else value
            return cls(**kwargs)

        return build(TrainConfig, json.loads(text))


_NESTED = {
    "model": ModelConfig,
    "raster": RasterizerConfig,
    "optim": OptimizerConfig,
    "densify": DensifyConfig,
    "loss": LossConfig,
    "camera": CameraConfig,
    "parallel": ParallelConfig,
}
