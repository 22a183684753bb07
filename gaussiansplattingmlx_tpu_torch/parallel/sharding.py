"""Camera data-parallelism and the pixel-band split on ``torch.distributed``
(torch counterpart of the JAX package's ``parallel/sharding.py``).

One process per rank.  The ranks form a (data, tile) mesh laid out row-major,
``rank = d * T + t``, as the JAX package's ``reshape(data, tile)``:

* "data": each data coordinate trains on a different camera view per step.
  The parameters are replicated, and the per-view gradients are averaged
  over the data group: gradient accumulation over a batch of views.
* "tile": the ranks of one data coordinate each render one horizontal band
  of its view (band height H / T, a multiple of the tile height, so that the
  band tiling is the full image's tiling).  The bands are all-gathered
  without autograd and concatenated, detached, around the rank's own band,
  which keeps its graph; the L1 + SSIM loss is computed on the full image,
  so SSIM windows at the band seams see real rows.  Each rank's backward
  then gives its band's share of the full-image gradient, and a SUM over
  the tile group gives the whole of it: the function the JAX step computes
  (its ``all_gather`` transpose and ``pmean``), with the sums in another
  order.

The densify statistic is the mean over views of each view's |d xyz|, not
the norm of the averaged gradient.  Pair counts are summed over bands and
averaged over views; overflow counts are summed over both axes.

Every decision of the host loop must be taken from values that are the same
on every rank (the seeded camera draw, reduced metrics, replicated state),
or the collectives deadlock.  The step uses only the collectives that both
NCCL and gloo run on CUDA tensors: ``all_reduce``, list ``all_gather`` and
``broadcast``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..models.gaussians import PARAM_NAMES
from ..ops import losses as losses_mod
from ..train import trainer as trainer_mod


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, tile) mesh and its process groups.
    A group with one member is None, and its collectives are no-ops."""

    shape: Dict[str, int]  # {"data": D, "tile": T}
    data_index: int
    tile_index: int
    ranks: tuple  # global ranks of the mesh, in mesh order
    group: Optional[object]  # the whole mesh
    data_group: Optional[object]  # the ranks of this tile index, across data
    tile_group: Optional[object]  # the ranks of this data index, across tiles
    # Host clock around the step's collectives, summed over calls.
    collective_seconds: float = 0.0
    collective_calls: int = 0


def make_mesh(data_parallel: int = 0, tile_parallel: int = 1, group=None) -> Mesh:
    """The (data, tile) mesh over the ranks of ``group`` (default: every
    rank of the default process group; without one, a single rank).
    ``data_parallel=0`` takes all ranks divided by ``tile_parallel``.  Every
    rank of the default group calls it, in the same order as every other
    group it creates (``torch.distributed.new_group``'s rule)."""
    if dist.is_initialized():
        ranks = tuple(range(dist.get_world_size()) if group is None
                      else dist.get_process_group_ranks(group))
        me = dist.get_rank()
    else:
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not "
                             "initialized")
        ranks, me = (0,), 0
    n = len(ranks)
    if tile_parallel < 1:
        raise ValueError(f"tile_parallel must be >= 1, got {tile_parallel}")
    if data_parallel <= 0:
        data_parallel = n // tile_parallel
    need = data_parallel * tile_parallel
    if need != n:
        how = "more than" if need > n else "fewer than"
        raise ValueError(
            f"a {data_parallel} x {tile_parallel} (data x tile) mesh needs {need} ranks, "
            f"{how} the {n} in the process group: start that many ranks (torchrun, or "
            "gaussiansplattingmlx_tpu_torch.parallel.launch.spawn)")
    whole = data_group = tile_group = None
    if n > 1:
        whole = group if group is not None else dist.group.WORLD
        if data_parallel > 1:
            for t in range(tile_parallel):
                g = dist.new_group([ranks[d * tile_parallel + t] for d in range(data_parallel)])
                if me in ranks and ranks.index(me) % tile_parallel == t:
                    data_group = g
        if tile_parallel > 1:
            for d in range(data_parallel):
                g = dist.new_group([ranks[d * tile_parallel + t] for t in range(tile_parallel)])
                if me in ranks and ranks.index(me) // tile_parallel == d:
                    tile_group = g
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh's process group {ranks}")
    d, t = divmod(ranks.index(me), tile_parallel)
    return Mesh(shape={"data": data_parallel, "tile": tile_parallel}, data_index=d,
                tile_index=t, ranks=ranks, group=whole, data_group=data_group,
                tile_group=tile_group)


def _timed(mesh: Mesh, collective: Callable, *args, **kwargs) -> None:
    t0 = time.perf_counter()
    collective(*args, **kwargs)
    mesh.collective_seconds += time.perf_counter() - t0
    mesh.collective_calls += 1


def all_reduce(x: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """SUM of ``x`` over ``group``, in place (nothing with one member)."""
    if group is not None:
        _timed(mesh, dist.all_reduce, x, group=group)
    return x


def gather_bands(band: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full image from every tile rank's band (rows first): the other
    bands gathered without autograd, this rank's own band with its graph."""
    if mesh.tile_group is None:
        return band
    parts = [torch.empty_like(band) for _ in range(mesh.shape["tile"])]
    _timed(mesh, dist.all_gather, parts, band.detach().contiguous(), group=mesh.tile_group)
    parts[mesh.tile_index] = band
    return torch.cat(parts, dim=0)


def check_band_split(image_height: int, tile_parallel: int, tile_h: int) -> int:
    """The band height of a ``tile_parallel``-way split.  Exactness needs
    the band tiling to coincide with the full image's: the image height a
    multiple of the tile axis and the band height a multiple of tile_h (a
    single full-height band has no seam)."""
    band_h = image_height // tile_parallel
    if tile_parallel > 1:
        if image_height % tile_parallel:
            raise ValueError(f"tile-parallel needs the image height ({image_height}) "
                             f"divisible by the tile axis ({tile_parallel})")
        if band_h % tile_h:
            raise ValueError(
                f"tile-parallel needs the band height ({band_h}) to be a multiple of "
                f"tile_h ({tile_h}), so that the band tiling is the full image's tiling")
    return band_h


def make_dp_train_step(cfg: TrainConfig, image_width: int, image_height: int,
                       sh_degree: int, total_iterations: int, mesh: Mesh,
                       batched_views: bool = False, backend: Optional[str] = None) -> Callable:
    """The data- and tile-parallel train step of this rank, rendering with
    ``backend`` (``render``'s; None: ``cfg.raster.backend``).

    ``train_step(state, views, view_idx) -> (state, metrics, image)``:
    ``views`` holds every view's tensors (each rank the same), and
    ``view_idx`` selects this rank's camera (``shard_view_idx``).  With
    ``batched_views=True`` it is ``train_step(state, view_batch)``, where
    ``view_batch`` holds only this rank's view as a batch of one row
    (``multihost.make_global_view_batch``); the two forms compute the same.

    The parameters and moments are updated in place from the gradients
    averaged over the mesh, identically on every rank.  ``metrics`` are 0-d
    tensors, equal on every rank; ``image`` is this rank's full rendered
    view [H, W, 3] (detached).
    """
    n_data, n_tile = mesh.shape["data"], mesh.shape["tile"]
    band_h = check_band_split(image_height, n_tile, cfg.raster.tile_h)
    band = dict(pixel_y_offset=mesh.tile_index * band_h, full_image_height=image_height)

    def train_step(state: trainer_mod.TrainState, views: Dict, view_idx: int):
        def take(k):
            return views[k][view_idx]

        leaves, active, out, aux = trainer_mod.render_view(
            cfg, state, take, image_width, band_h, sh_degree, backend, **band)
        # The loss of the full image, identical on every tile rank: SSIM at
        # the band seams sees real rows.
        color = gather_bands(out.color, mesh)
        depth = gather_bands(out.depth, mesh)
        loss, parts = trainer_mod.view_loss(cfg, color, depth, take)
        grads = trainer_mod.param_grads(loss, leaves)

        with torch.no_grad():
            capacity = state.params.capacity
            color = color.detach()
            # This band's share of the view's gradient, summed over the
            # tile group: the view's full-image gradient.
            flat = torch.cat([grads[n].reshape(-1) for n in PARAM_NAMES])
            counts = torch.stack([aux.num_pairs, aux.overflow_pairs,
                                  aux.overflow_gaussians]).to(torch.int64)
            all_reduce(flat, mesh.tile_group, mesh)
            all_reduce(counts, mesh.tile_group, mesh)
            xyz = flat[:capacity * 3].view(capacity, 3)
            # Means over the data group: the gradients, the per-view |d xyz|
            # (densify statistic), the loss and its parts, the PSNR.
            scalars = torch.stack([loss.detach(), parts["l1"].detach(),
                                   parts["ssim"].detach(), parts["depth"].detach(),
                                   losses_mod.psnr(color, take("target_rgb"))])
            buf = torch.cat([flat, torch.sqrt(torch.sum(xyz * xyz, dim=1)), scalars])
            all_reduce(buf, mesh.data_group, mesh)
            all_reduce(counts, mesh.data_group, mesh)
            buf /= n_data
            mean_grads, off = {}, 0
            for n in PARAM_NAMES:
                size = leaves[n].numel()
                mean_grads[n] = buf[off:off + size].view_as(leaves[n])
                off += size
            grad_norm = buf[off:off + capacity]
            loss_m, l1_m, ssim_m, depth_m, psnr_m = buf[off + capacity:]

            grad_accum = state.grad_accum + grad_norm
            count = trainer_mod.adam_step(cfg, state, leaves, mean_grads, total_iterations)
            overflow = counts[1:].to(torch.float32)
            overflow_acc = state.overflow_acc + overflow
            metrics = {
                "loss": loss_m, "l1": l1_m, "ssim": ssim_m, "depth": depth_m, "psnr": psnr_m,
                # Mean pairs a view: the bands' counts summed, then averaged
                # over the views of the step.
                "num_pairs": (counts[0].to(torch.float64) / n_data).to(torch.float32),
                "overflow_pairs": overflow[0],
                "overflow_gaussians": overflow[1],
                "overflow_pairs_acc": overflow_acc[0],
                "overflow_gaussians_acc": overflow_acc[1],
                "grad_coverage": trainer_mod.grad_coverage(active, grad_accum,
                                                           state.num_active),
            }
        new_state = dataclasses.replace(
            state, count=count, grad_accum=grad_accum, grad_denom=state.grad_denom + 1.0,
            step=state.step + 1, overflow_acc=overflow_acc,
        )
        return new_state, metrics, color

    if batched_views:
        def batched(state: trainer_mod.TrainState, view_batch: Dict):
            return train_step(state, view_batch, 0)

        return batched
    return train_step


def _state_tensors(state: trainer_mod.TrainState) -> Dict[str, torch.Tensor]:
    out = {n: getattr(state.params, n).detach() for n in PARAM_NAMES}
    out.update({f"m_{n}": state.m[n] for n in PARAM_NAMES})
    out.update({f"v_{n}": state.v[n] for n in PARAM_NAMES})
    for k in ("count", "num_active", "grad_accum", "grad_denom", "step", "overflow_acc"):
        out[k] = getattr(state, k)
    return out


@torch.no_grad()
def replicate_state(state: trainer_mod.TrainState, mesh: Mesh) -> trainer_mod.TrainState:
    """Rank ``mesh.ranks[0]``'s state on every rank of the mesh (broadcast
    into each rank's tensors, in place)."""
    if mesh.group is not None:
        for t in _state_tensors(state).values():
            dist.broadcast(t, src=mesh.ranks[0], group=mesh.group)
    return state


@torch.no_grad()
def state_digest(state: trainer_mod.TrainState) -> torch.Tensor:
    """[tensors] int64: for each tensor of the state, the sum of its 32-bit
    patterns weighted by position (modulo 2^64).  Equal states give equal
    digests; a difference in any bit almost surely changes one."""
    out = []
    for t in _state_tensors(state).values():
        bits = t.contiguous().reshape(-1)
        if bits.dtype == torch.float32:
            bits = bits.view(torch.int32)
        bits = bits.to(torch.int64)
        weights = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 1021 + 1
        out.append(torch.sum(bits * weights))
    return torch.stack(out)


def assert_replicated(state: trainer_mod.TrainState, mesh: Mesh, what: str = "") -> None:
    """Raise unless every rank of the mesh holds the same state, bit for bit
    (compared by ``state_digest``)."""
    if mesh.group is None:
        return
    digest = state_digest(state)
    digests = [torch.empty_like(digest) for _ in mesh.ranks]
    dist.all_gather(digests, digest, group=mesh.group)
    names = list(_state_tensors(state))
    differ = sorted({names[i] for d in digests[1:]
                     for i in torch.nonzero(d != digests[0]).reshape(-1).tolist()})
    if differ:
        raise RuntimeError(f"training state differs across ranks{' ' + what if what else ''}: "
                           f"{differ}")


def replicate_views(views: Dict, device) -> Dict[str, torch.Tensor]:
    """Every view's tensors on this rank's ``device`` (each rank holds all)."""
    return {k: torch.as_tensor(v).to(device) for k, v in views.items()}


def shard_view_idx(view_idx: Sequence[int], mesh: Mesh) -> int:
    """This rank's entry of the [data_parallel] camera draw of a step."""
    return int(np.asarray(view_idx)[mesh.data_index])
