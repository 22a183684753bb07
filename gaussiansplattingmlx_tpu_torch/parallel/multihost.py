"""Multi-host training on ``torch.distributed`` (torch counterpart of the
JAX package's ``parallel/multihost.py``).

Here a "process" is a host (a node in torchrun's terms) and a "device" is a
rank.  torchrun starts one process per rank on every host and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`initialize` joins the group
they name.  Each host loads only its own slice of the camera views
(:func:`local_view_range`), and each rank assembles only its own row of a
step's view batch (:func:`select_local_batch`,
:func:`make_global_view_batch`), so camera pixels never leave their host:
only gradients cross hosts, inside the step's all-reduces.

A single process degenerates cleanly: without torchrun's variables
:func:`initialize` is a no-op, :func:`host_count` is 1 and
:func:`local_view_range` returns every view.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import sharding


def initialize(backend: str = "gloo", device: Optional[torch.device] = None,
               timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group that torchrun's variables name (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  ``device``, a CUDA
    device, becomes this process's current device first.  A no-op without
    those variables, or when a group exists already.  Returns whether this
    call joined one."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE is set but {missing} are not: start the ranks with "
                         "torchrun, which sets them all")
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return True


def _ranks_per_host() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def host_index() -> int:
    """This host's index (torchrun's node rank)."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank() // _ranks_per_host()


def host_count() -> int:
    """The number of hosts in the group: ranks over ranks a host."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size() // _ranks_per_host()


def local_view_range(num_views: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> np.ndarray:
    """Global view indices this host is responsible for loading: a
    contiguous block partition, padded by wrap-around so that every host
    owns the same count."""
    pi = host_index() if process_index is None else process_index
    pc = host_count() if process_count is None else process_count
    per = -(-num_views // pc)  # ceil
    return (np.arange(pi * per, (pi + 1) * per) % num_views).astype(np.int64)


def data_process_mesh(tile_parallel: int = 1) -> sharding.Mesh:
    """The (data, tile) mesh over every rank.  torchrun numbers the ranks
    host by host, so the row-major layout keeps a host's ranks adjacent
    along "data"."""
    return sharding.make_mesh(0, tile_parallel)


def local_data_shards(mesh: sharding.Mesh) -> Tuple[np.ndarray, int]:
    """(positions, count): the "data" coordinates whose views this rank
    materializes.  A rank is one device, so it holds one: its own."""
    return np.asarray([mesh.data_index], np.int64), 1


def make_global_view_batch(local_batch: Dict[str, np.ndarray], mesh: sharding.Mesh,
                           device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a step's view batch (``local_batch[k][i]``: the
    i-th data shard of ``local_data_shards``) as tensors on ``device``.  In
    torch each rank already holds only its own rows, so the global batch is
    the set of every rank's rows and is never assembled in one place."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in local_batch.items()}


def select_local_batch(views: Dict[str, np.ndarray], local_views: np.ndarray,
                       chosen: np.ndarray) -> Dict[str, np.ndarray]:
    """This rank's per-step batch from its host-local view store: ``views``
    holds only this host's cameras (stacked, in ``local_views`` order);
    ``chosen`` gives, per local data shard, the GLOBAL view id drawn for the
    step (one of ``local_views``)."""
    lookup = {int(g): i for i, g in enumerate(local_views)}
    rows = np.asarray([lookup[int(c)] for c in chosen], np.int64)
    return {k: np.asarray(v)[rows] for k, v in views.items()}


def sample_local_view_ids(rng: np.random.Generator, local_views: np.ndarray,
                          n_shards: int) -> np.ndarray:
    """One host-local GLOBAL view id per local data shard."""
    return local_views[rng.integers(0, len(local_views), size=n_shards)]
