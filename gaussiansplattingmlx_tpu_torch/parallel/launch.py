"""Start the ranks of one host: ``spawn(fn, world_size, device)`` runs
``fn`` in ``world_size`` new processes, one a rank, joined in a process
group (the one-host counterpart of the JAX package's
``scripts/launch_multihost.py``; across hosts, torchrun starts the ranks and
``multihost.initialize`` joins them).

Each rank computes on ``rank_device(device)``: a bare ``"cuda"`` gives
every rank a card of its own (``cuda:{LOCAL_RANK}``, NCCL), while a named
device (``"cuda:0"``, ``"cpu"``) is shared by all ranks, over gloo (NCCL
refuses two ranks on one card).  The ranks start with the ``spawn`` method,
since the caller may have initialised CUDA, and meet through a
``FileStore`` in a temporary directory, so that parallel callers never
share a port.  A rank that fails or hangs fails the whole call: the others
are stopped and the error is raised.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops import _kernels

# A rank that has exited without its result is given this long for the
# result to arrive before the call fails.
_EXIT_GRACE_S = 5.0


def rank_device(device) -> torch.device:
    """This rank's device for the device a user named: a bare ``"cuda"`` is
    ``cuda:{LOCAL_RANK}``; any other name is used as given.  A missing card,
    or a rank without a card of its own, is an error."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        visible = torch.cuda.device_count()
        if local >= visible:
            raise RuntimeError(
                f"local rank {local} has no card of its own ({visible} CUDA devices "
                "visible): start at most one rank a card, or name one device for all "
                "ranks to share (--device cuda:0)")
        dev = torch.device("cuda", local)
    return dev


def shares_device(device) -> bool:
    """Whether every rank computes on the one device ``device`` names."""
    dev = torch.device(device)
    return dev.type != "cuda" or dev.index is not None


def default_backend(device) -> str:
    """NCCL when each rank has a card of its own, gloo otherwise."""
    return "gloo" if shares_device(device) else "nccl"


def check_world(world_size: int, device) -> None:
    """Raise when ``world_size`` ranks cannot each have the card a bare
    ``"cuda"`` gives them (the counterpart of the JAX mesh's check that it
    has enough devices)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available")
    if dev.index is None and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"{world_size} ranks need {world_size} cards with device 'cuda', but "
            f"{torch.cuda.device_count()} are visible: name one device for all ranks to "
            "share (--device cuda:0)")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world_size, device, backend, init_file, pg_timeout, fn, args, env, out):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world_size),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world_size), **env})
    msg = {"rank": rank}
    try:
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # Ranks on the CPU share its cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        if init_file is not None:
            dist.init_process_group(
                backend, store=dist.FileStore(init_file, world_size), rank=rank,
                world_size=world_size, timeout=datetime.timedelta(seconds=pg_timeout))
        for k in _kernels.KERNELS:
            k.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result, report = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        report = {"rank": rank, "device": str(dev), "seconds": time.perf_counter() - t0,
                  "launches": _kernels.launch_counts(),
                  "peak_memory": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
                  **report}
        msg.update(ok=True, result=result if rank == 0 else None, report=report)
    except Exception:  # reported to the parent, which raises it
        msg.update(ok=False, error=traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out.put(msg)


def _collect(procs, out, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    msgs, exited = {}, {}
    while len(msgs) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = [r for r in range(len(procs)) if r not in msgs]
            raise TimeoutError(f"ranks {missing} did not finish within {timeout} s")
        try:
            msg = out.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in msgs or p.exitcode is None:
                    continue
                if now - exited.setdefault(r, now) > _EXIT_GRACE_S:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                       "without a result")
            continue
        if not msg["ok"]:
            raise RuntimeError(f"rank {msg['rank']} failed:\n{msg['error']}")
        msgs[msg["rank"]] = msg
    return [msgs[r] for r in range(len(procs))]


def spawn(fn: Callable, world_size: int, device="cuda", backend: Optional[str] = None,
          init_file: Optional[str] = None, args: tuple = (), timeout: float = 3600.0,
          pg_timeout: float = 600.0, env: Optional[dict] = None,
          init_group: bool = True):
    """Run ``fn(*args)`` in ``world_size`` ranks and wait for all of them.

    ``fn`` is a module-level function (ranks import it) that returns
    ``(result, report)``: rank 0's ``result`` is returned, and every rank's
    ``report`` (a small dict) comes back merged with the launcher's own
    measures of the rank: ``rank``, ``device``, ``seconds`` (``fn``'s wall
    time), ``launches`` (each kernel's launch count during ``fn``) and
    ``peak_memory`` (bytes, CUDA only).  Returns (result, reports).

    Each rank finds ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` in its environment (``env`` adds to or overrides
    them) and, with ``init_group``, starts in a process group of
    ``backend`` (default ``default_backend(device)``) that meets through a
    ``FileStore`` at ``init_file`` (default: in a new temporary directory),
    with collectives timing out after ``pg_timeout`` seconds.  Without
    ``init_group`` the ranks get ``MASTER_ADDR`` / ``MASTER_PORT`` (a free
    local port) instead, as torchrun gives them, and ``fn`` joins the group
    itself (``multihost.initialize``).  A rank that raises, exits or runs
    past ``timeout`` seconds stops every rank and raises here.  The CUDA
    kernels are built once, here, before the ranks start.
    """
    check_world(world_size, device)
    if torch.device(device).type == "cuda":
        _kernels.LIBRARY.build()
    backend = backend or default_backend(device)
    env = dict(env or {})
    tmp = None
    if not init_group:
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()), **env}
        init_file = None
    elif init_file is None:
        tmp = tempfile.mkdtemp(prefix="gsplat_ranks_")
        init_file = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(rank, world_size, str(device), backend,
                                               init_file, pg_timeout, fn, args, env, out))
             for rank in range(world_size)]
    msgs = None
    try:
        for p in procs:
            p.start()
        msgs = _collect(procs, out, timeout)
    finally:
        for p in procs:
            # Ranks that returned their result are let finish; on a failure
            # every rank is stopped at once.
            if msgs is not None:
                p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return msgs[0]["result"], [m["report"] for m in msgs]
