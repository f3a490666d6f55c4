"""Process-group initialization for the multi-process back ends.

Counterpart of ``radar_slam_tpu/parallel/distributed.py``.  A single
process needs nothing from this module.  With more than one process (one
rank per device), call :func:`initialize` once per process before any
collective; :func:`radar_slam_tpu_torch.parallel.mesh.make_mesh` then
spans every rank, and the SPMD code of ``parallel/`` (the frame-parallel
driver ``dp.py``, the factor-sharded GN-CG and the ranked Schur step of
``ba.py``, the sequence-sharded batches of ``multiseq.py``) runs on it.

The backend is the caller's to name.  By default:

- NCCL where every rank has a card of its own;
- gloo for CPU tensors, or where ranks share one card (NCCL refuses two
  ranks on one device; gloo stages CUDA tensors through the host).

``torchrun`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK``, which :func:`initialize` reads where its
arguments are not given.  Nothing here tells a program of a cluster: a
bare ``python`` launch passes ``init_method`` (``tcp://host:port``) or
``coordinator_address`` (``host:port``), ``world_size`` and ``rank``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from radar_slam_tpu_torch.core.device import DEFAULT, resolve


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def default_backend(device, local_world_size: int) -> str:
    """NCCL where ``device`` is a card and the host has one card per local
    rank; gloo otherwise."""
    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(backend: str, local_rank: int, device=DEFAULT
                ) -> torch.device:
    """The device a rank drives: its own card under NCCL, ``device`` under
    gloo (the CPU, or the card the ranks share)."""
    dev = resolve(device)
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    return dev


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device=DEFAULT,
               coordinator_address: Optional[str] = None) -> dict:
    """Initialize ``torch.distributed`` from the arguments or torchrun's
    variables; a no-op where neither names a world size (one process).

    Returns the topology: the reference's keys (``process_index``,
    ``process_count``, ``local_devices``, ``global_devices``: one device a
    rank) and the ``backend`` and ``device`` of this rank."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if init_method is None and coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank or 0
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size or 1

    if world_size and not dist.is_initialized():
        backend = backend or default_backend(device, local_world)
        if backend == "nccl":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank or 0)
    if dist.is_initialized():
        backend = dist.get_backend()
        return {"process_index": dist.get_rank(),
                "process_count": dist.get_world_size(),
                "local_devices": 1,
                "global_devices": dist.get_world_size(),
                "backend": backend,
                "device": str(rank_device(backend, local_rank, device))}
    return {"process_index": 0, "process_count": 1, "local_devices": 1,
            "global_devices": 1, "backend": None,
            "device": str(torch.device(device))}


def is_multihost() -> bool:
    """More than one process in the world group."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)
