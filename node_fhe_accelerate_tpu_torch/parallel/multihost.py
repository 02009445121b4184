"""Multi-process scaling: process-group initialization, host meshes and
cross-process assembly (counterpart of
node_fhe_accelerate_tpu/parallel/multihost.py).

The port's mesh (mesh.py) is single-controller: one process drives the
devices it can address.  Across processes (hosts, or one process a card)
the port goes through ``torch.distributed``, NCCL between cards and gloo on
the CPU:

* ``initialize_distributed`` joins a process group when the launcher's
  environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, as torchrun sets
  them) or explicit arguments ask for one; with one process and neither it
  is a no-op, so the same program runs from one card to a cluster;
* ``make_host_mesh`` builds this process's ("data", "model") mesh over its
  local devices, the "model" axis confined to one host (where the
  bandwidth-hungry intra-op collectives stay), the "data" axis continued
  across processes by the process group;
* ``host_local_batch`` / ``assemble_global`` give each process its slice of
  a global batch and lay it over its mesh positions, recording the global
  shape (no process ever holds the whole election).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, Sharded, shard

__all__ = ["initialize_distributed", "make_host_mesh", "host_local_batch",
           "assemble_global", "process_info"]


def _env_asks() -> bool:
    return all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE",
                                           "RANK"))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> dict:
    """Join (or skip joining) a process group; returns ``process_info()``.

    ``coordinator_address`` ("host:port" or a URL such as
    ``tcp://localhost:29500``) with ``num_processes`` and ``process_id``
    join explicitly; else the launcher's environment variables do.  With
    neither (one process) nothing is joined.  ``backend`` defaults to NCCL
    when the process has a card, gloo otherwise."""
    explicit = coordinator_address is not None
    if (explicit or _env_asks()) and not dist.is_initialized():
        backend = backend or ("nccl" if torch.cuda.is_available()
                              else "gloo")
        if explicit:
            url = coordinator_address if "://" in coordinator_address \
                else f"tcp://{coordinator_address}"
            dist.init_process_group(backend, init_method=url,
                                    world_size=num_processes,
                                    rank=process_id)
        else:
            dist.init_process_group(backend)
    return process_info()


def _rank_world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_info() -> dict:
    """This process's index and count, and its visible CUDA devices (each
    process is taken to see as many)."""
    rank, world = _rank_world()
    local = torch.cuda.device_count()
    return {"process_index": rank, "process_count": world,
            "local_devices": local, "global_devices": local * world}


def make_host_mesh(model: int = 1, devices=None) -> Mesh:
    """This process's ("data", "model") mesh over its local devices (the
    visible CUDA devices, or ``devices``): (local / model, model), the
    model axis inside one host.  Raises when ``model`` exceeds the local
    device count."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = len(devices)
    if model > local:
        raise ValueError(
            f"model axis {model} exceeds local device count {local}: the "
            "model axis must stay inside one host")
    data = local // model
    devs = np.empty(data * model, dtype=object)
    devs[:] = list(devices)[: data * model]
    return Mesh(devs.reshape(data, model), ("data", "model"))


def host_local_batch(global_batch: int) -> tuple[int, int]:
    """(this process's batch slice size, offset) for an even global
    split."""
    rank, world = _rank_world()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world} processes")
    per = global_batch // world
    return per, per * rank


def assemble_global(mesh: Mesh, local_np, batch_axis: int = 0) -> Sharded:
    """This process's slice (numpy) laid over its mesh's "data" positions;
    the global shape records every process's slice along ``batch_axis``.
    With one process this is ``shard``."""
    local = torch.from_numpy(np.ascontiguousarray(local_np))
    out = shard(local, mesh, batch_axis, "data")
    _, world = _rank_world()
    shape = list(out.global_shape)
    shape[out.dim] *= world
    out.global_shape = tuple(shape)
    return out

