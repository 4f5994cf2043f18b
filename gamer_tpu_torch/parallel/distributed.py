"""Multi-host initialization and cross-host work decomposition: the
counterpart of ``gamer_tpu.parallel.distributed`` on ``torch.distributed``.

Within a host, the sharded launches put dealt tile rows, batch frames or
dealt ray tiles on the local cards (parallel/sharding.py). Across hosts PyTorch has
no mesh that spans processes: the decomposition is ``host_shard``, each
host rendering its contiguous block of the work list on its own cards and
writing its own output files (the dataset-generation case), so no pixel
crosses the network.

On a single process everything is a passthrough: the same program runs
unchanged from one CPU to several hosts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .sharding import Mesh, local_cuda_devices


@dataclass(frozen=True)
class HostTopology:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


def _local_device_count() -> int:
    """The visible cards, or 1 (the CPU) where there is none."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> HostTopology:
    """Join (or skip joining) a multi-process ``torch.distributed`` job;
    returns the topology.

    A process joins only on an unambiguous signal: an explicit
    ``coordinator_address`` ("host:port", with ``num_processes`` and
    ``process_id``), or MASTER_ADDR, RANK and WORLD_SIZE in the environment
    (what ``torchrun`` sets). Otherwise this is a no-op that touches no
    device. ``backend`` defaults to nccl where a card is visible, else
    gloo."""
    import torch.distributed as dist

    explicit = coordinator_address is not None
    cluster_env = all(k in os.environ
                      for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if (explicit or cluster_env) and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if explicit:
            if num_processes is None or process_id is None:
                raise ValueError("an explicit coordinator_address needs "
                                 "num_processes and process_id")
            address = coordinator_address
            if "://" not in address:
                address = "tcp://" + address
            dist.init_process_group(backend, init_method=address,
                                    world_size=int(num_processes),
                                    rank=int(process_id))
        else:
            dist.init_process_group(backend)
    local = _local_device_count()
    if not dist.is_initialized():
        return HostTopology(0, 1, local, local)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    return HostTopology(process_index=dist.get_rank(),
                        process_count=dist.get_world_size(),
                        local_devices=local, global_devices=sum(counts))


def host_shard(items: Sequence, topo: Optional[HostTopology] = None) -> list:
    """The subsequence of ``items`` this host owns: contiguous blocks of
    ``ceil(n / hosts)`` or one fewer. Unlike the reference's RasterThread
    chunking (rasterthread.cpp:11), no trailing remainder is dropped."""
    topo = topo or init_distributed()
    n = len(items)
    k, r = divmod(n, topo.process_count)
    i = topo.process_index
    start = i * k + min(i, r)
    stop = start + k + (1 if i < r else 0)
    return list(items[start:stop])


def global_batch_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D 'batch' mesh over this process's cards (or the given devices),
    for ``engine.batch.render_batch(mesh=...)``. Across hosts each process
    takes its ``host_shard`` of the frames and renders it on this mesh."""
    devices = local_cuda_devices() if devices is None else devices
    return Mesh(tuple(devices), ("batch",))


def pixel_tile_mesh_2d(rows_axis: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> Mesh:
    """A (batch, rows) 2-D mesh over this process's cards (or the given
    devices), the JAX package's form of a batch mesh (frames over 'batch',
    row slabs over 'rows'). The port checks its axis names and deals every
    frame's tile rows by card over its entries, as on a 1-D mesh
    (``cuda_render.march_batch_rowshard``). ``rows_axis`` defaults to the
    device count."""
    devices = tuple(local_cuda_devices() if devices is None else devices)
    rows_axis = rows_axis or len(devices)
    if len(devices) % rows_axis:
        raise ValueError(
            f"{len(devices)} devices not divisible by rows axis {rows_axis}")
    return Mesh(devices, ("batch", "rows"),
                (len(devices) // rows_axis, rows_axis))
