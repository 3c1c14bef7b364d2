"""Several processes: ``torch.distributed`` wiring for a sharded index.

Counterpart of ``tpu_search/parallel/distributed.py``.  A multi-process
deployment is, on every process::

    from tpu_search_torch.parallel import build_mesh, initialize_distributed
    initialize_distributed()                 # torch.distributed
    mesh = build_mesh(n_data=process_count() * local_devices,
                      dcn_data=process_count())

Each process then holds the index shards of its own row of the mesh on
its own devices; queries are replicated, each process scans its shards,
and the per-shard top-k lists meet in one ``all_gather`` before the one
merge (``ShardedFlatIndex.search``).  Persistence is per process
(``ShardedFlatIndex.save``): each writes and reads only its own shards.

The process group runs NCCL when this process's devices are CUDA and gloo
on the CPU, joined at ``tcp://<coordinator>``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..devices.capability import resolve_device, restrict_cuda_devices

logger = logging.getLogger(__name__)

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "process_index",
    "process_count",
]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the job's process group (``torch.distributed``).

    The arguments default to ``TPU_SEARCH_COORDINATOR`` (``host:port``),
    ``TPU_SEARCH_NUM_PROCESSES`` and ``TPU_SEARCH_PROCESS_ID``.  The
    backend is NCCL when the device (``CLAUDE_SEARCH_DEVICE``, default
    ``cuda``) is CUDA, gloo on the CPU; ``local_device_ids`` limits this
    process to those CUDA ordinals, the first its NCCL device.
    Idempotent: a second call logs and returns."""
    if dist.is_initialized():
        logger.info("torch.distributed already initialized: process %d/%d",
                    dist.get_rank(), dist.get_world_size())
        return
    coordinator_address = coordinator_address or os.environ.get(
        "TPU_SEARCH_COORDINATOR")
    if num_processes is None and os.environ.get("TPU_SEARCH_NUM_PROCESSES"):
        num_processes = int(os.environ["TPU_SEARCH_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TPU_SEARCH_PROCESS_ID"):
        process_id = int(os.environ["TPU_SEARCH_PROCESS_ID"])
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the "
            "number of processes and this process's id (arguments or "
            "TPU_SEARCH_COORDINATOR / TPU_SEARCH_NUM_PROCESSES / "
            "TPU_SEARCH_PROCESS_ID)")
    backend = "gloo"
    if resolve_device().type == "cuda":
        backend = "nccl"
        if local_device_ids is not None:
            restrict_cuda_devices(list(local_device_ids))
            torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    logger.info("torch.distributed initialized (%s): process %d/%d",
                backend, dist.get_rank(), dist.get_world_size())


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
