"""CUDA device choice and capability report.

Counterpart of ``tpu_search/devices/capability.py``.  The port takes its
device explicitly: ``cuda`` by default, ``cpu`` on request (argument or
``CLAUDE_SEARCH_DEVICE=cpu``).  Asking for ``cuda`` on a machine without
one raises; nothing falls back to the CPU on its own.

:func:`platform_devices` lists the devices a sharded index may span
(``StorageConfig.shard_devices`` counts them): every CUDA device, or on
the CPU as many as ``XLA_FLAGS``' ``--xla_force_host_platform_device_count``
asks for, each the one host ``torch.device("cpu")``, so that the CPU sees
the device count the JAX package's CPU mesh has under the same
environment.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "DeviceCapability",
    "assess_device_capability",
    "calculate_optimal_batch_size",
    "platform_devices",
    "resolve_device",
    "restrict_cuda_devices",
]

# CUDA device ordinals this process may use (``initialize_distributed``'s
# ``local_device_ids``); None: all of them.
_LOCAL_CUDA_IDS: Optional[List[int]] = None


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``device`` (or ``$CLAUDE_SEARCH_DEVICE``, default ``cuda``) as a
    ``torch.device``; raises when CUDA is asked for and absent."""
    name = device or os.environ.get("CLAUDE_SEARCH_DEVICE") or "cuda"
    if name == "auto":
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' or set CLAUDE_SEARCH_DEVICE=cpu"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def restrict_cuda_devices(ids: Optional[List[int]]) -> None:
    """Limit :func:`platform_devices` ``("cuda")`` to these ordinals (None:
    every device)."""
    global _LOCAL_CUDA_IDS
    _LOCAL_CUDA_IDS = None if ids is None else [int(i) for i in ids]


def platform_devices(platform: str) -> List[torch.device]:
    """This process's devices of ``platform`` (``"cuda"`` or ``"cpu"``), in
    order.  The CPU counts ``--xla_force_host_platform_device_count`` in
    ``XLA_FLAGS`` (default 1) and repeats the host device that many
    times: the shards of a CPU mesh share the host's memory."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            return []
        ids = _LOCAL_CUDA_IDS
        if ids is None:
            ids = list(range(torch.cuda.device_count()))
        return [torch.device("cuda", i) for i in ids]
    if platform == "cpu":
        found = re.findall(r"--xla_force_host_platform_device_count=(\d+)",
                           os.environ.get("XLA_FLAGS", ""))
        return [torch.device("cpu")] * (int(found[-1]) if found else 1)
    raise ValueError(f"unsupported platform {platform!r}")


@dataclass
class DeviceCapability:
    """What the selected device offers."""

    backend: str = "cpu"  # "cuda" | "cpu"
    device_count: int = 0
    device_names: List[str] = field(default_factory=list)
    sm_count: Optional[int] = None
    memory_total: Optional[int] = None  # bytes
    memory_free: Optional[int] = None  # bytes
    can_use_accelerator: bool = False
    status_message: str = ""


def calculate_optimal_batch_size(available_memory_gb: float) -> int:
    """Encoder batch from free device memory: the activation footprint of
    one seq-384 row (attention scores dominate), multiples of 8, capped at
    512."""
    working_gb = available_memory_gb - 1.0
    if working_gb <= 0:
        return 8
    per_item_gb = (12 * 384 * 384 * 4 + 384 * 768 * 4 * 8) / (1024**3)
    batch = int(working_gb / per_item_gb)
    return max(8, min((batch // 8) * 8 or 8, 512))


def assess_device_capability(device: torch.device) -> DeviceCapability:
    cap = DeviceCapability()
    if device.type != "cuda":
        cap.status_message = "CPU compute (device='cpu')"
        return cap
    index = device.index if device.index is not None else 0
    props = torch.cuda.get_device_properties(index)
    free, total = torch.cuda.mem_get_info(index)
    cap.backend = "cuda"
    cap.can_use_accelerator = True
    cap.device_count = torch.cuda.device_count()
    cap.device_names = [
        torch.cuda.get_device_name(i) for i in range(cap.device_count)
    ]
    cap.sm_count = props.multi_processor_count
    cap.memory_total, cap.memory_free = int(total), int(free)
    cap.status_message = (
        f"CUDA ready: {cap.device_names[index]}, {cap.sm_count} SMs, "
        f"{free / 1024**3:.1f} GB free"
    )
    return cap
