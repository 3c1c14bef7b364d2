"""CUDA device choice and capability report.

Counterpart of ``tpu_search/devices/capability.py``.  The port takes its
device explicitly: ``cuda`` by default, ``cpu`` on request (argument or
``CLAUDE_SEARCH_DEVICE=cpu``).  Asking for ``cuda`` on a machine without
one raises; nothing falls back to the CPU on its own.

The JAX package's probes report on ``torch.cuda``
(:func:`assess_device_capability`, :func:`quick_accelerator_check`,
:func:`get_device_summary`, :func:`log_device_status`, with their reference
aliases): a report where there is no card says so and changes no choice
of device.

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
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "DeviceCapability",
    "GPUCapability",
    "assess_device_capability",
    "assess_gpu_capability",
    "calculate_optimal_batch_size",
    "estimate_device_memory_requirements",
    "get_device_summary",
    "log_device_status",
    "platform_devices",
    "quick_accelerator_check",
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
    """What the reported device offers: the JAX package's fields and
    reference aliases, plus the card's multiprocessor count."""

    backend: str = "cpu"  # "cuda" | "cpu"
    accelerator_available: bool = False
    device_count: int = 0
    device_names: List[str] = field(default_factory=list)
    memory_total: Optional[int] = None  # bytes, of the reported device
    memory_free: Optional[int] = None  # bytes, of the reported device
    recommended_batch_size: int = 16
    can_use_accelerator: bool = False
    status_message: str = ""
    sm_count: Optional[int] = None

    # Reference-API aliases (reference: src/gpu_utils.py:17-29).
    @property
    def can_use_gpu(self) -> bool:
        return self.can_use_accelerator

    @property
    def gpu_count(self) -> int:
        return self.device_count

    @property
    def gpu_names(self) -> List[str]:
        return self.device_names

    @property
    def gpu_memory_total(self) -> Optional[int]:
        return self.memory_total

    @property
    def gpu_memory_free(self) -> Optional[int]:
        return self.memory_free


GPUCapability = DeviceCapability


def estimate_device_memory_requirements(
    num_chunks: int, embedding_dim: int = 768, storage_dtype_bytes: int = 2
) -> Dict[str, float]:
    """Device memory a corpus of ``num_chunks`` vectors and the encoder
    need (the JAX package's arithmetic): bf16 rows, ~0.3 GB of encoder
    weights, 10 % working room, and 20 % over that recommended."""
    index_gb = (num_chunks * embedding_dim * storage_dtype_bytes) / (1024**3)
    model_gb = 0.3
    working_gb = (index_gb + model_gb) * 0.1
    total = index_gb + model_gb + working_gb
    return {
        "index_memory_gb": index_gb,
        "model_memory_gb": model_gb,
        "working_memory_gb": working_gb,
        "total_memory_gb": total,
        "recommended_memory_gb": total * 1.2,
    }


def calculate_optimal_batch_size(
    available_memory_gb: float, embedding_dim: int = 768,
    backend: str = "cuda",
) -> int:
    """Encoder batch from free device memory: the activation footprint of
    one seq-384 row (attention scores dominate); on a card multiples of 8
    capped at 512, on the CPU at most 64."""
    working_gb = available_memory_gb - 1.0
    if working_gb <= 0:
        return 8
    per_item_gb = (12 * 384 * 384 * 4 + 384 * 768 * 4 * 8) / (1024**3)
    batch = int(working_gb / per_item_gb)
    if backend == "cpu":
        return max(8, min(batch, 64))
    return max(8, min((batch // 8) * 8 or 8, 512))


def assess_device_capability(
    target_chunks: int = 10000, embedding_dim: int = 768,
    device: Optional[torch.device] = None,
) -> DeviceCapability:
    """Report ``device`` (default: CUDA device 0 where there is one): its
    name, multiprocessors and free memory, the encoder batch that memory
    holds, and whether it holds ``target_chunks`` rows of
    ``embedding_dim`` (the JAX package's check).  Without a card, or for
    ``device='cpu'``, it reports the CPU; nothing chooses a device by it."""
    cap = DeviceCapability()
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", 0)
    if device is None or torch.device(device).type != "cuda":
        cap.device_count = len(platform_devices("cpu"))
        cap.device_names = [f"cpu:{i}" for i in range(cap.device_count)]
        cap.status_message = (
            f"CPU compute (device='cpu', {cap.device_count} host devices)"
            if device is not None else
            "❌ No CUDA device: torch.cuda.is_available() is false "
            f"({cap.device_count} host devices)")
        return cap
    device = torch.device(device)
    index = device.index if device.index is not None else 0
    free, total = torch.cuda.mem_get_info(index)
    cap.backend = "cuda"
    cap.accelerator_available = True
    cap.device_count = torch.cuda.device_count()
    cap.device_names = [
        torch.cuda.get_device_name(i) for i in range(cap.device_count)
    ]
    props = torch.cuda.get_device_properties(index)
    cap.sm_count = props.multi_processor_count
    cap.memory_total, cap.memory_free = int(total), int(free)
    free_gb = free / 1024**3
    cap.recommended_batch_size = calculate_optimal_batch_size(
        free_gb, embedding_dim, backend="cuda")
    need = estimate_device_memory_requirements(target_chunks, embedding_dim)
    if free_gb < need["recommended_memory_gb"]:
        cap.status_message = (
            f"⚠️ Insufficient CUDA memory on cuda:{index} (free: "
            f"{free_gb:.1f}GB, required: "
            f"{need['recommended_memory_gb']:.1f}GB)")
        return cap
    cap.can_use_accelerator = True
    cap.status_message = (
        f"✅ CUDA ready: {cap.device_names[index]}, {cap.sm_count} SMs, "
        f"{free_gb:.1f} GB free ({cap.device_count} device(s))")
    return cap


# Reference-compatible alias (src/gpu_utils.py:195).
assess_gpu_capability = assess_device_capability


def log_device_status(
    cap: DeviceCapability, log: Optional[logging.Logger] = None
) -> None:
    log = log or logger
    log.info("Device status: %s", cap.status_message)
    for i, name in enumerate(cap.device_names):
        log.info("  device %d: %s", i, name)
    if cap.can_use_accelerator:
        log.info("Recommended batch size: %d", cap.recommended_batch_size)


log_gpu_status = log_device_status


def quick_accelerator_check() -> bool:
    return assess_device_capability().can_use_accelerator


def get_device_summary() -> str:
    return assess_device_capability().status_message
