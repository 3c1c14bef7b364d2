"""CUDA device choice and capability report.

The JAX package's platform probes (``GPUCapability``,
``assess_gpu_capability``, ``estimate_device_memory_requirements``,
``get_device_summary``, ``log_device_status``, ``quick_accelerator_check``)
are not carried over: the port takes its device explicitly
(:func:`resolve_device`) and never probes for one.
"""

from .capability import (
    DeviceCapability,
    assess_device_capability,
    calculate_optimal_batch_size,
    platform_devices,
    resolve_device,
)

__all__ = [
    "DeviceCapability",
    "assess_device_capability",
    "calculate_optimal_batch_size",
    "platform_devices",
    "resolve_device",
]
