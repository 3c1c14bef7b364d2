"""CUDA device choice and capability report."""

from .capability import (
    DeviceCapability,
    GPUCapability,
    assess_device_capability,
    assess_gpu_capability,
    calculate_optimal_batch_size,
    estimate_device_memory_requirements,
    get_device_summary,
    log_device_status,
    platform_devices,
    quick_accelerator_check,
    resolve_device,
)

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
]
