"""The port's device exports (``tpu_search_torch.devices``) against the
JAX package's ``tpu_search.devices.capability`` on the CPU:
``estimate_device_memory_requirements`` and
``calculate_optimal_batch_size`` equal over a grid of inputs (the port's
``"cuda"`` backend is the JAX ``"tpu"`` arithmetic, and gives the numbers
the port's encoder sized its batch by before the export took a backend),
the report where there is no card equal field by field where the two
describe the same thing, ``quick_accelerator_check`` false,
``log_device_status`` logging the report, and the reference aliases.
"""

import logging

import pytest
import torch

from tpu_search.devices import capability as jax_cap
from tpu_search_torch import devices
from tpu_search_torch.devices import capability as cap

GIGABYTES = (0.0, 0.5, 1.0, 1.01, 1.5, 2.0, 3.3, 8.0, 16.0, 40.0, 79.6,
             80.0, 1000.0)
DIMS = (384, 768, 1024)


@pytest.mark.parametrize("chunks", [0, 1, 10_000, 1_000_000, 123_457])
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
def test_memory_estimate_equals_jax(chunks, dim, dtype_bytes):
    args = (chunks, dim, dtype_bytes)
    assert cap.estimate_device_memory_requirements(*args) == (
        jax_cap.estimate_device_memory_requirements(*args))


@pytest.mark.parametrize("dim", DIMS)
def test_batch_size_equals_jax(dim):
    for gb in GIGABYTES:
        assert cap.calculate_optimal_batch_size(gb, dim, "cpu") == (
            jax_cap.calculate_optimal_batch_size(gb, dim, "cpu"))
        assert cap.calculate_optimal_batch_size(gb, dim, "cuda") == (
            jax_cap.calculate_optimal_batch_size(gb, dim, "tpu"))
        assert cap.calculate_optimal_batch_size(gb, dim) == (
            cap.calculate_optimal_batch_size(gb, dim, backend="cuda"))


def _encoder_batch_before(available_memory_gb):
    """The one-argument formula the encoder sized its batch by before the
    backend argument: multiples of 8 in [8, 512]."""
    working_gb = available_memory_gb - 1.0
    if working_gb <= 0:
        return 8
    per_item_gb = (12 * 384 * 384 * 4 + 384 * 768 * 4 * 8) / (1024**3)
    batch = int(working_gb / per_item_gb)
    return max(8, min((batch // 8) * 8 or 8, 512))


def test_cuda_batch_size_unchanged():
    for gb in GIGABYTES:
        assert cap.calculate_optimal_batch_size(gb, backend="cuda") == (
            _encoder_batch_before(gb))
    assert cap.calculate_optimal_batch_size(0.5, backend="cpu") == 8
    assert cap.calculate_optimal_batch_size(80.0, backend="cpu") == 64


FIELDS = ("backend", "accelerator_available", "device_count",
          "memory_total", "memory_free", "recommended_batch_size",
          "can_use_accelerator", "can_use_gpu", "gpu_count",
          "gpu_memory_total", "gpu_memory_free")


@pytest.mark.parametrize("target", [10_000, 1_000_000])
def test_cpu_report_equals_jax(target):
    """Without a card both packages report the CPU with its host device
    count (``XLA_FLAGS``' device count, 8 under ``tests/conftest.py``):
    every field that means the same in both is equal."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the port reports it")
    got = cap.assess_device_capability(target, 768)
    want = jax_cap.assess_device_capability(target, 768)
    assert {f: getattr(got, f) for f in FIELDS} == {
        f: getattr(want, f) for f in FIELDS}
    assert got.backend == "cpu" and not got.can_use_accelerator
    assert len(got.device_names) == got.device_count
    assert got.gpu_names == got.device_names
    assert got.sm_count is None
    assert "No CUDA device" in got.status_message
    assert devices.get_device_summary() == got.status_message
    assert devices.quick_accelerator_check() is False
    assert devices.assess_gpu_capability is devices.assess_device_capability
    assert devices.GPUCapability is devices.DeviceCapability


def test_explicit_cpu_device_is_reported():
    """A report for ``device='cpu'`` is the CPU's, card or not."""
    got = cap.assess_device_capability(device=torch.device("cpu"))
    assert got.backend == "cpu" and not got.accelerator_available
    assert got.status_message.startswith("CPU compute")


def test_log_device_status_logs(caplog):
    report = cap.DeviceCapability(
        backend="cuda", accelerator_available=True, device_count=2,
        device_names=["card a", "card b"], recommended_batch_size=128,
        can_use_accelerator=True, status_message="ready")
    with caplog.at_level(logging.INFO):
        devices.log_device_status(report)
        cap.log_gpu_status(report, logging.getLogger("other"))
    assert caplog.text.count("Device status: ready") == 2
    assert "device 1: card b" in caplog.text
    assert "Recommended batch size: 128" in caplog.text
    jax_cap.log_device_status(report)  # the same report reads in both
