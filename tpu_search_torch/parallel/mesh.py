"""Device meshes for the sharded index.

Counterpart of ``tpu_search/parallel/mesh.py``'s :func:`build_mesh`: a
``(data, model)`` grid of devices.  The index shards its corpus over the
``data`` axis; ``model`` (tensor parallelism) is kept for the grid's shape
and its checks.  Where JAX names a device of any process, each entry here
is a ``torch.device`` with the process that owns it: a process addresses
only its own entries.

- One process: the grid is the first ``n_data * n_model`` of ``devices``
  (default: :func:`~tpu_search_torch.devices.platform_devices` of the
  device ``resolve_device`` picks).  A list may repeat a device, so that
  several shards share one card, or the host on the CPU.
- ``dcn_data > 1``: the data axis is (processes) x (devices per process),
  process-major, as ``create_hybrid_device_mesh`` lays out a granule per
  process.  ``devices`` are this process's own; every process is taken to
  hold the same list, and ``dcn_data`` must be the process count.

``data_sharding``, ``replicated`` and ``encoder_param_specs`` (the
encoder's and the trainer's sharding rules) are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices.capability import platform_devices, resolve_device
from .distributed import process_count, process_index

__all__ = ["Mesh", "build_mesh"]


class Mesh:
    """A ``(data, model)`` grid of devices, each owned by one process.

    ``devices`` is the ``[n_data, n_model]`` object array of
    ``torch.device``, ``ranks`` the owning process of each entry and
    ``processes`` how many processes the grid spans.  Hashable: a fused
    program's key carries it."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray, ranks: np.ndarray,
                 processes: int = 1) -> None:
        self.devices = devices
        self.ranks = ranks
        self.processes = processes
        self._key = (tuple(str(d) for d in devices.flat),
                     tuple(int(r) for r in ranks.flat), devices.shape,
                     processes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def shard_device(self, shard: int) -> torch.device:
        """The device of data shard ``shard`` (model column 0)."""
        return self.devices[shard, 0]

    def local_shards(self) -> Tuple[int, ...]:
        """The data shards this process owns, in order."""
        me = process_index()
        return tuple(s for s in range(self.devices.shape[0])
                     if int(self.ranks[s, 0]) == me)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices[:, 0]]}, "
                f"processes={self.processes})")


def _grid(devices, rows: int, cols: int) -> np.ndarray:
    grid = np.empty((rows, cols), dtype=object)
    for i, device in enumerate(devices[: rows * cols]):
        grid[i // cols, i % cols] = torch.device(device)
    return grid


def build_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
    dcn_data: int = 1,
) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (see the module's notes);
    the JAX function's checks and messages."""
    if devices is None:
        devices = platform_devices(resolve_device().type)
    devices = [torch.device(d) for d in devices]
    if dcn_data > 1:
        if n_data is None:
            n_data = len(devices) * dcn_data // n_model
        if n_data % dcn_data:
            raise ValueError(
                f"n_data={n_data} must divide by dcn_data={dcn_data}")
        if process_count() != dcn_data:
            raise ValueError(
                f"dcn_data={dcn_data} needs as many processes, have "
                f"{process_count()} (initialize_distributed first)")
        per = n_data // dcn_data
        if per * n_model > len(devices):
            raise ValueError(
                f"Mesh {per}x{n_model} per process needs {per * n_model} "
                f"devices, have {len(devices)}")
        local = _grid(devices, per, n_model)
        grid = np.concatenate([local] * dcn_data)
        ranks = np.repeat(np.arange(dcn_data), per * n_model).reshape(
            n_data, n_model)
        return Mesh(grid, ranks, processes=dcn_data)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"Mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}")
    grid = _grid(devices, n_data, n_model)
    return Mesh(grid, np.full((n_data, n_model), process_index()))
