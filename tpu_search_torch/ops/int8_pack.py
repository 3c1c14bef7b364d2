"""Int8 row packing: 4 consecutive corpus rows per int32 word row.

Counterpart of ``tpu_search/ops/int8_pack.py``.  Byte ``b``
(little-endian) of word ``(s, c)`` is row ``4s+b``, column ``c``.  The TPU
stored its int8 corpus this way because its DMA engine streams int32 tiles
faster than int8 ones.  The port's ``FlatIndex`` holds int8 the same way,
and the word entry of the int8 scan (``ops/flat_topk_int8.py``) reads it
as it is.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_int8_rows",
    "unpack_int8_rows",
    "pack_int8_rows_host",
    "unpack_int8_rows_host",
]


def pack_int8_rows(vectors: torch.Tensor) -> torch.Tensor:
    """[N, D] int8 -> [N/4, D] int32 (N must be a multiple of 4)."""
    n, d = vectors.shape
    grouped = vectors.reshape(n // 4, 4, d).transpose(1, 2).contiguous()
    return grouped.view(torch.int32)[..., 0]


def unpack_int8_rows(packed: torch.Tensor) -> torch.Tensor:
    """[C, D] int32 -> [4C, D] int8 (inverse of :func:`pack_int8_rows`)."""
    c, d = packed.shape
    rows = packed.contiguous()[..., None].view(torch.int8)  # [C, D, 4]
    return rows.transpose(1, 2).reshape(4 * c, d)


def pack_int8_rows_host(vectors: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_int8_rows`."""
    n, d = vectors.shape
    grouped = np.ascontiguousarray(
        vectors.reshape(n // 4, 4, d).transpose(0, 2, 1)
    )
    return grouped.view(np.int32)[..., 0]


def unpack_int8_rows_host(packed: np.ndarray) -> np.ndarray:
    """Host twin of :func:`unpack_int8_rows`."""
    c, d = packed.shape
    rows = np.ascontiguousarray(packed)[..., None].view(np.int8)  # [C, D, 4]
    return np.ascontiguousarray(rows.transpose(0, 2, 1)).reshape(4 * c, d)
