"""Int4 rows: symmetric 4-bit quantization and the nibble-pair byte layout.

Counterpart of ``tpu_search/ops/int4_pack.py``.

- Rows quantize to signed codes ``q in [-7, 7]`` with a per-row scale
  ``max|v| * f32(1/7)`` (a multiply by the rounded reciprocal, as XLA
  computes ``max|v| / 7`` under jit) and are stored biased, ``u = q + 8 in
  [1, 15]``, so unpacking needs no sign handling: the bias comes off
  exactly in int32 after the product (``topk_scan.query_nibble_offsets``).
- Byte row ``m`` holds logical rows ``2m`` (low nibble) and ``2m + 1``
  (high nibble).  This is the TPUSIDX2 disk layout and the port's device
  layout: ``[N/2, D]`` uint8, half a byte per component.
- ``bytes_to_words_host`` / ``words_to_bytes_host`` convert to and from
  the JAX package's ``[N/8, D]`` int32 word layout (byte ``b`` of word
  ``(s, c)`` is byte row ``4s + b``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .topk_scan import absmax_scales

__all__ = [
    "NIBBLE_BIAS",
    "bytes_to_nibble_rows",
    "bytes_to_words_host",
    "nibble_rows_to_bytes",
    "nibble_rows_to_disk_bytes",
    "quantize_rows_int4",
    "quantize_rows_int4_host",
    "words_to_bytes_host",
]

# Stored nibble = signed code + NIBBLE_BIAS.
NIBBLE_BIAS = 8
_INV7 = np.float32(1.0 / 7.0)


def quantize_rows_int4_host(
    vectors: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] float -> (biased nibbles [N, D] uint8 in [1, 15], scales [N] f32)."""
    scales = np.abs(vectors).max(axis=1).astype(np.float32) * _INV7
    scales = np.maximum(scales, np.float32(1e-12))
    q = np.rint(vectors / scales[:, None]).astype(np.int32)
    u = (np.clip(q, -7, 7) + NIBBLE_BIAS).astype(np.uint8)
    return u, scales.astype(np.float32)


def quantize_rows_int4(vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor twin of :func:`quantize_rows_int4_host` (uint8 nibbles), bit
    for bit on any device: the scale is one f32 multiply
    (``topk_scan.absmax_scales``) and the quotient a tensor-by-tensor
    division."""
    v = vectors.float()
    scales = absmax_scales(v, _INV7)
    q = torch.round(v / scales[:, None])
    u = (torch.clamp(q, -7.0, 7.0) + NIBBLE_BIAS).to(torch.uint8)
    return u, scales


def nibble_rows_to_disk_bytes(u: np.ndarray) -> np.ndarray:
    """[N, D] nibble rows (values 0..15) -> [ceil(N/2), D] nibble-pair byte
    rows; an odd N pads one zero nibble."""
    u = np.asarray(u).astype(np.uint8, copy=False)
    if u.shape[0] % 2:
        u = np.concatenate([u, np.zeros((1, u.shape[1]), np.uint8)])
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def nibble_rows_to_bytes(u: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`nibble_rows_to_disk_bytes`."""
    u = u.to(torch.uint8)
    if u.shape[0] % 2:
        u = torch.cat([u, torch.zeros_like(u[:1])])
    return u[0::2] | (u[1::2] << 4)


def bytes_to_nibble_rows(b: torch.Tensor) -> torch.Tensor:
    """[M, D] nibble-pair bytes -> [2M, D] nibble rows (uint8)."""
    m, d = b.shape
    return torch.stack([b & 0x0F, b >> 4], dim=1).reshape(2 * m, d)


def bytes_to_words_host(b: np.ndarray) -> np.ndarray:
    """[M, D] byte rows (M % 4 == 0) -> [M/4, D] int32 words."""
    m, d = b.shape
    grouped = np.ascontiguousarray(
        b.reshape(m // 4, 4, d).transpose(0, 2, 1)
    )
    return grouped.view(np.int32)[..., 0]


def words_to_bytes_host(words: np.ndarray) -> np.ndarray:
    """[C, D] int32 words -> [4C, D] byte rows."""
    c, d = words.shape
    rows = np.ascontiguousarray(words)[..., None].view(np.uint8)  # [C, D, 4]
    return np.ascontiguousarray(rows.transpose(0, 2, 1)).reshape(4 * c, d)
