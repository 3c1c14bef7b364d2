"""Masked top-k over an int4 corpus: wrapper of the hand-written CUDA kernel.

Kernel: ``csrc/flat_topk_int4.cu`` (replaces ``pallas_flat_topk_dma_int4``
of ``tpu_search/ops/pallas_topk_dma.py``).  The corpus is nibble-pair
byte rows ``[ceil(N/2), D]`` uint8 (``ops/int4_pack.py``), rows numbered in
logical order.  The query digits, ``rho``, the nibble bias offsets and the
final ``* qs1`` are plain PyTorch here, as the JAX package computes them in
XLA outside ``pl.pallas_call``.  CPU tensors take
``flat_topk_int4_plain``; a CUDA tensor launches the kernel or raises.
``k > 128`` runs the kernel's scores-only mode and a stable sort.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .flat_topk import check_scan_args
from .flat_topk_int8 import run_digit_scan
from .topk_scan import (
    flat_topk_int4_plain,
    quantize_queries,
    query_nibble_offsets,
)

__all__ = ["flat_topk_int4_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P]


def flat_topk_int4_scan(
    nibbles: torch.Tensor,
    scales: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ``N = len(penalty)`` int4 rows (``nibbles``
    ``[ceil(N/2), D]`` uint8), ``scales`` and ``penalty`` (0 / ``-inf``)
    ``[N]`` f32.  Same outputs as ``flat_topk_int8_scan``."""
    if nibbles.device.type == "cpu":
        return flat_topk_int4_plain(nibbles, scales, penalty, queries, k)
    if nibbles.device.type != "cuda":
        raise ValueError(f"unsupported device {nibbles.device}")
    if nibbles.dtype != torch.uint8:
        raise TypeError(f"corpus dtype {nibbles.dtype}, expected uint8")
    if nibbles.dim() != 2 or queries.dim() != 2:
        raise ValueError("nibbles and queries must be 2-D")
    n = penalty.shape[0]
    d = nibbles.shape[1]
    if (nibbles.shape[0] != (n + 1) // 2 or queries.shape[1] != d
            or scales.shape != (n,) or penalty.dim() != 1):
        raise ValueError("shape mismatch between nibbles, scales, penalty "
                         "and queries")
    if d % 16:
        raise ValueError("the int4 CUDA scan needs D % 16 == 0")
    if scales.dtype != torch.float32 or penalty.dtype != torch.float32:
        raise ValueError("scales and penalty must be float32")
    q_i8, rho, qs1 = quantize_queries(queries)
    qoff = query_nibble_offsets(q_i8)
    dev = check_scan_args(n, k, nibbles=nibbles, scales=scales,
                          penalty=penalty, queries=q_i8, rho=rho, qoff=qoff)
    head = (nibbles.data_ptr(), scales.data_ptr(), penalty.data_ptr(),
            q_i8.data_ptr(), rho.data_ptr(), qoff.data_ptr())
    return run_digit_scan("flat_topk_int4", _ARGTYPES, head, n, d, k, qs1,
                          dev)
