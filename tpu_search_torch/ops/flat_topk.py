"""Exact masked top-k scan: wrapper of the hand-written CUDA kernel.

Kernel: ``csrc/flat_topk.cu`` (replaces ``pallas_flat_topk_dma`` of
``tpu_search/ops/pallas_topk_dma.py``).  CPU tensors take the plain
version in ``ops/topk_scan.py``; a CUDA tensor launches the kernel or
raises.  ``k <= MAX_K`` selects inside the kernel; a larger k runs the
kernel's scores-only mode (the same products, alpha and penalty, written
as ``[Q, N]`` f32) and a stable descending sort, as the JAX package sends
k > 128 to its XLA scan.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.shapes import cdiv, round_up
from . import _build
from .topk_scan import flat_topk_plain, select_topk

__all__ = ["MAX_K", "check_scan_args", "flat_topk_scan", "split_rows"]

MAX_K = 128
_TILE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "flat_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                  _P, _P, _P, _P, _P],
    "flat_scores": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P],
}


def c_entry(kernel: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``csrc/<kernel>.cu``, typed."""
    fn = getattr(_build.library(kernel), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def split_rows(n: int, q: int, q_block: int, device) -> Tuple[int, int]:
    """``(n_splits, rows_per_split)``: about four CTAs a streaming
    multiprocessor over all query blocks, ranges a multiple of the tile."""
    target = max(1, (4 * _build.multiprocessors(device)) // cdiv(q, q_block))
    rows_per_split = round_up(max(1, cdiv(n, target)), _TILE)
    return cdiv(n, rows_per_split), rows_per_split


def check_scan_args(n: int, k: int, **tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor lies on one CUDA device, contiguous and
    16-byte aligned, and ``1 <= k <= n``."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, corpus on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside 1..{n} (corpus rows)")
    return dev


def flat_topk_scan(
    vectors: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``score = alpha * q.v - penalty`` top-k over ``vectors [N, D]``
    (bf16 or f32), any ``1 <= k <= N``.  Returns ``(scores [Q, k] f32,
    ids [Q, k] int32)`` with ties on the lower row id and ``-inf`` / ``-1``
    past the live rows."""
    if vectors.device.type == "cpu":
        return flat_topk_plain(vectors, penalty, queries, k, alpha)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")
    if vectors.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"corpus dtype {vectors.dtype} not supported")
    if vectors.dim() != 2 or queries.dim() != 2:
        raise ValueError("vectors and queries must be 2-D")
    n, d = vectors.shape
    q = queries.shape[0]
    if queries.shape[1] != d or penalty.shape != (n,):
        raise ValueError("shape mismatch between corpus, queries and penalty")
    if d % 8:
        raise ValueError("the CUDA scan needs D % 8 == 0")
    if penalty.dtype != torch.float32:
        raise ValueError("penalty must be float32")
    queries = queries.to(vectors.dtype).contiguous()
    dev = check_scan_args(n, k, vectors=vectors, penalty=penalty,
                          queries=queries)
    n_splits, rows_per_split = split_rows(n, q, 16 if q <= 16 else 32, dev)
    head = (vectors.data_ptr(), penalty.data_ptr(), queries.data_ptr(),
            n, d, q)
    tail = (int(vectors.dtype == torch.bfloat16), float(alpha), n_splits,
            rows_per_split)
    stream = _build.stream_ptr(dev)
    if k > MAX_K:
        scores = torch.empty((q, n), dtype=torch.float32, device=dev)
        code = c_entry("flat_topk", "flat_scores", _ARGTYPES["flat_scores"])(
            *head, *tail, scores.data_ptr(), stream)
        _build.check(code, "flat_topk")
        _build.LAUNCHES["flat_topk"] += 1
        return select_topk(scores, k)
    kpad = round_up(k, 32)
    part_s = torch.empty((q, n_splits, kpad), dtype=torch.float32, device=dev)
    part_i = torch.empty((q, n_splits, kpad), dtype=torch.int32, device=dev)
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    code = c_entry("flat_topk", "flat_topk", _ARGTYPES["flat_topk"])(
        *head, k, *tail, part_s.data_ptr(), part_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), stream)
    _build.check(code, "flat_topk")
    _build.LAUNCHES["flat_topk"] += 1
    return out_s, out_i
