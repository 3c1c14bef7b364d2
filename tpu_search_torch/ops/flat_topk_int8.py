"""Masked top-k over an int8 corpus: wrapper of the hand-written CUDA kernel.

Kernel: ``csrc/flat_topk_int8.cu`` (replaces ``pallas_flat_topk_dma_int8``
and ``pallas_flat_topk_dma_int8_packed`` of
``tpu_search/ops/pallas_topk_dma.py``).  It reads ``[N, D]`` int8 rows
(the index's layout) or the JAX package's ``[N/4, D]`` int32 word layout
(``ops/int8_pack.py``).  The query digits, ``rho`` and the final ``* qs1``
are plain PyTorch here, as the JAX package computes them in XLA outside
``pl.pallas_call``.  CPU tensors take ``flat_topk_int8_plain``; a CUDA
tensor launches the kernel or raises.  ``k > 128`` runs the kernel's
scores-only mode and a stable sort.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.shapes import round_up
from . import _build
from .flat_topk import MAX_K, c_entry, check_scan_args, split_rows
from .int8_pack import unpack_int8_rows
from .topk_scan import flat_topk_int8_plain, quantize_queries, select_topk

__all__ = ["flat_topk_int8_scan", "run_digit_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P]


def flat_topk_int8_scan(
    vectors: torch.Tensor,
    scales: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    words: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(fma(rho, d2, d1) * scale + penalty)`` top-k, times ``qs1``, over
    ``vectors`` ``[N, D]`` int8 (or ``[N/4, D]`` int32 with ``words``),
    ``scales`` and ``penalty`` (0 / ``-inf``) ``[N]`` f32.  Returns
    ``(scores [Q, k] f32, ids [Q, k] int32)``; id ``-1`` where no live row
    is left."""
    if vectors.device.type == "cpu":
        rows = unpack_int8_rows(vectors) if words else vectors
        return flat_topk_int8_plain(rows, scales, penalty, queries, k)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")
    want = torch.int32 if words else torch.int8
    if vectors.dtype != want:
        raise TypeError(f"corpus dtype {vectors.dtype}, expected {want}")
    if vectors.dim() != 2 or queries.dim() != 2:
        raise ValueError("vectors and queries must be 2-D")
    n = vectors.shape[0] * (4 if words else 1)
    d = vectors.shape[1]
    q = queries.shape[0]
    if queries.shape[1] != d or scales.shape != (n,) or penalty.shape != (n,):
        raise ValueError("shape mismatch between corpus, scales, penalty "
                         "and queries")
    if d % 16:
        raise ValueError("the int8 CUDA scan needs D % 16 == 0")
    if scales.dtype != torch.float32 or penalty.dtype != torch.float32:
        raise ValueError("scales and penalty must be float32")
    q_i8, rho, qs1 = quantize_queries(queries)
    dev = check_scan_args(n, k, vectors=vectors, scales=scales,
                          penalty=penalty, queries=q_i8, rho=rho)
    head = (vectors.data_ptr(), int(words), scales.data_ptr(),
            penalty.data_ptr(), q_i8.data_ptr(), rho.data_ptr())
    return run_digit_scan("flat_topk_int8", _ARGTYPES, head, n, d, k, qs1,
                          dev)


def run_digit_scan(kernel, argtypes, head, n, d, k, qs1, dev,
                   rows_per_split=None):
    """Launch ``csrc/<kernel>.cu`` (``digit_scan.cuh``'s C signature after
    the ``head`` pointers) and finish its output: select for ``k > 128``
    (scores-only mode), then multiply by ``qs1``.  ``rows_per_split`` (a
    multiple of 128) overrides :func:`split_rows`'s row range per CTA."""
    q = qs1.shape[0]
    if rows_per_split is None:
        n_splits, rows_per_split = split_rows(n, q, 8 if q <= 8 else 32, dev)
    else:
        n_splits = -(-n // rows_per_split)
    part_s = part_i = out_s = out_i = scores = None
    if k > MAX_K:
        scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    else:
        kpad = round_up(k, 32)
        part_s = torch.empty((q, n_splits, kpad), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((q, n_splits, kpad), dtype=torch.int32,
                             device=dev)
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    ptrs = [None if t is None else t.data_ptr()
            for t in (part_s, part_i, out_s, out_i, scores)]
    code = c_entry(kernel, kernel, argtypes)(
        *head, n, d, q, k, n_splits, rows_per_split, *ptrs,
        _build.stream_ptr(dev),
    )
    _build.check(code, kernel)
    _build.LAUNCHES[kernel] += 1
    if scores is not None:
        out_s, out_i = select_topk(scores, k)
    return out_s * qs1[:, None], out_i
