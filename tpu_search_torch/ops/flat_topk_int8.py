"""Masked top-k over an int8 corpus: wrapper of the hand-written CUDA kernel.

Kernel: ``csrc/flat_topk_int8.cu`` (replaces ``pallas_flat_topk_dma_int8``
and ``pallas_flat_topk_dma_int8_packed`` of
``tpu_search/ops/pallas_topk_dma.py``, with the XLA around them).  It reads
``[N, D]`` int8 rows (the index's layout) or the JAX package's
``[N/4, D]`` int32 word layout (``ops/int8_pack.py``).  On the card a
search is one C call of three launches, nothing of PyTorch's between them
(``csrc/flat_digit_scan.cuh``): the prologue writes the query digits,
``rho`` and ``qs1`` (its plain twin :func:`flat_int8_prep_plain`:
``quantize_queries``, as the JAX package computes them in XLA outside
``pl.pallas_call``), the scan (``digit_partial`` of ``csrc/digit_scan.cuh``
over fixed row ranges, :func:`split_rows`, at Q <= 8 and for the words
above; for the rows above Q 8 the ``cp.async`` ring of
``csrc/ivf_digit_scan.cuh`` over every 128-row tile, runs sized from the
card) and the tree merge, which multiplies by ``qs1``.  CPU tensors take
``flat_topk_int8_plain``; a CUDA tensor launches the kernel or raises.
``k > 128`` runs the prologue and the scan's scores-only mode, then a
stable sort.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .int8_pack import unpack_int8_rows
from .ring_scan import flat_digit_call, merge_parts
from .topk_scan import flat_topk_int8_plain, quantize_queries, select_topk

__all__ = ["flat_int8_prep", "flat_int8_prep_plain", "flat_topk_int8_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# vectors, scale, penalty, queries; n, d, q, k, qb, runs, rows_per_split,
# prologue_only, words; the scratch (_parts), out_s, out_i, scores, stream
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_P] * 12
_PREP_NAMES = ("digits", "rho", "qs1")


def flat_int8_prep_plain(queries: torch.Tensor) -> dict:
    """What the prologue kernel writes: ``digits [2Q, D]`` int8, ``rho``
    and ``qs1 [Q]`` f32 (``quantize_queries``)."""
    return dict(zip(_PREP_NAMES, quantize_queries(queries)))


def _parts(q, d, runs, kpad):
    i8, i32, f32 = torch.int8, torch.int32, torch.float32
    return (("digits", i8, (2 * q, d)), ("rho", f32, (q,)), ("qs1", f32, (q,)),
            ("merge_count", i32, (q,)), *merge_parts(q, runs, kpad))


def flat_int8_prep(queries: torch.Tensor) -> dict:
    """The prologue kernel alone on a CUDA tensor (the plain twin on a CPU
    one); outputs as :func:`flat_int8_prep_plain`."""
    if queries.device.type == "cpu":
        return flat_int8_prep_plain(queries)
    work = flat_digit_call("flat_topk_int8", _ARGTYPES, None, queries,
                           max(1, queries.shape[0]), 1, _parts, False,
                           (0,))[0]
    return {name: work.view(name) for name in _PREP_NAMES}


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
    if queries.shape[1] != d or scales.shape != (n,) or penalty.shape != (n,):
        raise ValueError("shape mismatch between corpus, scales, penalty "
                         "and queries")
    if d % 16:
        raise ValueError("the int8 CUDA scan needs D % 16 == 0")
    if scales.dtype != torch.float32 or penalty.dtype != torch.float32:
        raise ValueError("scales and penalty must be float32")
    work, out_s, out_i, scores = flat_digit_call(
        "flat_topk_int8", _ARGTYPES, (vectors, scales, penalty), queries, n,
        k, _parts, not words, (int(words),))
    if scores is None:
        return out_s, out_i
    top, ids = select_topk(scores, k)
    return top * work.view("qs1")[:, None], ids
