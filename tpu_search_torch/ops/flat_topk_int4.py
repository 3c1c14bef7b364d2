"""Masked top-k over an int4 corpus: wrapper of the hand-written CUDA kernel.

Kernel: ``csrc/flat_topk_int4.cu`` (replaces ``pallas_flat_topk_dma_int4``
of ``tpu_search/ops/pallas_topk_dma.py``, with the XLA around it).  The
corpus is nibble-pair byte rows ``[ceil(N/2), D]`` uint8
(``ops/int4_pack.py``), rows numbered in logical order.  On the card a
search is one C call of three launches, nothing of PyTorch's between
them: the prologue writes the query digits, ``rho``, ``qs1`` and the
nibble offsets (its plain twin :func:`flat_digit_prep_plain`:
``quantize_queries`` and ``query_nibble_offsets``, as the JAX package
computes them in XLA outside ``pl.pallas_call``), the scan (at Q > 8 the
``cp.async`` ring of ``csrc/ivf_digit_scan.cuh`` over every 128-row tile,
runs sized from the card; at Q <= 8 ``digit_partial`` of
``csrc/digit_scan.cuh`` over fixed row ranges, :func:`split_rows`) and the
tree merge, which multiplies by ``qs1`` (``csrc/flat_digit_scan.cuh``).
CPU tensors take ``flat_topk_int4_plain``; a CUDA tensor launches the
kernel or raises.  ``k > 128`` runs the prologue and the scan's
scores-only mode, then a stable sort.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .ring_scan import flat_digit_call, merge_parts
from .topk_scan import (
    flat_topk_int4_plain,
    quantize_queries,
    query_nibble_offsets,
    select_topk,
)

__all__ = ["flat_digit_prep", "flat_digit_prep_plain", "flat_topk_int4_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# nibbles, scale, penalty, queries; n, d, q, k, qb, runs, rows_per_split,
# prologue_only; the scratch (_parts), out_s, out_i, scores, stream
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P] * 13
_PREP_NAMES = ("digits", "rho", "qs1", "qoff")


def flat_digit_prep_plain(queries: torch.Tensor) -> dict:
    """What the prologue kernel writes: ``digits [2Q, D]`` int8, ``rho``
    and ``qs1 [Q]`` f32 (``quantize_queries``), ``qoff [2Q]`` int32
    (``query_nibble_offsets``)."""
    q_i8, rho, qs1 = quantize_queries(queries)
    return {"digits": q_i8, "rho": rho, "qs1": qs1,
            "qoff": query_nibble_offsets(q_i8)}


def _parts(q, d, runs, kpad):
    i8, i32, f32 = torch.int8, torch.int32, torch.float32
    return (("digits", i8, (2 * q, d)), ("rho", f32, (q,)), ("qs1", f32, (q,)),
            ("qoff", i32, (2 * q,)), ("merge_count", i32, (q,)),
            *merge_parts(q, runs, kpad))


def _call(corpus, queries, n, k, rows_per_split=None):
    """One C call (:func:`flat_digit_call`): the ring above Q 8."""
    return flat_digit_call("flat_topk_int4", _ARGTYPES, corpus, queries, n,
                           k, _parts, True, rows_per_split=rows_per_split)


def flat_digit_prep(queries: torch.Tensor) -> dict:
    """The prologue kernel alone on a CUDA tensor (the plain twin on a CPU
    one); outputs as :func:`flat_digit_prep_plain`."""
    if queries.device.type == "cpu":
        return flat_digit_prep_plain(queries)
    work = _call(None, queries, max(1, queries.shape[0]), 1)[0]
    return {name: work.view(name) for name in _PREP_NAMES}


def flat_topk_int4_scan(
    nibbles: torch.Tensor,
    scales: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    rows_per_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ``N = len(penalty)`` int4 rows (``nibbles``
    ``[ceil(N/2), D]`` uint8), ``scales`` and ``penalty`` (0 / ``-inf``)
    ``[N]`` f32.  Same outputs as ``flat_topk_int8_scan``.
    ``rows_per_split`` (an even multiple of 128) sets the rows a CTA scans
    at Q <= 8 and about them above (``cdiv(N, rows_per_split)`` runs), for
    the int4 probe; by default the card sizes them."""
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
    work, out_s, out_i, scores = _call((nibbles, scales, penalty), queries,
                                       n, k, rows_per_split)
    if scores is None:
        return out_s, out_i
    top, ids = select_topk(scores, k)
    return top * work.view("qs1")[:, None], ids
