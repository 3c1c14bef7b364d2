"""Exact masked top-k scan over bf16 / f32 rows: wrapper of the hand-written
CUDA kernel.

Kernel: ``csrc/flat_topk.cu`` (replaces ``pallas_flat_topk_dma`` of
``tpu_search/ops/pallas_topk_dma.py``, with the bf16 cast of the queries
around it).  On the card a search is one C call of three launches, nothing
of PyTorch's between them: the prologue casts the queries to bf16 for bf16
rows and zeroes the merge's counters (its plain twin
:func:`flat_float_prep_plain`), the scan (the ``cp.async`` ring of
``csrc/ivf_float_scan.cuh`` over every 128-row tile, runs of tiles sized
from the card) and the tree merge of ``csrc/run_merge.cuh``.  Its scratch
and outputs are one ``torch.empty``.  CPU tensors take the plain version
in ``ops/topk_scan.py``; a CUDA tensor launches the kernel or raises.
``k <= MAX_K`` selects inside the kernel; a larger k runs the scan's
scores-only mode (the same products, alpha and penalty, written as
``[Q, N]`` f32) and a stable descending sort, as the JAX package sends
k > 128 to its XLA scan.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.shapes import cdiv, round_up
from . import _build
from .ring_scan import (
    MAX_K,
    TILE,
    Scratch,
    c_entry,
    check_scan_args,
    float_block,
    merge_parts,
    scan_config,
    scan_runs,
)
from .topk_scan import flat_topk_plain, select_topk

__all__ = ["flat_float_prep", "flat_float_prep_plain", "flat_topk_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# vectors, penalty, queries; n, d, q, k, qb, runs, is_bf16; alpha;
# prologue_only; the scratch (_parts), out_s, out_i, scores, stream
_ARGTYPES = [_P] * 3 + [_I] * 7 + [ctypes.c_float, _I] + [_P] * 10
# The C entry's scratch and outputs, in its order (absent parts null).
_SCRATCH = ("qcast", "merge_count", "part_s", "part_i", "group_s", "group_i",
            "out_s", "out_i", "scores")


def flat_float_prep_plain(queries: torch.Tensor, bf16: bool = True) -> dict:
    """What the prologue kernel writes: ``qcast`` (the queries as bf16 for
    bf16 rows, else None) and ``merge_count [Q]`` int32 zeros."""
    q = queries.shape[0]
    return {"qcast": queries.float().to(torch.bfloat16) if bf16 else None,
            "merge_count": torch.zeros((q,), dtype=torch.int32,
                                       device=queries.device)}


def _parts(q: int, d: int, runs: int, k: int, n: int, bf16: bool) -> tuple:
    """The scratch and outputs of one call, in the C entry's order."""
    f32, i32 = torch.float32, torch.int32
    kpad = 0 if k > MAX_K else round_up(k, 32)
    outs = ((("scores", f32, (q, n)),) if k > MAX_K else
            (("out_s", f32, (q, k)), ("out_i", i32, (q, k))))
    return ((("qcast", torch.bfloat16, (q, d)),) if bf16 else ()) + (
        ("merge_count", i32, (q,)), *merge_parts(q, runs, kpad), *outs)


def _call(vectors: Optional[torch.Tensor], penalty: Optional[torch.Tensor],
          queries: torch.Tensor, k: int, alpha: float, bf16: bool) -> Scratch:
    """One C call: the prologue, then (``vectors`` set) the scan and, at k
    <= MAX_K, the merge.  Returns the scratch, outputs included."""
    queries = queries.float().contiguous()
    q, d = queries.shape
    tensors = {"queries": queries}
    n, runs = 1, 1
    if vectors is not None:
        tensors.update(vectors=vectors, penalty=penalty)
        n = vectors.shape[0]
    dev = check_scan_args(n, k, **tensors)
    qb = float_block(q, bf16)
    if vectors is not None:
        runs = scan_runs(scan_config("flat_topk", qb, k, int(bf16))[1],
                         cdiv(q, qb), cdiv(n, TILE), dev)
    work = Scratch(_parts(q, d, runs, k, n, bf16), dev)
    addr = dict(zip(work.parts, work.ptrs))
    code = c_entry("flat_topk", "flat_topk", _ARGTYPES)(
        None if vectors is None else vectors.data_ptr(),
        None if penalty is None else penalty.data_ptr(), queries.data_ptr(),
        n, d, q, k, qb, runs, int(bf16), float(alpha),
        int(vectors is None), *(addr.get(name) for name in _SCRATCH),
        _build.stream_ptr(dev))
    _build.check(code, "flat_topk")
    _build.LAUNCHES["flat_topk"] += 1
    return work


def flat_float_prep(queries: torch.Tensor, bf16: bool = True) -> dict:
    """The prologue kernel alone on a CUDA tensor (the plain twin on a CPU
    one); outputs as :func:`flat_float_prep_plain`."""
    if queries.device.type == "cpu":
        return flat_float_prep_plain(queries, bf16)
    work = _call(None, None, queries, 1, 1.0, bf16)
    return {"qcast": work.view("qcast") if bf16 else None,
            "merge_count": work.view("merge_count")}


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
    if queries.shape[1] != d or penalty.shape != (n,):
        raise ValueError("shape mismatch between corpus, queries and penalty")
    if d % 8:
        raise ValueError("the CUDA scan needs D % 8 == 0")
    if penalty.dtype != torch.float32:
        raise ValueError("penalty must be float32")
    work = _call(vectors, penalty, queries, k, alpha,
                 vectors.dtype == torch.bfloat16)
    if k > MAX_K:
        return select_topk(work.view("scores"), k)
    return work.view("out_s"), work.view("out_i")
