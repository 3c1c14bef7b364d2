"""Exact masked top-k scans: the plain PyTorch versions.

Counterpart of ``tpu_search/ops/topk_scan.py``.  The float scan
(``flat_topk``) has the contract of ``pallas_flat_topk_dma``: one f32
score per (query, row),

    score = alpha * dot(query, row) - penalty[row]

where ``penalty`` folds the predicate mask and the l2 correction into one
row stream (0 for a live ip row, ``|v|^2`` for a live l2 row, ``+inf`` for a
masked row) and ``alpha`` is 1 (ip) or 2 (l2: ``2 q.v - |v|^2`` ranks like
``-|q - v|^2``).  Queries are cast to the corpus dtype first, products
accumulate in f32, and ties keep the lower row id (a stable sort), as the
TPU kernel's selection does.

:func:`flat_topk_plain` is what the CPU runs and what the CUDA kernel in
``ops/flat_topk.py`` is held against on the card.

The int8 and int4 scans (``flat_topk_int8_plain``, ``flat_topk_int4_plain``;
kernels in ``ops/flat_topk_int8.py`` and ``ops/flat_topk_int4.py``) score

    score = (d1 + rho * d2) * scale[row] + penalty[row]

with ``d1``, ``d2`` the exact int32 dots of a query's two int8 digits
(:func:`quantize_queries`) with the row, the combine one fused multiply-add,
``penalty`` 0 for a live row and ``-inf`` for a masked one, and the top k
multiplied by the query scale ``qs1 > 0`` after selection.  These are the
JAX package's jitted ``flat_topk_int8`` / ``flat_topk_int4`` bit for bit:
under jit XLA divides by 127 as a multiply by the rounded f32 reciprocal
and fuses the combine into an FMA.  Here every int product sum runs as a
float64 matmul (exact: ``|dot| <= 127 * 127 * D < 2^53``), the combine in
float64 (exact product, one rounding of the sum), and every f32 step is
an IEEE f32 operation on CPU and CUDA alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "INV127",
    "absmax_scales",
    "digit_scores",
    "flat_topk",
    "flat_topk_int4",
    "flat_topk_int4_plain",
    "flat_topk_int8",
    "flat_topk_int8_plain",
    "flat_topk_plain",
    "quantize_queries",
    "query_nibble_offsets",
    "row_penalty",
    "row_sq_norms",
    "select_topk",
]

INV127 = np.float32(1.0 / 127.0)
# Corpus rows per float64 block of the quantized plain scans: bounds the
# transient float64 copy of the corpus (64Ki x 768 x 8 B = 384 MiB).
_PLAIN_CHUNK = 65536


def row_sq_norms(vectors: torch.Tensor) -> torch.Tensor:
    """``[N]`` f32 row ``|v|^2`` (the l2 correction)."""
    v = vectors.float()
    return (v * v).sum(dim=1)


def row_penalty(
    mask: torch.Tensor, metric: str, sq_norms: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, float]:
    """``(penalty [N] f32, alpha)`` for a bool ``mask`` and a metric."""
    if metric == "l2":
        if sq_norms is None:
            raise ValueError("metric='l2' requires sq_norms")
        live = sq_norms.float()
        alpha = 2.0
    elif metric == "ip":
        live = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        alpha = 1.0
    else:
        raise ValueError(f"Unknown metric: {metric}")
    inf = torch.full_like(live, float("inf"))
    return torch.where(mask, live, inf), alpha


def flat_topk_plain(
    vectors: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores [Q, k] f32, ids [Q, k] int32)``; slots without a live row
    score ``-inf`` with id ``-1``."""
    dots = queries.to(vectors.dtype).float() @ vectors.float().T
    if alpha != 1.0:
        dots = dots * alpha
    return select_topk(dots - penalty.float()[None, :], k)


def select_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of ``[Q, N]`` scores by a stable descending sort (ties
    on the lower row id, as ``lax.top_k`` and the kernels order them);
    id ``-1`` where the score is not finite."""
    top, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top, ids = top[:, :k].contiguous(), order[:, :k].to(torch.int32)
    ids = torch.where(torch.isfinite(top), ids, torch.full_like(ids, -1))
    return top, ids


def flat_topk(
    vectors: torch.Tensor,
    mask: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "ip",
    sq_norms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain scan with the JAX package's ``flat_topk`` arguments: a
    bool ``[N]`` mask and a metric instead of a penalty stream."""
    if metric == "l2" and sq_norms is None:
        sq_norms = row_sq_norms(vectors)
    penalty, alpha = row_penalty(mask, metric, sq_norms)
    return flat_topk_plain(vectors, penalty, queries, k, alpha)


# -- int8 / int4 corpora -------------------------------------------------------


def absmax_scales(x: torch.Tensor, inv: np.float32) -> torch.Tensor:
    """Per-row ``max(max|x| * inv, 1e-12)`` f32 for ``[N, D]`` f32 ``x``,
    ``inv`` an f32 reciprocal (``f32(1/127)``, ``f32(1/7)``): the JAX
    package's jitted ``max|x| / 127.0``, which XLA computes as that
    multiply.  The Python scalar is cast to f32 by the multiply, so this is
    one f32 rounding on any device, with no host-to-device copy."""
    return (x.abs().amax(dim=1) * float(inv)).clamp_min(1e-12)


def quantize_queries(
    queries: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-digit symmetric int8 query quantization, ``q ~ qs1 * (q1 + rho *
    q2)``: the first digit quantizes the query, the second its residual.

    Returns ``(q_i8 [2Q, D] int8, rho [Q] f32, qs1 [Q] f32)`` with the
    digits stacked (``q1`` rows first).  The scales come from
    :func:`absmax_scales`; the tensor-by-tensor quotients stay true
    divisions (never ``t / 127.0``, which CUDA computes through a
    reciprocal)."""
    q = queries.float()
    qs1 = absmax_scales(q, INV127)
    q1 = torch.round(q / qs1[:, None])
    # XLA contracts this into an FMA: the float64 difference of the exact
    # product is exact, so one rounding to f32 gives the fused result.
    resid = (q.double() - qs1.double()[:, None] * q1.double()).float()
    qs2 = absmax_scales(resid, INV127)
    q2 = torch.round(resid / qs2[:, None])
    q_i8 = torch.cat([q1, q2]).to(torch.int8)
    return q_i8, qs2 / qs1, qs1


def query_nibble_offsets(q_i8: torch.Tensor) -> torch.Tensor:
    """``[2Q]`` int32 bias of each query digit against biased nibbles:
    ``dot(q, u) = dot(q, u - 8) + 8 * sum(q)``."""
    from .int4_pack import NIBBLE_BIAS

    return NIBBLE_BIAS * q_i8.to(torch.int32).sum(dim=1, dtype=torch.int32)


def digit_scores(
    dots: torch.Tensor,
    rho: torch.Tensor,
    scales: torch.Tensor,
    penalty: torch.Tensor,
) -> torch.Tensor:
    """``[2Q, C]`` float64 exact digit dots -> ``[Q, C]`` f32 scores
    ``fma(rho, d2, d1) * scale + penalty``.  The float64 sum of the exact
    product rounds once before the f32 rounding, as the FMA does, up to
    a double rounding that needs the sum on an f32 midpoint."""
    q = dots.shape[0] // 2
    combined = (dots[:q] + rho.double()[:, None] * dots[q:]).float()
    return combined * scales.float()[None, :] + penalty.float()[None, :]


def _quant_plain(row_blocks, rho, qs1, scales, penalty, k):
    scores = torch.cat([
        digit_scores(dots, rho, scales[r0:r1], penalty[r0:r1])
        for r0, r1, dots in row_blocks
    ], dim=1)
    top, ids = select_topk(scores, k)
    return top * qs1[:, None], ids


def flat_topk_int8_plain(
    rows: torch.Tensor,
    scales: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ``rows [N, D]`` int8 with per-row ``scales [N]`` and a
    0 / ``-inf`` ``penalty [N]``.  Returns ``(scores [Q, k] f32, ids [Q, k]
    int32)``; id ``-1`` where no live row is left."""
    q_i8, rho, qs1 = quantize_queries(queries)
    qd = q_i8.double()
    n = rows.shape[0]

    def blocks():
        for r0 in range(0, n, _PLAIN_CHUNK):
            r1 = min(n, r0 + _PLAIN_CHUNK)
            yield r0, r1, qd @ rows[r0:r1].double().T

    return _quant_plain(blocks(), rho, qs1, scales, penalty, k)


def flat_topk_int4_plain(
    nibbles: torch.Tensor,
    scales: torch.Tensor,
    penalty: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ``N = len(penalty)`` int4 rows held as nibble-pair bytes
    ``[ceil(N/2), D]`` uint8 (``ops.int4_pack``), biased nibbles in
    1..15.  The bias is removed exactly (:func:`query_nibble_offsets`)
    before the combine.  Same outputs as :func:`flat_topk_int8_plain`."""
    from .int4_pack import bytes_to_nibble_rows

    q_i8, rho, qs1 = quantize_queries(queries)
    qoff = query_nibble_offsets(q_i8).double()[:, None]
    qd = q_i8.double()
    n = penalty.shape[0]

    def blocks():
        for r0 in range(0, n, _PLAIN_CHUNK):  # _PLAIN_CHUNK is even
            r1 = min(n, r0 + _PLAIN_CHUNK)
            u = bytes_to_nibble_rows(nibbles[r0 // 2: (r1 + 1) // 2])
            yield r0, r1, qd @ u[: r1 - r0].double().T - qoff

    return _quant_plain(blocks(), rho, qs1, scales, penalty, k)


def flat_topk_int8(
    vectors: torch.Tensor,
    scales: torch.Tensor,
    mask: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain int8 scan with the JAX package's ``flat_topk_int8``
    arguments: ``[N, D]`` int8 rows and a bool ``[N]`` mask instead of a
    penalty stream."""
    penalty = torch.where(mask, 0.0, float("-inf"))
    return flat_topk_int8_plain(vectors, scales, penalty, queries, k)


def flat_topk_int4(
    words: torch.Tensor,
    scales: torch.Tensor,
    mask: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain int4 scan with the JAX package's ``flat_topk_int4``
    arguments: the ``[N/8, D]`` int32 word layout (byte ``b`` of word
    ``(s, c)`` is nibble-pair byte row ``4s + b``) and a bool ``[N]``
    mask."""
    c, d = words.shape
    nibbles = words.contiguous()[..., None].view(torch.uint8)  # [C, D, 4]
    nibbles = nibbles.transpose(1, 2).reshape(4 * c, d)
    penalty = torch.where(mask, 0.0, float("-inf"))
    return flat_topk_int4_plain(nibbles, scales, penalty, queries, k)
