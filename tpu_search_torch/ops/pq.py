"""Product-quantization codec: the IVF index's ``pq`` storage tier.

Counterpart of ``tpu_search/ops/pq.py`` (the FAISS ``IndexIVFPQ`` math):
``M`` subspaces of ``D / M`` dims, 16 centroids each, so a row stores as
``M`` 4-bit codes, ``M / 2`` bytes (768-d at ``M = 192``: 96 bytes a row).
Codes are raw codebook ids 0..15 and live in the int4 tier's nibble-pair
byte layout with ``M`` columns (``index/ivf.py``).

- **Training** is chunked Lloyd over all ``M`` subspaces at once (a
  ``[chunk, M, 16]`` score tile a step), with the JAX package's numpy
  random draws in the same order, so one seed trains the same books in
  both packages.  A centroid no row picks keeps its place.
- **OPQ** (``train_opq``) alternates Lloyd in the rotated space with the
  orthogonal Procrustes update ``R = U V^T`` of ``svd(X^T Y)``; ``X^T Y``
  adds up chunk by chunk in float64 on the host, the SVD runs in numpy.
- **Scoring** is the ADC table lookup ``sum_m lut[q, m, code[n, m]]``
  (:func:`pq_block_scores`): a gather from the ``[Q, M, 16]`` table, the
  subspaces summed in one fixed pairwise order (:func:`subspace_sum`),
  the same for any batch shape.  The JAX package scores with a one-hot
  matmul on its MXU; a lookup sums the same f32 entries.
- **The IVF probe scan** (:func:`ivf_pq_topk`) walks each query's probed
  clusters in fixed steps of at most ``_TILE_ELEMS`` table entries with a
  running top-k merge: plain PyTorch on every device, as the JAX package
  scores pq outside its Pallas kernels, with static shapes and no host
  sync, so the fused query path captures it in a CUDA graph.

Every product of f32 operands (the assignment dots, the LUT, the Lloyd
sums, the OPQ rotation) runs in float64 and rounds to f32 once, so no
TF32 setting of the process changes a code or a score.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "PQ_K",
    "decode_pq",
    "encode_pq",
    "ivf_pq_topk",
    "mm_f32",
    "pq_block_scores",
    "pq_lut",
    "pq_query_lut",
    "pq_scores",
    "subspace_sum",
    "train_opq",
    "train_opq_for_ivf",
    "train_pq",
    "train_pq_for_ivf",
]

PQ_K = 16  # centroids a subspace: 4-bit codes in the nibble layout
_CHUNK = 8192
# Table entries one step of the probe scan gathers ([Q, slots, m]; about
# 200 MB of transients at this size).
_TILE_ELEMS = 1 << 24

Rows = Union[np.ndarray, torch.Tensor]


def _as_rows(data: Rows, device: Optional[torch.device] = None) -> torch.Tensor:
    """``data`` as f32 rows on ``device`` (default: where a tensor lies,
    the CPU for a numpy array)."""
    t = torch.as_tensor(np.asarray(data, np.float32)
                        if not isinstance(data, torch.Tensor) else data)
    return t.to(device=t.device if device is None else device,
                dtype=torch.float32)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f32 operands in float64, rounded once to f32: a full
    f32 product whatever the process's TF32 setting."""
    return (a.double() @ b.double()).float()


def _subspace_view(data: torch.Tensor, m: int) -> torch.Tensor:
    """[N, D] -> [N, m, dsub]; D must divide evenly by m."""
    n, d = data.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by pq_m {m}")
    return data.reshape(n, m, d // m)


def _assign_chunk(chunk: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """[C, m, dsub] x [m, 16, dsub] -> [C, m] int64 nearest-centroid ids:
    ``argmax(x.c - |c|^2 / 2)``, the first index on a tie."""
    dots = torch.einsum("cmd,mkd->cmk", chunk.double(),
                        books.double()).float()
    half_sq = 0.5 * (books * books).sum(dim=-1)  # [m, 16]
    return torch.argmax(dots - half_sq[None], dim=-1)


def _lloyd(rows: torch.Tensor, books: torch.Tensor, m: int,
           iters: int) -> torch.Tensor:
    """``iters`` Lloyd steps of all ``m`` subspaces over ``rows`` [N, D],
    chunk by chunk; a centroid no row picks keeps its place."""
    for _ in range(iters):
        sums = torch.zeros(books.shape, dtype=torch.float64,
                           device=rows.device)
        counts = torch.zeros(books.shape[:2], dtype=torch.float64,
                             device=rows.device)
        for c0 in range(0, rows.shape[0], _CHUNK):
            chunk = _subspace_view(rows[c0: c0 + _CHUNK], m)
            codes = _assign_chunk(chunk, books)
            oh = torch.nn.functional.one_hot(codes, PQ_K).double()
            sums += torch.einsum("cmk,cmd->mkd", oh, chunk.double())
            counts += oh.sum(dim=0)
        new = (sums / counts.clamp(min=1.0)[:, :, None]).float()
        books = torch.where((counts > 0)[:, :, None], new, books)
    return books


def _tile_small(x: torch.Tensor) -> torch.Tensor:
    """Fewer than 16 rows tile up to 16 (duplicate centroids go unused)."""
    n = x.shape[0]
    if n >= PQ_K:
        return x
    return x.repeat(-(-PQ_K // n), 1)[:PQ_K]


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x[torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)]


def train_pq(
    data: Rows,
    m: int,
    *,
    iters: int = 20,
    seed: int = 0,
    sample: int = 131072,
) -> torch.Tensor:
    """``[m, 16, dsub]`` f32 codebooks fit to ``[N, D]`` rows: a sorted
    sample of ``sample`` rows, 16 sampled rows as the first books, then
    ``iters`` chunked Lloyd steps (on the rows' device)."""
    x = _as_rows(data)
    if x.shape[0] == 0:
        raise ValueError("need at least 1 training row")
    x = _tile_small(x)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n > sample:
        x = _take(x, np.sort(rng.choice(n, sample, replace=False)))
        n = sample
    init_rows = _take(x, rng.choice(n, PQ_K, replace=False))
    init = _subspace_view(init_rows, m).transpose(0, 1).contiguous()
    return _lloyd(x, init, m, iters)


def encode_pq(data: Rows, books: torch.Tensor) -> torch.Tensor:
    """[N, D] rows -> [N, m] uint8 codes in [0, 15], on the books' device,
    ``_CHUNK`` rows at a time."""
    x = _as_rows(data, books.device)
    m = books.shape[0]
    if x.shape[0] <= _CHUNK:
        return _assign_chunk(_subspace_view(x, m), books).to(torch.uint8)
    return torch.cat([
        _assign_chunk(_subspace_view(x[i: i + _CHUNK], m), books)
        .to(torch.uint8) for i in range(0, x.shape[0], _CHUNK)])


def decode_pq(codes: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """[N, m] codes -> [N, D] f32 reconstruction (the codebook rows)."""
    m, _, dsub = books.shape
    sub = torch.arange(m, device=books.device)[None, :]
    return books[sub, codes.to(books.device).long()].reshape(
        codes.shape[0], m * dsub)


def pq_lut(queries: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """[Q, D] queries -> [Q, m, 16] inner-product tables
    (``lut[q, m, j] = q_m . books[m, j]``)."""
    qs = _subspace_view(queries.float(), books.shape[0])
    return torch.einsum("qmd,mkd->qmk", qs.double(), books.double()).float()


def subspace_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in one fixed pairwise order (``x[i] +
    x[i + h]``, halving; an odd tail joins the next round), so a score is
    the same whatever the leading shape."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        head = x[..., :h] + x[..., h: 2 * h]
        x = torch.cat([head, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 \
            else head
    return x[..., 0]


def pq_scores(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Per-query code rows ``[Q, L, m]`` (uint8) x ``[Q, m, 16]`` tables
    -> ``[Q, L]`` f32: one gather from the flat table with int32 offsets,
    then :func:`subspace_sum`.  Static shapes, no host sync."""
    q, m = lut.shape[0], lut.shape[1]
    base = (torch.arange(q, device=lut.device, dtype=torch.int32)[:, None]
            * m + torch.arange(m, device=lut.device, dtype=torch.int32)
            [None, :]) * PQ_K
    idx = codes.to(torch.int32) + base[:, None, :]
    return subspace_sum(lut.reshape(-1)[idx])


def pq_block_scores(code_rows: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Score one cluster block: ``[cap, m]`` codes x ``[Q, m, 16]`` LUT ->
    ``[Q, cap]`` f32, the classic ADC table lookup."""
    codes = code_rows.to(lut.device)[None].expand(lut.shape[0], -1, -1)
    return pq_scores(codes, lut)


def pq_query_lut(queries: torch.Tensor, books: torch.Tensor,
                 rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan's tables: from ``queries @ rot`` under OPQ (the codes live
    in the rotated space, ``q . decode = (q R) . decode_rotated``), else
    from the queries."""
    return pq_lut(mm_f32(queries.float(), rot) if rot is not None else queries,
                  books)


def _scan_units(q: int, nprobe: int, half: int, m: int) -> list:
    """The probe scan's steps ``(j0, j1, b0, b1)``: probe slots ``[j0,
    j1)``, byte rows ``[b0, b1)`` of each (slots ``2 b0 .. 2 b1``), sized so
    that a step gathers at most ``_TILE_ELEMS`` table entries: whole
    clusters a group when one fits, else a cluster in slices."""
    slots = max(2, _TILE_ELEMS // (q * m))
    if slots >= 2 * half:
        g = min(nprobe, slots // (2 * half))
        return [(j, min(nprobe, j + g), 0, half) for j in range(0, nprobe, g)]
    hb = slots // 2
    return [(j, j + 1, b, min(half, b + hb))
            for j in range(nprobe) for b in range(0, half, hb)]


def ivf_pq_topk(
    blocks: torch.Tensor,
    penalty: torch.Tensor,
    probe: torch.Tensor,
    lut: torch.Tensor,
    k: int,
    cbias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IVF probe scan of pq blocks, plain PyTorch on any device.

    ``blocks [nlist, cap/2, m]`` uint8 nibble-pair code rows, ``penalty
    [nlist, cap]`` f32 (0 / ``-inf``), ``probe [Q, nprobe]`` cluster ids,
    ``lut [Q, m, 16]`` (:func:`pq_query_lut`), ``cbias [Q, nprobe]`` the
    probed clusters' centroid scores (residual codes).  Each query's
    ``(ADC score + cbias) + penalty`` over its probed clusters, walked in
    the fixed steps of :func:`_scan_units` with a running top-k merge (a
    stable sort: ties keep the earlier probe slot, then the lower slot).
    Returns ``(scores [Q, k] f32, flat slots cluster * cap + slot [Q, k]
    int64)``; ``k`` at most ``nprobe * cap``.  Static shapes, no host
    sync: capturable in a CUDA graph."""
    q, nprobe = probe.shape
    half, m = blocks.shape[1], blocks.shape[2]
    cap = 2 * half
    dev = blocks.device
    best_s = torch.full((q, k), float("-inf"), dtype=torch.float32, device=dev)
    best_p = torch.zeros((q, k), dtype=torch.int64, device=dev)
    pl = probe.long()
    for j0, j1, b0, b1 in _scan_units(q, nprobe, half, m):
        pc = pl[:, j0:j1]  # [Q, g]
        byt = blocks[:, b0:b1][pc]  # [Q, g, nb, m]
        g, nb = byt.shape[1], byt.shape[2]
        codes = torch.stack([byt & 0x0F, byt >> 4], dim=3).reshape(
            q, g * nb * 2, m)
        s = pq_scores(codes, lut).view(q, g, 2 * nb)
        if cbias is not None:
            s = s + cbias[:, j0:j1, None]
        s = s + penalty[:, 2 * b0: 2 * b1][pc]
        pos = pc[:, :, None] * cap + torch.arange(
            2 * b0, 2 * b1, device=dev)[None, None, :]
        top, order = torch.sort(torch.cat([best_s, s.reshape(q, -1)], dim=1),
                                dim=1, descending=True, stable=True)
        best_s = top[:, :k]
        best_p = torch.gather(torch.cat([best_p, pos.reshape(q, -1)], dim=1),
                              1, order[:, :k])
    return best_s.contiguous(), best_p


def _ivf_training_residuals(
    data: Rows,
    centroids: Rows,
    metric: str,
    *,
    by_residual: bool,
    seed: int,
    sample: int,
) -> torch.Tensor:
    """Subsample first, then residual-encode the sample alone (a
    ``[sample, D]`` transient, never a corpus-sized one)."""
    from .kmeans import assign_clusters

    x = _as_rows(data)
    n = x.shape[0]
    if n > sample:
        rng = np.random.default_rng(seed)
        x = _take(x, np.sort(rng.choice(n, sample, replace=False)))
    if by_residual:
        cents = _as_rows(centroids, x.device)
        x = x - cents[assign_clusters(x, cents, metric).long()]
    return x


def train_pq_for_ivf(
    data: Rows,
    centroids: Rows,
    metric: str,
    m: int,
    *,
    by_residual: bool,
    seed: int = 0,
    sample: int = 131072,
) -> torch.Tensor:
    """``[m, 16, dsub]`` books for an IVF index: fit to the residuals
    against ``centroids`` (or the raw rows without ``by_residual``)."""
    x = _ivf_training_residuals(data, centroids, metric,
                                by_residual=by_residual, seed=seed,
                                sample=sample)
    return train_pq(x, m, seed=seed, sample=sample)


def _xty_chunk(chunk: torch.Tensor, rot: torch.Tensor,
               books: torch.Tensor) -> np.ndarray:
    """One OPQ rotation step's ``X^T Y`` ([D, D] float64, on the host) of a
    chunk: Y is the rotated chunk's reconstruction."""
    xr = mm_f32(chunk, rot)
    codes = _assign_chunk(_subspace_view(xr, books.shape[0]), books)
    y = decode_pq(codes, books)
    return (chunk.double().T @ y.double()).cpu().numpy()


def train_opq(
    data: Rows,
    m: int,
    *,
    outer_iters: int = 8,
    lloyd_iters: int = 4,
    seed: int = 0,
    sample: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPQ-NP (Ge et al., CVPR'13; FAISS ``OPQMatrix``): an orthonormal
    ``R [D, D]`` and books such that rows encode as ``pq(x @ R)``.  The
    random orthogonal start is the QR of a gaussian from the same numpy
    generator as the sample; each outer step refits the books in the
    current rotated space (8 Lloyd steps the first time), then sets ``R =
    U V^T`` from the SVD of ``X^T Y``; a last refit follows.  Returns
    ``(rot [D, D] f32, books [m, 16, dsub] f32)``."""
    x = _as_rows(data)
    n, d = x.shape
    if n == 0:
        raise ValueError("need at least 1 training row")
    if d % m:
        raise ValueError(f"dim {d} not divisible by pq_m {m}")
    x = _tile_small(x)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n > sample:
        x = _take(x, np.sort(rng.choice(n, sample, replace=False)))
        n = sample
    q_init, _ = np.linalg.qr(rng.standard_normal((d, d)))
    rot = torch.from_numpy(q_init.astype(np.float32)).to(x.device)
    init_rows = _take(x, rng.choice(n, PQ_K, replace=False))
    books = _subspace_view(mm_f32(init_rows, rot), m).transpose(0, 1).contiguous()
    for it in range(outer_iters):
        books = _lloyd(mm_f32(x, rot), books, m,
                       lloyd_iters if it else max(lloyd_iters, 8))
        xty = np.zeros((d, d), np.float64)
        for c0 in range(0, n, _CHUNK):
            xty += _xty_chunk(x[c0: c0 + _CHUNK], rot, books)
        u, _, vt = np.linalg.svd(xty)
        rot = torch.from_numpy((u @ vt).astype(np.float32)).to(x.device)
    books = _lloyd(mm_f32(x, rot), books, m, lloyd_iters)
    return rot, books


def train_opq_for_ivf(
    data: Rows,
    centroids: Rows,
    metric: str,
    m: int,
    *,
    by_residual: bool,
    seed: int = 0,
    sample: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPQ twin of :func:`train_pq_for_ivf`: ``(rot, books)`` fit to the
    residual (or raw) sample."""
    x = _ivf_training_residuals(data, centroids, metric,
                                by_residual=by_residual, seed=seed,
                                sample=sample)
    return train_opq(x, m, seed=seed, sample=sample)
