"""Balanced Lloyd k-means on the device (the IVF coarse quantizer's trainer).

Counterpart of ``tpu_search/ops/kmeans.py``: the assignment step is one
``[N, k]`` product, the update step a one-hot product, both in chunks of
``_CHUNK`` rows once ``N * k`` passes ``_SINGLE_SHOT_ELEMS`` (the only
corpus-by-clusters objects of the IVF stack: 1M x 4096 f32 is 16 GB).
The ip metric renormalises the centroids every iteration (spherical
k-means).

Randomness comes from a ``torch.Generator`` (the first centroids, and the
respawn noise of each iteration).  ``init_idx`` and a ``[iters, k, D]``
``noise`` tensor may be passed instead, so a test can hand this function
the JAX package's own random numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["assign_clusters", "kmeans"]

_CHUNK = 65536
# Above this many [N, k] f32 score elements (~0.5 GB), chunk the scan.
_SINGLE_SHOT_ELEMS = 1 << 27


def _distances(data: torch.Tensor, centroids: torch.Tensor, metric: str) -> torch.Tensor:
    """[N, D] x [k, D] -> [N, k] similarity (higher = closer)."""
    dots = data @ centroids.T
    if metric == "l2":
        sq = (centroids * centroids).sum(dim=-1)
        return 2.0 * dots - sq[None, :]
    return dots


def _chunked(n: int, k: int) -> bool:
    return n * k > _SINGLE_SHOT_ELEMS and n > _CHUNK


def assign_clusters(
    data: torch.Tensor, centroids: torch.Tensor, metric: str = "ip"
) -> torch.Tensor:
    """Nearest-centroid assignment, ``[N]`` int32 (first index on a tie)."""
    data = data.float()
    n, k = data.shape[0], centroids.shape[0]
    if not _chunked(n, k):
        return torch.argmax(_distances(data, centroids, metric), dim=1).to(torch.int32)
    return torch.cat([
        torch.argmax(_distances(data[i: i + _CHUNK], centroids, metric), dim=1)
        for i in range(0, n, _CHUNK)
    ]).to(torch.int32)


def _accumulate(data, centroids, metric):
    """One pass over the rows -> (sums [k, D], sums of |x|^2 [k], counts [k])."""
    k = centroids.shape[0]
    step = _CHUNK if _chunked(data.shape[0], k) else data.shape[0]
    sums = sumsq = counts = None
    for i in range(0, data.shape[0], step):
        chunk = data[i: i + step]
        assign = torch.argmax(_distances(chunk, centroids, metric), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).float()
        rsq = (chunk * chunk).sum(dim=1)
        part = (one_hot.T @ chunk, one_hot.T @ rsq, one_hot.sum(dim=0))
        if sums is None:
            sums, sumsq, counts = part
        else:
            sums, sumsq, counts = sums + part[0], sumsq + part[1], counts + part[2]
    return sums, sumsq, counts


def kmeans(
    data: torch.Tensor,
    k: int,
    iters: int = 10,
    metric: str = "ip",
    balance: float = 0.0,
    generator: Optional[torch.Generator] = None,
    init_idx: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations; returns ``(centroids [k, D], assignments [N])``.

    Empty clusters respawn each iteration as perturbed copies of a heavy
    cluster's centroid.  ``balance > 0`` respawns every cluster holding
    fewer than ``balance * n / k`` points next to a heavy one (the i-th
    lightest beside the i-th heaviest, at most ``k // 8`` an iteration,
    none in the last ``max(3, iters // 3)`` settle iterations except truly
    empty ones, which respawn until two iterations before the end);
    ``balance < 0`` turns the repair off.  The JAX function's semantics,
    step for step."""
    data = data.float()
    n, d = data.shape
    dev = data.device
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator, device=dev)[:k]
    centroids = data[torch.as_tensor(init_idx, device=dev).long()]

    threshold = balance * n / k
    settle = max(3, iters // 3)
    max_respawn = max(1, k // 8)
    rank = torch.arange(k, device=dev)
    for t in range(iters):
        sums, sumsq, counts = _accumulate(data, centroids, metric)
        counts = counts[:, None]
        updated = sums / torch.clamp(counts, min=1.0)
        radius = torch.sqrt(torch.clamp(
            sumsq / torch.clamp(counts[:, 0], min=1.0)
            - (updated * updated).sum(dim=1),
            min=1e-8,
        ))
        updated = torch.where(counts > 0, updated, centroids)
        if balance >= 0:
            order = torch.argsort(counts[:, 0], stable=True)
            donors = order.flip(0)
            c_ord = counts[order, 0]
            starved = (c_ord <= threshold) & (rank < max_respawn)
            starved = starved & (t < iters - settle)
            starved = starved | ((c_ord == 0) & (t < iters - 2))
            if noise is None:
                z = torch.randn((k, d), generator=generator, device=dev)
            else:
                z = torch.as_tensor(noise[t], device=dev).float()
            unit = z / torch.clamp(z.norm(dim=1, keepdim=True), min=1e-12)
            offset = radius[donors][:, None]
            if metric != "l2":
                offset = offset / math.sqrt(float(d))
            respawn = updated[donors] + offset * unit
            new_at_order = torch.where(starved[:, None], respawn, updated[order])
            updated = torch.zeros_like(updated)
            updated[order] = new_at_order
        if metric == "ip":
            updated = updated / torch.clamp(
                updated.norm(dim=1, keepdim=True), min=1e-12)
        centroids = updated
    return centroids, assign_clusters(data, centroids, metric)
