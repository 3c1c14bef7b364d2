"""Refine tier: id-keyed high-fidelity rows that re-rank a coarse IVF scan.

Counterpart of ``tpu_search/index/refine.py`` (FAISS ``IndexRefine`` /
``IndexIVFPQR`` analog):

- **Id-keyed, append-only.**  Row ``id`` lives at slot ``id`` of a dense
  ``[capacity, D]`` device buffer (int8 with per-row f32 scales, or
  bf16); appends write a slice in place, and cluster-layout mutations
  (rebalance, capacity growth) never touch the store.  Tombstoned ids keep
  their row; :meth:`RefineStore.compact` re-keys after the owning index
  renumbers.
- **Gather-then-product rescoring** (:func:`refine_rescore`): stage 1's
  ``[Q, R]`` candidate ids gather ``[Q, R, D]`` rows, dequantize, and score
  with one batched product.
- **Exact truth scan** (:meth:`RefineStore.topk_all`): the flat scans of
  the port (``ops.flat_topk_int8`` / ``ops.flat_topk``: the CUDA kernels on
  the card) over every live refine row, the deployed-recall calibration's
  ground truth.

Scores are ``ip`` (the quantized-storage contract).  int8 rows quantize as
``FlatIndex`` does, bit for bit with the JAX store.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..ops.flat_topk import flat_topk_scan
from ..ops.flat_topk_int8 import flat_topk_int8_scan
from ..ops.topk_scan import select_topk
from ..utils.shapes import round_up
from .flat import quantize_rows_int8

__all__ = ["REFINE_DTYPES", "RefineStore", "refine_rescore"]

REFINE_DTYPES = ("int8", "bfloat16")
_MIN_CAPACITY = 4096
_GROWTH = 1.25


def _round_capacity(n: int) -> int:
    return -(-max(n, _MIN_CAPACITY) // _MIN_CAPACITY) * _MIN_CAPACITY


def refine_rescore(
    rows: torch.Tensor,
    scales: Optional[torch.Tensor],
    qbatch: torch.Tensor,
    ids: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank stage-1 candidates ``ids [Q, R]`` (-1 = none) against the
    refine rows: ``(scores [Q, k], ids [Q, k])`` by the refined inner
    product, first candidate first on a tie, ``-inf`` / ``-1`` past the
    real candidates."""
    safe = ids.clamp(0, rows.shape[0] - 1).long()
    cand = rows[safe].float()  # [Q, R, D]
    if scales is not None:
        cand = cand * scales[safe][..., None]
    rescored = torch.bmm(cand, qbatch.float()[:, :, None])[..., 0]
    rescored = torch.where(ids >= 0, rescored,
                           torch.full_like(rescored, float("-inf")))
    top, pos = select_topk(rescored, min(k, ids.shape[1]))
    out_ids = torch.gather(ids, 1, pos.clamp(min=0).long())
    return top, torch.where(torch.isfinite(top), out_ids,
                            torch.full_like(out_ids, -1))


class RefineStore:
    """Dense id-keyed high-fidelity row store on one device."""

    # Bulk appends land in chunks of this many rows (bounded transients).
    APPEND_CHUNK_ROWS = 131072

    def __init__(
        self,
        dim: int,
        dtype: str = "int8",
        device: Optional[torch.device] = None,
    ) -> None:
        if dtype not in REFINE_DTYPES:
            raise ValueError(
                f"refine dtype must be one of {REFINE_DTYPES}, got {dtype!r}")
        self.dim = dim
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else (
            resolve_device())
        self.rows: Optional[torch.Tensor] = None  # [cap, D] int8 | bf16
        self.scales: Optional[torch.Tensor] = None  # [cap] f32 (int8 only)
        self.capacity = 0
        self.count = 0  # slots [0, count) hold written rows

    @property
    def nbytes_per_row(self) -> int:
        return self.dim + 4 if self.dtype == "int8" else 2 * self.dim

    def _ensure(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = _round_capacity(max(needed, int(self.capacity * _GROWTH)))
        tdt = torch.int8 if self.dtype == "int8" else torch.bfloat16
        rows = torch.zeros((new_cap, self.dim), dtype=tdt, device=self.device)
        if self.rows is not None:
            rows[: self.capacity] = self.rows
        self.rows = rows
        if self.dtype == "int8":
            scales = torch.zeros((new_cap,), dtype=torch.float32,
                                 device=self.device)
            if self.scales is not None:
                scales[: self.capacity] = self.scales
            self.scales = scales
        self.capacity = new_cap

    def append(self, batch: torch.Tensor, n_new: int) -> None:
        """Land the first ``n_new`` rows of ``batch`` ([B, D] f32, host or
        device) at slots ``[count, count + n_new)``, in place."""
        if n_new <= 0:
            return
        batch = torch.as_tensor(batch)
        base = self.count
        self._ensure(base + n_new)
        for lo in range(0, n_new, self.APPEND_CHUNK_ROWS):
            hi = min(n_new, lo + self.APPEND_CHUNK_ROWS)
            piece = batch[lo:hi].to(device=self.device, dtype=torch.float32)
            if self.dtype == "int8":
                q, s = quantize_rows_int8(piece)
                self.rows[base + lo: base + hi] = q
                self.scales[base + lo: base + hi] = s
            else:
                self.rows[base + lo: base + hi] = piece.to(torch.bfloat16)
        self.count = base + n_new

    def gather(self, ids) -> torch.Tensor:
        """Dequantized ``[n, D]`` f32 rows of the given ids (the rebalance's
        reconstruction source)."""
        idx = torch.as_tensor(ids, device=self.device).long()
        out = self.rows[idx].float()
        if self.scales is not None:
            out = out * self.scales[idx][:, None]
        return out

    def rescore(self, qbatch: torch.Tensor, ids: torch.Tensor, k: int):
        return refine_rescore(self.rows, self.scales, qbatch, ids, k)

    def topk_all(
        self, queries: np.ndarray, live_mask: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k of f32 ``queries`` against every live refine row
        (``live_mask``: host bool over ids).  Host ``(scores, ids)``."""
        q = np.asarray(queries).shape[0]
        if self.rows is None or self.count == 0:
            return (np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int64))
        # Slots past count are dead: scan only what is needed, as
        # FlatIndex.search does.
        n_scan = min(self.capacity, max(round_up(self.count, 128), k))
        live = np.zeros((n_scan,), np.bool_)
        n = min(self.count, len(live_mask))
        live[:n] = np.asarray(live_mask, np.bool_)[:n]
        live = torch.from_numpy(live).to(self.device)
        qt = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        if self.dtype == "int8":
            penalty = torch.where(live, 0.0, float("-inf"))
            scores, ids = flat_topk_int8_scan(
                self.rows[:n_scan], self.scales[:n_scan], penalty, qt, k)
        else:
            penalty = torch.where(live, 0.0, float("inf"))
            scores, ids = flat_topk_scan(self.rows[:n_scan], penalty, qt, k)
        scores = scores.cpu().numpy()
        out_ids = ids.cpu().numpy().astype(np.int64)
        out_ids[~np.isfinite(scores)] = -1
        return scores, out_ids

    def compact(self, keep_ids: np.ndarray) -> None:
        """Re-key after the owning index renumbered: new id ``n`` is old id
        ``keep_ids[n]`` (sorted surviving old ids)."""
        keep_ids = np.asarray(keep_ids, np.int64)
        if self.rows is None or self.count == 0 or keep_ids.size == 0:
            self.clear()
            return
        n = int(keep_ids.size)
        new_cap = _round_capacity(n)
        sel = torch.from_numpy(
            np.clip(keep_ids, 0, self.capacity - 1)).to(self.device)
        rows = torch.zeros((new_cap, self.dim), dtype=self.rows.dtype,
                           device=self.device)
        rows[:n] = self.rows[sel]
        self.rows = rows
        if self.scales is not None:
            scales = torch.zeros((new_cap,), dtype=torch.float32,
                                 device=self.device)
            scales[:n] = self.scales[sel]
            self.scales = scales
        self.capacity = new_cap
        self.count = n

    def clear(self) -> None:
        self.rows = None
        self.scales = None
        self.capacity = 0
        self.count = 0

    # -- persistence (TPUSIDX2 sections) --------------------------------------

    def sections(self) -> list:
        from .serialize import tensor_section

        out = [tensor_section("refine_rows", self.dtype, self.rows, self.count)]
        if self.dtype == "int8":
            out.append(tensor_section("refine_scales", "float32", self.scales,
                                      self.count))
        return out

    @classmethod
    def from_arrays(
        cls,
        dim: int,
        dtype: str,
        arrays: dict,
        device: Optional[torch.device] = None,
        count: Optional[int] = None,
    ) -> "RefineStore":
        """Rebuild from memory-mapped sections (chunked uploads)."""
        from .serialize import upload_rows

        store = cls(dim, dtype=dtype, device=device)
        rows = arrays.get("refine_rows")
        n = int(rows.shape[0]) if rows is not None else 0
        if count is not None:
            n = min(n, count)
        if n == 0:
            return store
        cap = _round_capacity(n)
        store.rows = upload_rows(rows[:n], dtype, cap, store.device)
        if dtype == "int8":
            store.scales = upload_rows(arrays["refine_scales"][:n], "float32",
                                       cap, store.device)
        store.capacity = cap
        store.count = n
        return store
