"""Device-resident exact vector index (``FlatIndex`` of the port).

Counterpart of ``tpu_search/index/flat.py``:

- vectors live in one tensor on the index's device; capacity grows by
  doubling (min 1024), appends write in place.  Storage dtypes:
  ``float32`` / ``bfloat16`` rows ``[capacity, D]``; ``int8`` rows
  ``[capacity, D]`` with per-row f32 scales; ``int4`` nibble-pair byte
  rows ``[capacity/2, D]`` uint8 (``ops.int4_pack``, the TPUSIDX2 layout)
  with per-row f32 scales.  The JAX package packs int8/int4 into int32
  words for the TPU's DMA engine; the port keeps the plain layouts.
  int8/int4 score the ``ip`` metric only;
- rows quantize on add, to the bits the JAX index stores (its host and
  device quantizers agree bit for bit, and so does this one);
- deletion is a tombstone in a ``[capacity]`` validity mask, and
  ``compact()`` rebuilds contiguously (quantized rows dequantize and
  re-add, as in the JAX package) and returns the old -> new id map;
- search folds validity and the metadata predicate into one f32 penalty
  stream (for float l2 also the ``|v|^2`` correction; for int8/int4 0 or
  ``-inf``), cached per predicate digest until the next mutation, and runs
  the exact top-k scan of the storage dtype (``ops.flat_topk*``: the CUDA
  kernels on the card, their plain versions on the CPU), any k;
- ``make_scan_fn`` / ``scan_staged`` hand the fused query path
  (``api/fused.py``) the same scan as a function over device tensors,
  over the whole capacity, so a CUDA graph built on it stays valid across
  adds and removes;
- ``save``/``load`` speak TPUSIDX2, so both packages read each other's
  files.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..ops.flat_topk import flat_topk_scan
from ..ops.flat_topk_int4 import flat_topk_int4_scan
from ..ops.flat_topk_int8 import flat_topk_int8_scan
from ..ops.int4_pack import (
    NIBBLE_BIAS,
    bytes_to_nibble_rows,
    nibble_rows_to_bytes,
    quantize_rows_int4,
)
from ..ops.topk_scan import INV127, absmax_scales, row_penalty, row_sq_norms
from ..utils.shapes import next_pow2, round_up

__all__ = ["FlatIndex", "flat_scan", "quantize_rows_int8"]

_MIN_CAPACITY = 1024
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANTIZED = ("int8", "int4")


def quantize_rows_int8(vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``v ~ q * scale``, ``scale = max|v| *
    f32(1/127)`` (floor 1e-12), ``q = rint(v / scale)``.  The JAX index's
    ``_quantize_rows`` and ``_append_device_int8`` bit for bit, on any
    device (one f32 multiply and a tensor-by-tensor division)."""
    v = vectors.float()
    scales = absmax_scales(v, INV127)
    return torch.round(v / scales[:, None]).to(torch.int8), scales


def flat_scan(scan_key: tuple, buffers: tuple, staged: tuple,
              queries: torch.Tensor, k: int, rows: Optional[int] = None):
    """The exact top-k scan of :meth:`FlatIndex.make_scan_fn`: ``buffers``
    ``(vectors, scales)``, ``staged`` ``(penalty,)``, ``queries [Q, D]``
    f32 on the index's device; the first ``rows`` slots (default all).
    ``(scores [Q, k] f32, ids [Q, k] int32)`` on the device."""
    _, dtype, metric = scan_key
    vectors, scales = buffers
    (penalty,) = staged
    n = penalty.shape[0] if rows is None else rows
    if dtype == "int8":
        return flat_topk_int8_scan(vectors[:n], scales[:n], penalty[:n],
                                   queries, k)
    if dtype == "int4":
        return flat_topk_int4_scan(vectors[: (n + 1) // 2], scales[:n],
                                   penalty[:n], queries, k)
    return flat_topk_scan(vectors[:n], penalty[:n], queries, k,
                          2.0 if metric == "l2" else 1.0)


class FlatIndex:
    """Exact-scan vector index held in device memory."""

    def __init__(
        self,
        dim: int,
        metric: str = "ip",
        dtype: str = "bfloat16",
        device: Optional[torch.device] = None,
    ) -> None:
        if metric not in ("ip", "l2"):
            raise ValueError(f"Unknown metric: {metric}")
        if dtype not in _DTYPES and dtype not in _QUANTIZED:
            raise ValueError(f"Unknown storage dtype: {dtype}")
        if dtype in _QUANTIZED and metric != "ip":
            raise ValueError(f"{dtype} storage supports the 'ip' metric only")
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else (
            resolve_device()
        )
        self._capacity = 0
        self._count = 0
        self._vectors: Optional[torch.Tensor] = None
        self._valid: Optional[torch.Tensor] = None
        self._scales: Optional[torch.Tensor] = None  # int8/int4: [cap] f32
        self._sq_cache: Optional[torch.Tensor] = None
        self._penalty_cache: Dict[Optional[bytes], torch.Tensor] = {}

    def _mutated(self) -> None:
        self._sq_cache = None
        self._penalty_cache.clear()

    # -- size accounting -----------------------------------------------------

    @property
    def ntotal(self) -> int:
        """Slots assigned so far (tombstones included)."""
        return self._count

    @property
    def live(self) -> int:
        if self._valid is None or self._count == 0:
            return 0
        return int(self._valid[: self._count].sum())

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- mutation ------------------------------------------------------------

    def _empty_buffers(self, capacity: int):
        """Zeroed ``(vectors, valid, scales)`` for ``capacity`` slots."""
        if self.dtype == "int8":
            shape, dtype = (capacity, self.dim), torch.int8
        elif self.dtype == "int4":
            shape, dtype = (capacity // 2, self.dim), torch.uint8
        else:
            shape, dtype = (capacity, self.dim), _DTYPES[self.dtype]
        vecs = torch.zeros(shape, dtype=dtype, device=self.device)
        valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        scales = None
        if self.dtype in _QUANTIZED:
            scales = torch.ones((capacity,), dtype=torch.float32,
                                device=self.device)
        return vecs, valid, scales

    def _ensure_capacity(self, needed: int) -> None:
        target = max(_MIN_CAPACITY, next_pow2(needed))
        if target <= self._capacity:
            return
        vecs, valid, scales = self._empty_buffers(target)
        if self._vectors is not None:
            vecs[: self._vectors.shape[0]] = self._vectors
            valid[: self._capacity] = self._valid
            if scales is not None:
                scales[: self._capacity] = self._scales
        self._vectors, self._valid, self._scales = vecs, valid, scales
        self._capacity = target

    def _write_nibbles(self, u: torch.Tensor, start: int) -> None:
        """Write ``[n, D]`` biased nibbles at logical slot ``start``: an odd
        start keeps the low nibble of its byte row; an odd end leaves a
        zero high nibble (a slot past the count)."""
        if start % 2:
            u = torch.cat([self._vectors[start // 2][None] & 0x0F, u])
        packed = nibble_rows_to_bytes(u)
        b0 = start // 2
        self._vectors[b0: b0 + packed.shape[0]] = packed

    def add(
        self, vectors: Union[np.ndarray, torch.Tensor], n: Optional[int] = None
    ) -> np.ndarray:
        """Append rows; returns the assigned int64 slot ids.  A tensor
        already on the index's device appends without a host round trip;
        ``n`` is its live row count when it carries padding rows."""
        if isinstance(vectors, torch.Tensor):
            batch = vectors.detach()
        else:
            batch = torch.from_numpy(np.asarray(vectors, dtype=np.float32))
        if batch.dim() == 1:
            batch = batch[None, :]
        if n is None:
            n = batch.shape[0]
        elif n > batch.shape[0]:
            raise ValueError(f"live count {n} > padded rows {batch.shape[0]}")
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        if batch.shape[1] != self.dim:
            raise ValueError(f"Expected dim {self.dim}, got {batch.shape[1]}")
        self._ensure_capacity(self._count + n)
        start = self._count
        rows = batch[:n].to(device=self.device, dtype=torch.float32)
        if self.dtype == "int8":
            q, scales = quantize_rows_int8(rows)
            self._vectors[start: start + n] = q
            self._scales[start: start + n] = scales
        elif self.dtype == "int4":
            u, scales = quantize_rows_int4(rows)
            self._write_nibbles(u, start)
            self._scales[start: start + n] = scales
        else:
            self._vectors[start: start + n] = rows.to(_DTYPES[self.dtype])
        self._valid[start: start + n] = True
        self._count += n
        self._mutated()
        return np.arange(start, start + n, dtype=np.int64)

    def remove(self, ids: Iterable[int]) -> int:
        """Tombstone the given slot ids; returns how many were live."""
        ids = np.asarray(list(ids), dtype=np.int64)
        ids = ids[(ids >= 0) & (ids < self._count)]
        if ids.size == 0 or self._valid is None:
            return 0
        idx = torch.from_numpy(np.unique(ids)).to(self.device)
        n_live = int(self._valid[idx].sum())
        self._valid[idx] = False
        self._mutated()
        return n_live

    def _rows_f32(self) -> torch.Tensor:
        """The first ``count`` rows as f32 (dequantized for int8/int4)."""
        count = self._count
        if self.dtype == "int8":
            q = self._vectors[:count].float()
        elif self.dtype == "int4":
            nib = bytes_to_nibble_rows(self._vectors[: (count + 1) // 2])
            q = nib[:count].float() - NIBBLE_BIAS
        else:
            return self._vectors[:count].float()
        return q * self._scales[:count, None]

    def compact(self) -> Dict[int, int]:
        """Drop tombstones, renumber contiguously; returns old -> new."""
        if self._count == 0:
            return {}
        keep = torch.nonzero(self._valid[: self._count]).flatten()
        kept = self._rows_f32()[keep]
        mapping = {int(old): new for new, old in enumerate(keep.tolist())}
        self.clear()
        if kept.shape[0]:
            self.add(kept)
        return mapping

    def clear(self) -> None:
        self._capacity = 0
        self._count = 0
        self._vectors = None
        self._valid = None
        self._scales = None
        self._mutated()

    # -- search ----------------------------------------------------------------

    def _penalty(self, mask: Optional[np.ndarray]) -> torch.Tensor:
        """Cached ``[capacity]`` penalty for validity & predicate."""
        key = None
        if mask is not None:
            mask = np.asarray(mask, dtype=np.bool_)
            key = hashlib.blake2b(mask.tobytes(), digest_size=16).digest()
        cached = self._penalty_cache.get(key)
        if cached is not None:
            return cached
        full = self._valid
        if mask is not None:
            padded = np.zeros((self._capacity,), dtype=np.bool_)
            take = min(mask.shape[0], self._capacity)
            padded[:take] = mask[:take]
            full = full & torch.from_numpy(padded).to(self.device)
        if self.dtype in _QUANTIZED:
            # Added, as the TPU kernels' aux stream: 0 live, -inf masked.
            penalty = torch.where(full, 0.0, float("-inf"))
        else:
            if self.metric == "l2" and self._sq_cache is None:
                self._sq_cache = row_sq_norms(self._vectors)
            penalty, _ = row_penalty(full, self.metric, self._sq_cache)
        if len(self._penalty_cache) >= 8:  # FIFO bound
            self._penalty_cache.pop(next(iter(self._penalty_cache)))
        self._penalty_cache[key] = penalty
        return penalty

    def search(
        self,
        queries: np.ndarray,
        k: int,
        mask: Optional[np.ndarray] = None,
        nprobe: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k with an optional predicate mask over slot ids
        (``nprobe``, the IVF knob, is accepted and ignored).

        Returns ``(scores [Q, k] f32, ids [Q, k] int64)``; unmatched slots
        score ``-inf`` with id ``-1``."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        q = queries.shape[0]
        if self._count == 0 or k <= 0:
            shape = (q, max(k, 0))
            return (np.full(shape, -np.inf, dtype=np.float32),
                    np.full(shape, -1, dtype=np.int64))
        k_eff = min(k, self._capacity)
        # Rows past the assigned slots are dead: scan only what is needed.
        n_scan = min(self._capacity, max(round_up(self._count, 128), k_eff))
        qt = torch.from_numpy(queries).to(self.device)
        scan_key, buffers = self.make_scan_fn()
        scores, ids = flat_scan(scan_key, buffers, self.scan_staged(mask),
                                qt, k_eff, n_scan)
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            scores = np.pad(scores, pad, constant_values=-np.inf)
            ids = np.pad(ids, pad, constant_values=-1)
        return scores, ids

    # -- the fused query path ------------------------------------------------

    def make_scan_fn(self) -> Tuple[tuple, tuple]:
        """``(scan_key, buffers)`` for :func:`flat_scan`, the fused query
        path's scan: ``buffers`` are the tensors it reads in place (a
        program built on them is valid until they move: growth, compact,
        clear), the penalty changes between calls (:meth:`scan_staged`).
        The fused path scans the whole capacity (dead slots carry the
        penalty), so an add or a remove needs no new program."""
        return ("flat", self.dtype, self.metric), (self._vectors, self._scales)

    def scan_staged(self, mask: Optional[np.ndarray] = None) -> tuple:
        """``(penalty [capacity] f32,)`` of validity & the predicate
        ``mask`` (cached per mask until the next mutation)."""
        return (self._penalty(mask),)

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """Write a TPUSIDX2 file: vectors in their storage dtype (int8 rows;
        int4 as ``[ceil(count/2), D]`` nibble-pair bytes), the validity
        mask, and for int8/int4 the per-row scales."""
        from .serialize import tensor_section, write_file

        header = {
            "kind": "flat",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype,
            "count": self._count,
        }
        count = self._count
        if self.dtype == "int4":
            rows = (count + 1) // 2
            vectors = tensor_section("vectors", "uint8", self._vectors, rows)
            if not rows:  # the JAX package's empty int4 section shape
                vectors = ("vectors", "uint8", (0, self.dim), iter(()))
        else:
            vectors = tensor_section("vectors", self.dtype, self._vectors, count)
        valid = None if self._valid is None else self._valid.to(torch.uint8)
        sections = [vectors, tensor_section("valid", "uint8", valid, count)]
        if self.dtype in _QUANTIZED:
            sections.append(
                tensor_section("scales", "float32", self._scales, count))
        write_file(path, header, sections)

    @classmethod
    def load(
        cls, path: str, device: Optional[torch.device] = None
    ) -> "FlatIndex":
        from .serialize import is_streamed_file, read_file, upload_rows

        if not is_streamed_file(path):
            raise NotImplementedError(
                f"{path} is not a TPUSIDX2 file; the round-1 npz format is "
                f"not ported"
            )
        header, arrays = read_file(path)
        if header.get("kind", "flat") != "flat":
            raise ValueError(
                f"{path} holds a {header.get('kind')!r} index "
                f"(index.registry.load_index reads every kind)"
            )
        index = cls(dim=header["dim"], metric=header["metric"],
                    dtype=header["dtype"], device=device)
        count = header["count"]
        if not count:
            return index
        # The JAX package's alignment: capacity-align, no power-of-two
        # round-up for large corpora.
        align = 65536 if count >= 65536 else _MIN_CAPACITY
        capacity = max(_MIN_CAPACITY, round_up(count, align))
        if index.dtype == "int4":
            index._vectors = upload_rows(
                arrays["vectors"], "uint8", capacity // 2, index.device)
        else:
            index._vectors = upload_rows(
                arrays["vectors"], index.dtype, capacity, index.device)
        valid = np.zeros((capacity,), dtype=np.bool_)
        valid[:count] = np.asarray(arrays["valid"]).astype(np.bool_)
        index._valid = torch.from_numpy(valid).to(index.device)
        if index.dtype in _QUANTIZED:
            scales = np.ones((capacity,), dtype=np.float32)
            scales[:count] = arrays["scales"]
            index._scales = torch.from_numpy(scales).to(index.device)
        index._capacity = capacity
        index._count = count
        return index
