"""Device-resident exact vector index (``FlatIndex`` of the port).

Counterpart of ``tpu_search/index/flat.py``:

- vectors live in one tensor on the index's device; capacity grows by
  doubling (min 1024), appends write in place.  Storage dtypes:
  ``float32`` / ``bfloat16`` rows ``[capacity, D]``; ``int8`` as the JAX
  package holds it, ``[capacity/4, D]`` int32 words (``ops.int8_pack``:
  4 rows a word), with per-row f32 scales; ``int4`` nibble-pair byte
  rows ``[capacity/2, D]`` uint8 (``ops.int4_pack``, the TPUSIDX2 layout)
  with per-row f32 scales.  int8/int4 score the ``ip`` metric only;
- rows quantize on add, to the bits the JAX index stores (its host and
  device quantizers agree bit for bit, and so does this one);
- deletion is a tombstone in a ``[capacity]`` validity mask, and
  ``compact()`` rebuilds contiguously (quantized rows dequantize and
  re-add, as in the JAX package) and returns the old -> new id map;
- search folds validity and the metadata predicate into one f32 penalty
  stream (for float l2 also the ``|v|^2`` correction; for int8/int4 0 or
  ``-inf``), cached per predicate digest until the next mutation, and runs
  the exact top-k scan of the storage dtype (``ops.flat_topk*``: the CUDA
  kernels on the card, their plain versions on the CPU; int8 the word
  entry of ``flat_topk_int8.cu``), any k;
- ``make_scan_fn`` / ``scan_staged`` hand the fused query path
  (``api/fused.py``) the same scan as a function over device tensors,
  over the whole capacity, so a CUDA graph built on it stays valid across
  adds and removes;
- ``save``/``load`` speak TPUSIDX2, so both packages read each other's
  files;
- ``from_device_vectors`` builds an index around rows already on a
  device (the bulk-build path), with the JAX package's capacity (aligned
  to 65,536 rows from N = 65,536 up, not a power of two) and the bits
  JAX stores in its live slots: float rows cast, float rows quantized
  65,536 at a time, pre-quantized int8 rows with their scales, or
  ``[N/4, D]`` int32 words, taken as they are where N fills the capacity.
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
from ..ops.int8_pack import pack_int8_rows, unpack_int8_rows
from ..ops.topk_scan import INV127, absmax_scales, row_penalty, row_sq_norms
from ..utils.shapes import cdiv, next_pow2, round_up

__all__ = ["FlatIndex", "adoption_capacity", "dequantize_rows", "flat_scan",
           "quantize_rows_int8", "read_int8_rows", "write_int8_rows",
           "write_nibbles"]

_MIN_CAPACITY = 1024
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANTIZED = ("int8", "int4")
# Rows the bulk build and a load move (and quantize) a step: per-row
# quantization, so the steps change no bit, and peak device memory is the
# source, the output and one step's f32 transients.
_BULK_STEP = 1 << 16
# Word rows unpacked a step on their way to the host (64 MiB at D 768).
_WORD_STEP = 1 << 14


def adoption_capacity(n: int) -> int:
    """The JAX package's capacity for ``n`` rows built or loaded in bulk:
    a multiple of 65,536 from 65,536 rows up (the scan tiles), of 1,024
    below, never a power-of-two round-up."""
    align = 65536 if n >= 65536 else _MIN_CAPACITY
    return max(_MIN_CAPACITY, round_up(n, align))


def quantize_rows_int8(vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``v ~ q * scale``, ``scale = max|v| *
    f32(1/127)`` (floor 1e-12), ``q = rint(v / scale)``.  The JAX index's
    ``_quantize_rows`` and ``_append_device_int8`` bit for bit, on any
    device (one f32 multiply and a tensor-by-tensor division)."""
    v = vectors.float()
    scales = absmax_scales(v, INV127)
    return torch.round(v / scales[:, None]).to(torch.int8), scales


def write_int8_rows(words: torch.Tensor, codes: torch.Tensor,
                    start: int) -> None:
    """Write ``[n, D]`` int8 ``codes`` into the ``[C, D]`` int32 words at
    row ``start``: a word the rows fill only in part keeps its other
    rows."""
    n = codes.shape[0]
    if not n:
        return
    lo, hi = start // 4, cdiv(start + n, 4)
    if start % 4 or n % 4:
        rows = unpack_int8_rows(words[lo:hi]).clone(  # may be a view
            memory_format=torch.contiguous_format)
        rows[start - 4 * lo: start - 4 * lo + n] = codes
        codes = rows
    words[lo:hi] = pack_int8_rows(codes)


def read_int8_rows(words: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows ``[a, b)`` of the ``[C, D]`` int32 words as ``[b - a, D]``
    int8."""
    rows = unpack_int8_rows(words[a // 4: cdiv(b, 4)])
    return rows[a % 4: a % 4 + b - a]


def write_nibbles(buf: torch.Tensor, u: torch.Tensor, start: int) -> None:
    """Write ``[n, D]`` biased nibbles into the nibble-pair bytes ``buf``
    at logical row ``start``: an odd start keeps the low nibble of its
    byte row; an odd end writes a zero high nibble (the row past them)."""
    if start % 2:
        u = torch.cat([buf[start // 2][None] & 0x0F, u])
    packed = nibble_rows_to_bytes(u)
    b0 = start // 2
    buf[b0: b0 + packed.shape[0]] = packed


def _bulk_into(buf: torch.Tensor, scales: Optional[torch.Tensor],
               rows, dtype: str) -> None:
    """Rows ``[n, D]`` (a tensor on any device with any strides, or a host
    array) into ``buf`` (and ``scales``) at slots ``[0, n)`` on ``buf``'s
    device, ``_BULK_STEP`` rows a step: float rows cast or quantized to
    ``dtype``; int8 rows (pre-quantized codes) packed into the words."""
    for a in range(0, rows.shape[0], _BULK_STEP):
        blk = rows[a: a + _BULK_STEP]
        if isinstance(blk, np.ndarray):
            blk = torch.from_numpy(np.array(blk))
        blk = blk.to(buf.device)
        if blk.dtype == torch.int8:
            write_int8_rows(buf, blk, a)
            continue
        if dtype == "int8":
            q, s = quantize_rows_int8(blk)
            write_int8_rows(buf, q, a)
        elif dtype == "int4":
            u, s = quantize_rows_int4(blk)
            write_nibbles(buf, u, a)
        else:
            buf[a: a + blk.shape[0]] = blk
            continue
        scales[a: a + s.shape[0]] = s


def _word_row_chunks(words: torch.Tensor, count: int):
    """The first ``count`` int8 rows of ``[C, D]`` words as host chunks,
    unpacked on their device ``_WORD_STEP`` word rows at a time (the JAX
    package's ``iter_packed_int8_rows``)."""
    from .serialize import _to_numpy

    for a in range(0, count, 4 * _WORD_STEP):
        yield _to_numpy(read_int8_rows(words, a, min(a + 4 * _WORD_STEP,
                                                     count)))


def dequantize_rows(dtype: str, stored: torch.Tensor,
                    scales: Optional[torch.Tensor], rows: int) -> torch.Tensor:
    """The first ``rows`` rows of ``stored``, in ``dtype``'s layout (int8
    rows, int4 nibble-pair bytes, bf16 / f32 rows), as f32; int8 / int4
    times their per-row ``scales``: the JAX package's f32 products, bit for
    bit."""
    if dtype == "int8":
        q = stored[:rows].float()
    elif dtype == "int4":
        nib = bytes_to_nibble_rows(stored[: (rows + 1) // 2])
        q = nib[:rows].float() - NIBBLE_BIAS
    else:
        return stored[:rows].float()
    return q * scales[:rows, None]


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
        n = round_up(n, 4)  # whole words (the capacity is a multiple of 4)
        return flat_topk_int8_scan(vectors[: n // 4], scales[:n],
                                   penalty[:n], queries, k, words=True)
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
            shape, dtype = (capacity // 4, self.dim), torch.int32
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
        self._mutated()  # cached penalties have the old capacity

    def _write_nibbles(self, u: torch.Tensor, start: int) -> None:
        """:func:`write_nibbles` into this index's bytes."""
        write_nibbles(self._vectors, u, start)

    # -- bulk build ------------------------------------------------------------

    @classmethod
    def from_device_vectors(
        cls,
        vectors: torch.Tensor,
        metric: str = "ip",
        dtype: str = "bfloat16",
        scales: Optional[torch.Tensor] = None,
        packed: bool = False,
    ) -> "FlatIndex":
        """An index around ``[N, D]`` rows already on a device (its
        device), with no host round trip: the JAX package's contract, its
        errors, capacity (:func:`adoption_capacity`) and the bits it
        stores in the live slots.

        - float rows with ``dtype`` float32 / bfloat16 are cast (no copy
          beyond the cast where N fills the capacity);
        - float rows with ``dtype`` int8 / int4 are quantized 65,536 rows
          a step into the stored layout (peak device memory: the source,
          the output and one step);
        - int8 rows with their per-row ``scales`` (``dtype="int8"``, N % 4
          == 0) are packed into the words;
        - ``packed=True``: ``vectors`` is the ``ops.int8_pack`` ``[N/4,
          D]`` int32 word layout, with ``scales``; where N fills the
          capacity the words themselves become the index's buffer (no
          copy), else they are copied into it."""
        if packed:
            if dtype != "int8" or scales is None:
                raise ValueError(
                    "packed adoption needs dtype='int8' and per-row scales")
            if vectors.dtype != torch.int32:
                raise ValueError("packed adoption takes [N/4, D] int32 words")
            n, d = int(vectors.shape[0]) * 4, int(vectors.shape[1])
        else:
            n, d = (int(s) for s in vectors.shape)
        index = cls(d, metric=metric, dtype=dtype, device=vectors.device)
        capacity = adoption_capacity(n)
        if packed or vectors.dtype == torch.int8:
            if dtype != "int8" or scales is None:
                raise ValueError(
                    "int8 vectors need dtype='int8' and per-row scales")
            if n % 4:
                raise ValueError(
                    "pre-quantized int8 adoption requires N % 4 == 0 "
                    "(int8 corpora are stored word-packed)")
            index._adopt_codes(vectors, scales, n, capacity, packed)
        elif scales is not None:
            raise ValueError("scales only apply to int8 vectors")
        else:
            index._adopt_rows(vectors, capacity)
        return index

    def _adopt_rows(self, rows: torch.Tensor, capacity: int) -> None:
        """Hold ``rows [n, D]`` (float; any device, any strides) in this
        empty index, cast or quantized to its dtype, ``capacity`` slots."""
        n = rows.shape[0]
        if (self.dtype in _DTYPES and capacity == n
                and rows.device == self.device):
            # the cast (where one is needed) is the only copy
            vecs = rows.to(_DTYPES[self.dtype]).contiguous()
            scales = None
        else:
            vecs, _, scales = self._empty_buffers(capacity)
            _bulk_into(vecs, scales, rows, self.dtype)
            if self.dtype == "int4" and n % 2:
                # The JAX package's bulk build quantizes its zero padding,
                # and a save writes the byte that the row past an odd
                # count shares: that row holds nibble 8 (code 0).
                vecs[n // 2] |= NIBBLE_BIAS << 4
        self._held(vecs, scales, n, capacity)

    def _adopt_codes(self, codes: torch.Tensor, scales: torch.Tensor,
                     n: int, capacity: int, words: bool) -> None:
        """Hold ``n`` pre-quantized int8 rows (``[n, D]`` int8, or with
        ``words`` ``[n/4, D]`` int32 words) and their scales: the words as
        they are where ``n`` fills ``capacity``, else copied (rows
        packed) into the index's words."""
        sc = scales.to(device=self.device, dtype=torch.float32)
        if words and capacity == n and codes.device == self.device:
            self._held(codes.contiguous(), sc.contiguous(), n, capacity)
            return
        vecs, _, padded = self._empty_buffers(capacity)
        if words:
            vecs[: n // 4] = codes
        else:
            _bulk_into(vecs, None, codes, "int8")
        padded[:n] = sc
        self._held(vecs, padded, n, capacity)

    def _held(self, vecs: torch.Tensor, scales: Optional[torch.Tensor],
              n: int, capacity: int) -> None:
        """Take ``vecs`` / ``scales`` as the buffers of ``n`` live rows."""
        self._vectors, self._scales = vecs, scales
        self._valid = torch.zeros((capacity,), dtype=torch.bool,
                                  device=self.device)
        self._valid[:n] = True
        self._capacity = capacity
        self._count = n
        self._mutated()

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
            write_int8_rows(self._vectors, q, start)
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

    def _rows_f32(self, a: int = 0, b: Optional[int] = None) -> torch.Tensor:
        """Slots ``[a, b)`` (default: the first ``count``) as f32,
        dequantized for int8/int4; ``a`` even."""
        b = self._count if b is None else b
        if self.dtype == "int8":
            stored = read_int8_rows(self._vectors, a, b)
        elif self.dtype == "int4":
            stored = self._vectors[a // 2:]
        else:
            stored = self._vectors[a:]
        return dequantize_rows(
            self.dtype, stored,
            None if self._scales is None else self._scales[a:], b - a)

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
        """Write a TPUSIDX2 file: vectors in their storage dtype (int8 rows,
        unpacked from the words a chunk at a time; int4 as ``[ceil(count/2), D]`` nibble-pair bytes), the validity
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
        elif self.dtype == "int8" and count:
            vectors = ("vectors", "int8", (count, self.dim),
                       _word_row_chunks(self._vectors, count))
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
            return cls._load_legacy_npz(path, device=device)
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
        capacity = adoption_capacity(count)
        if index.dtype == "int4":
            index._vectors = upload_rows(
                arrays["vectors"], "uint8", capacity // 2, index.device)
        elif index.dtype == "int8":
            index._vectors = index._empty_buffers(capacity)[0]
            _bulk_into(index._vectors, None, arrays["vectors"], "int8")
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

    @classmethod
    def _load_legacy_npz(
        cls, path: str, device: Optional[torch.device] = None
    ) -> "FlatIndex":
        """The round-1 npz format (``header`` JSON, f32 ``vectors``,
        ``valid``), kept for old data directories: its rows re-add through
        this index's quantizers, which store the JAX package's bits."""
        import json

        with np.load(path, allow_pickle=False) as data:
            header = json.loads(str(data["header"]))
            vectors = np.asarray(data["vectors"], dtype=np.float32)
            valid = np.asarray(data["valid"]).astype(np.bool_)
        index = cls(dim=header["dim"], metric=header["metric"],
                    dtype=header["dtype"], device=device)
        count = header["count"]
        if count:
            index.add(vectors[:count])
            index._valid[:count] = torch.from_numpy(valid[:count]).to(
                index.device)
            index._mutated()
        return index
