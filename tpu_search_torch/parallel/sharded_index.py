"""Exact index sharded over the ``data`` axis of a mesh: a scan per shard,
one merge.

Counterpart of ``tpu_search/parallel/sharded_index.py``'s
``ShardedFlatIndex``.

- Placement is round-robin: global id ``g`` lives on shard ``g % S`` at
  local slot ``g // S``, so appends stay balanced, global ids are stable
  under growth, and a predicate mask over global ids becomes each shard's
  mask with one reshape (``padded.reshape(local_cap, S).T``).
- Every shard has the same local capacity: at least 1,024 slots, grown to
  ``next_pow2(ceil(count / S) + margin)`` (margin 8 for int8, 16 for int4,
  the JAX package's packed-write room), so the two packages size a shard
  alike and ``k_eff = min(k, local_capacity)`` agrees.
- Each shard is one port ``FlatIndex`` on its mesh device: rows in the
  port's layouts (int8 rows, int4 nibble-pair bytes) with their scales,
  the validity mask and the f32 penalty stream.  Its scan is
  ``index.flat.flat_scan``: ``flat_topk.cu``, ``flat_topk_int8.cu`` or
  ``flat_topk_int4.cu`` on the card, their plain versions on the CPU.
- The merge is ``lax.top_k`` over the shard-major concatenation
  ``[Q, S * k]``: each shard's ``[Q, k]`` moves to the merge device (the
  first local shard's), a stable descending sort keeps the first ``k``, so
  a tie goes to the lower position (the lower shard, then the lower
  slot), as XLA's TopK orders it, and the winners' local ids become
  global ids.
- Over several processes (a process group as wide as the mesh), each
  process scans its own shards and the ranks' ``[S_local, Q, k]`` results
  meet in one ``all_gather`` before that merge, so the tie order is the
  one-process order.  A one-rank group gathers too.
- ``device_mask`` folds validity and the predicate into each shard's
  penalty: the shard's own ``FlatIndex._penalty``, cached per digest of
  its slice of the mask (FIFO of 8) and cleared by every write to the
  shard (growth included), read under one lock (the warm server
  dispatches and collects on several threads).
- Each shard's scan runs with the shard's card current: a wrapper
  launches on that device's stream, and sets its kernels' shared-memory
  attributes on the current device.
- ``save``/``load`` speak TPUSIDX2 in global-id order, streamed 8,192
  local slots at a time, so a sharded save loads in either package's
  ``FlatIndex`` or ``ShardedFlatIndex`` and the reverse; ``dtype=``
  converts between tiers on load.  With more than one process, each
  writes ``<path>.host<p>`` with its own shards in the JAX package's
  device layout (int8 and int4 as int32 words) and process 0 a
  ``flat_shards_manifest`` at ``path``; the save ends on a barrier.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..index.flat import FlatIndex, dequantize_rows, flat_scan
from ..index.serialize import _to_numpy as _host
from ..index.serialize import (
    is_streamed_file,
    read_file,
    upload_rows,
    write_file,
)
from ..ops.int4_pack import (
    bytes_to_nibble_rows,
    bytes_to_words_host,
    nibble_rows_to_disk_bytes,
    words_to_bytes_host,
)
from ..ops.int8_pack import pack_int8_rows_host, unpack_int8_rows_host
from ..utils.shapes import cdiv, next_pow2, round_up
from .distributed import process_count, process_index
from .mesh import Mesh

__all__ = ["ShardedFlatIndex", "merge_shards", "sharded_scan"]

_MIN_LOCAL_CAPACITY = 1024
_DTYPES = ("bfloat16", "float32", "int4", "int8")
_QUANTIZED = ("int8", "int4")
# Spare local slots the JAX package's packed int8 / int4 appends need.
_MARGIN = {"int8": 8, "int4": 16}
# Local slots a shard streams per step (save, load, compact).
_IO_CHUNK_SLOTS = 8192


def _gathers(mesh: Mesh) -> bool:
    """Whether a search gathers across a process group as wide as the
    mesh (a one-rank group included)."""
    return dist.is_initialized() and dist.get_world_size() == mesh.processes


def _current(device: torch.device):
    """Makes a CUDA ``device`` the current one for the block (a no-op on
    the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def colocated(mesh: Mesh, shards: Iterable[int],
              device: torch.device) -> bool:
    """Whether ``shards`` are every shard of ``mesh``, held in this process
    on ``device`` (``cuda`` is the current CUDA device): then one program
    (one CUDA graph) can run the encode, every shard's scan and the
    merge."""
    def ordinal(d):
        d = torch.device(d)
        if d.index is None and d.type == "cuda":
            return d.type, torch.cuda.current_device()
        return d.type, d.index or 0

    shards = list(shards)
    return not _gathers(mesh) and len(shards) == mesh.shape["data"] and all(
        ordinal(mesh.shard_device(s)) == ordinal(device) for s in shards)


def merge_shards(scores: List[torch.Tensor], local_ids: List[torch.Tensor],
                 k: int, n_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the shard-major concatenation of each shard's
    ``[Q, k']`` scores (every shard of the mesh, in global shard order, on
    one device): the first ``k`` of a stable descending sort.  A winner's
    shard is its position // k', its global id ``local * n_shards +
    shard`` (-1 where the local id is -1): the JAX program's ids, mapped
    after the selection instead of before it."""
    q, width = scores[0].shape
    top, pos = torch.sort(torch.stack(scores, dim=1).reshape(q, -1), dim=1,
                          descending=True, stable=True)
    pos = pos[:, :k]
    local = torch.stack(local_ids, dim=1).reshape(q, -1).gather(1, pos).long()
    glob = local * n_shards + torch.div(pos, width, rounding_mode="floor")
    return top[:, :k].contiguous(), torch.where(local >= 0, glob, -1)


def sharded_scan(scan_key: tuple, buffers: tuple, staged: tuple,
                 queries: torch.Tensor, k: int, rows: Optional[int] = None):
    """The sharded exact top-k of :meth:`ShardedFlatIndex.make_scan_fn`
    (the port's form of the JAX package's ``sharded_scan_fn_for(scan_key)``
    program, as ``index.flat.flat_scan`` is of ``scan_fn_for``):
    ``buffers`` each local shard's ``(vectors, scales)`` in turn,
    ``staged`` each one's penalty, ``queries [Q, D]`` f32; the first
    ``rows`` local slots of each shard (default all).  ``(scores [Q, k]
    f32, global ids [Q, k] int64)`` on the merge device."""
    _, mesh, dtype, metric, shards, gather = scan_key
    merge_device = buffers[0].device
    scores, ids = [], []
    for i in range(len(shards)):
        vectors, scales = buffers[2 * i], buffers[2 * i + 1]
        with _current(vectors.device):
            s, local = flat_scan(("flat", dtype, metric), (vectors, scales),
                                 (staged[i],), queries.to(vectors.device), k,
                                 rows)
        scores.append(s.to(merge_device))
        ids.append(local.to(merge_device))
    if gather:
        scores, ids = _all_gather(torch.stack(scores), torch.stack(ids))
    return merge_shards(scores, ids, k, mesh.shape["data"])


def _all_gather(scores: torch.Tensor, ids: torch.Tensor):
    """Every rank's ``[S_local, Q, k]`` scores and ids, rank-major: the
    per-shard lists in global shard order."""
    world = dist.get_world_size()
    out_s = [torch.empty_like(scores) for _ in range(world)]
    out_i = [torch.empty_like(ids) for _ in range(world)]
    dist.all_gather(out_s, scores.contiguous())
    dist.all_gather(out_i, ids.contiguous())
    return list(torch.cat(out_s).unbind(0)), list(torch.cat(out_i).unbind(0))


def _interleave(parts: List[np.ndarray]) -> np.ndarray:
    """Per-shard ``[c, ...]`` rows of one slot range -> global order."""
    stacked = np.stack(parts, axis=1)
    return stacked.reshape((-1,) + stacked.shape[2:])


class ShardedFlatIndex:
    """Exact index sharded over the ``data`` axis of a :class:`Mesh`."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        metric: str = "ip",
        dtype: str = "bfloat16",
    ) -> None:
        if metric not in ("ip", "l2"):
            raise ValueError(f"Unknown metric: {metric}")
        if dtype not in _DTYPES:
            raise ValueError(
                f"Unknown storage dtype: {dtype} (supported: {list(_DTYPES)})")
        if dtype in _QUANTIZED and metric != "ip":
            raise ValueError(f"{dtype} storage supports the 'ip' metric only")
        self.dim = dim
        self.mesh = mesh
        self.metric = metric
        self.dtype = dtype
        self.n_shards = mesh.shape["data"]
        self._local_capacity = 0
        self._count = 0  # global slots assigned
        self._lock = threading.Lock()
        self._shards: Dict[int, FlatIndex] = self._empty_shards()

    def _empty_shards(self) -> Dict[int, FlatIndex]:
        return {s: FlatIndex(self.dim, self.metric, self.dtype,
                             device=self.mesh.shard_device(s))
                for s in self.mesh.local_shards()}

    # -- size accounting -----------------------------------------------------

    @property
    def ntotal(self) -> int:
        return self._count

    @property
    def live(self) -> int:
        if self._count == 0:
            return 0
        return self._all_sum(sum(sh.live for sh in self._shards.values()))

    @property
    def capacity(self) -> int:
        return self._local_capacity * self.n_shards

    def _local_count(self, shard: int) -> int:
        """Local slots of ``shard`` below the global count."""
        return max(0, cdiv(self._count - shard, self.n_shards))

    def _merge_device(self) -> torch.device:
        return self.mesh.shard_device(self.mesh.local_shards()[0])

    def _all_sum(self, value: int) -> int:
        if not _gathers(self.mesh):
            return value
        t = torch.tensor([value], dtype=torch.int64,
                         device=self._merge_device())
        dist.all_reduce(t)
        return int(t.item())

    def colocated(self, device: torch.device) -> bool:
        """Whether every shard lies on ``device`` in this process
        (:func:`colocated`)."""
        return colocated(self.mesh, self._shards, device)

    # -- mutation ------------------------------------------------------------

    def _ensure_capacity(self, needed_global: int) -> None:
        """Grow every shard to the one local capacity ``needed_global``
        rows need (a growth moves the buffers: a fused program keyed on
        them is rebuilt)."""
        needed_local = cdiv(needed_global, self.n_shards) + _MARGIN.get(
            self.dtype, 0)
        target = max(_MIN_LOCAL_CAPACITY, next_pow2(needed_local))
        if target <= self._local_capacity:
            return
        for shard in self._shards.values():
            shard._ensure_capacity(target)
        self._local_capacity = target

    def add(
        self, vectors: Union[np.ndarray, torch.Tensor], n: Optional[int] = None
    ) -> np.ndarray:
        """Append rows round-robin across the shards; returns the global
        int64 ids.  A device tensor appends without a host round trip;
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
        for s, shard in self._shards.items():
            rows = batch[(s - start) % self.n_shards: n: self.n_shards]
            if rows.shape[0]:
                shard.add(rows)
        self._count += n
        return np.arange(start, start + n, dtype=np.int64)

    def remove(self, ids: Iterable[int]) -> int:
        """Tombstone the given global ids; returns how many were live."""
        ids = np.asarray(list(ids), dtype=np.int64)
        ids = ids[(ids >= 0) & (ids < self._count)]
        if ids.size == 0 or self._local_capacity == 0:
            return 0
        removed = 0
        for s, shard in self._shards.items():
            mine = ids[ids % self.n_shards == s] // self.n_shards
            if mine.size:
                removed += shard.remove(mine)
        return self._all_sum(removed)

    def compact(self) -> Dict[int, int]:
        """Drop tombstones and renumber global ids contiguously; returns
        the old -> new map.  Streams 8,192 local slots of every shard at a
        time (dequantized, as the JAX package re-adds them) into a fresh
        set of shards."""
        if self._count == 0:
            return {}
        if len(self._shards) != self.n_shards:
            raise ValueError(
                "compact needs every shard in this process; over several "
                "processes each holds only its own")
        fresh = ShardedFlatIndex(self.dim, self.mesh, self.metric, self.dtype)
        device = self._merge_device()
        mapping: Dict[int, int] = {}
        for a, b in self._iter_slot_chunks():
            lo = a * self.n_shards
            hi = min(self._count - lo, (b - a) * self.n_shards)
            shards = [self._shards[s] for s in range(self.n_shards)]
            valid = torch.stack([sh._valid[a:b].to(device) for sh in shards],
                                dim=1).reshape(-1)[:hi]
            rows = torch.stack([sh._rows_f32(a, b).to(device)
                                for sh in shards], dim=1)
            keep = torch.nonzero(valid).flatten()
            kept = rows.reshape(-1, self.dim)[keep]
            for old in (keep + lo).tolist():
                mapping[old] = len(mapping)
            fresh.add(kept)
        self._shards = fresh._shards
        self._local_capacity = fresh._local_capacity
        self._count = fresh._count
        return mapping

    def clear(self) -> None:
        self._local_capacity = 0
        self._count = 0
        self._shards = self._empty_shards()

    # -- bulk adoption ---------------------------------------------------------

    @classmethod
    def from_device_vectors(
        cls,
        vectors: torch.Tensor,
        mesh: Mesh,
        metric: str = "ip",
        dtype: str = "bfloat16",
    ) -> "ShardedFlatIndex":
        """Adopt ``[N, D]`` rows already on a device: each shard takes its
        round-robin rows (cast or quantized to ``dtype``) straight from the
        tensor, with no host round trip."""
        index = cls(dim=int(vectors.shape[1]), mesh=mesh, metric=metric,
                    dtype=dtype)
        index.add(vectors)
        return index

    # -- search ----------------------------------------------------------------

    def device_mask(self, mask: Optional[np.ndarray] = None) -> tuple:
        """Validity & the predicate ``mask`` over global ids as each local
        shard's ``[local_cap]`` f32 penalty (the port's form of the JAX
        package's sharded ``[S, local_cap]`` mask): each shard's
        ``_penalty`` of its stride-S slice, from the shard's cache until
        its next write, read under one lock."""
        if mask is None:
            with self._lock:
                return tuple(sh._penalty(None)
                             for sh in self._shards.values())
        mask = np.asarray(mask, dtype=np.bool_)
        horizon = self.n_shards * self._local_capacity
        padded = np.zeros((horizon,), dtype=np.bool_)
        padded[: min(mask.shape[0], horizon)] = mask[:horizon]
        per_shard = padded.reshape(self._local_capacity, self.n_shards).T
        with self._lock:
            return tuple(sh._penalty(per_shard[s])
                         for s, sh in self._shards.items())

    def scan_staged(self, mask: Optional[np.ndarray] = None) -> tuple:
        """The fused path's staged tensors: :meth:`device_mask`."""
        return self.device_mask(mask)

    def make_scan_fn(self) -> Tuple[tuple, tuple]:
        """``(scan_key, buffers)`` for :func:`sharded_scan`: the key
        carries the mesh, the local shards and whether the ranks' results
        are gathered; ``buffers`` are each local shard's ``(vectors,
        scales)``, read in place until a growth, compact or clear moves
        them."""
        key = ("sharded_flat", self.mesh, self.dtype, self.metric,
               tuple(self._shards), _gathers(self.mesh))
        buffers = tuple(t for sh in self._shards.values()
                        for t in (sh._vectors, sh._scales))
        return key, buffers

    def search(
        self,
        queries: np.ndarray,
        k: int,
        mask: Optional[np.ndarray] = None,
        nprobe: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Replicated queries -> a scan per shard -> one merge.  Returns
        ``(scores [Q, k] f32, ids [Q, k] int64)``; unmatched slots score
        ``-inf`` with id ``-1`` (``nprobe`` is accepted and ignored)."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        q = queries.shape[0]
        if self._count == 0 or k <= 0:
            shape = (q, max(k, 0))
            return (np.full(shape, -np.inf, dtype=np.float32),
                    np.full(shape, -1, dtype=np.int64))
        k_eff = min(k, self._local_capacity)
        # Slots past every shard's assigned ones are dead: scan only those.
        rows = min(self._local_capacity,
                   max(round_up(self._local_count(0), 128), k_eff))
        scan_key, buffers = self.make_scan_fn()
        qt = torch.from_numpy(queries).to(self._merge_device())
        scores, ids = sharded_scan(scan_key, buffers, self.device_mask(mask),
                                   qt, k_eff, rows)
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy()
        ids[~np.isfinite(scores)] = -1
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            scores = np.pad(scores, pad, constant_values=-np.inf)
            ids = np.pad(ids, pad, constant_values=-1)
        return scores, ids

    # -- host streaming in global-id order (save) ----------------------------

    def _iter_slot_chunks(self) -> Iterator[Tuple[int, int]]:
        used = self._local_count(0)
        for a in range(0, used, _IO_CHUNK_SLOTS):
            yield a, min(a + _IO_CHUNK_SLOTS, used)

    def _iter_global(self, part) -> Iterator[np.ndarray]:
        """``part(shard, a, b)`` (host rows of local slots ``[a, b)``) of
        every shard, interleaved to global order, chunk by chunk."""
        for a, b in self._iter_slot_chunks():
            out = _interleave([part(self._shards[s], a, b)
                               for s in range(self.n_shards)])
            yield out[: self._count - a * self.n_shards]

    def _codes(self, shard: FlatIndex, a: int, b: int) -> np.ndarray:
        """Host rows in the storage dtype (int4: biased nibble rows)."""
        if self.dtype == "int4":
            nib = bytes_to_nibble_rows(shard._vectors[a // 2: cdiv(b, 2)])
            return _host(nib[: b - a])
        return _host(shard._vectors[a:b])

    def _iter_nibble_bytes(self) -> Iterator[np.ndarray]:
        """Global-order nibble-pair bytes (global rows 2m and 2m + 1 share
        byte row m), an odd chunk's last row carried to the next."""
        carry = None
        for rows in self._iter_global(self._codes):
            if carry is not None:
                rows, carry = np.concatenate([carry, rows]), None
            if rows.shape[0] % 2:
                carry, rows = rows[-1:].copy(), rows[:-1]
            if rows.shape[0]:
                yield nibble_rows_to_disk_bytes(rows)
        if carry is not None:
            yield nibble_rows_to_disk_bytes(carry)

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """Stream a TPUSIDX2 ``flat`` file in global-id order (loadable by
        either package's ``FlatIndex``); with more than one process, the
        per-process files and the manifest instead."""
        if process_count() > 1:
            self._save_per_host(path)
            return
        count = self._count
        header = {"kind": "flat", "dim": self.dim, "metric": self.metric,
                  "dtype": self.dtype, "count": count}
        if self.dtype == "int4":
            vectors = ("vectors", "uint8", ((count + 1) // 2, self.dim),
                       self._iter_nibble_bytes())
        else:
            vectors = ("vectors", self.dtype, (count, self.dim),
                       self._iter_global(self._codes))
        sections = [vectors, ("valid", "uint8", (count,), self._iter_global(
            lambda sh, a, b: _host(sh._valid[a:b])))]
        if self.dtype in _QUANTIZED:
            sections.append(("scales", "float32", (count,), self._iter_global(
                lambda sh, a, b: _host(sh._scales[a:b]))))
        write_file(path, header, sections)

    @staticmethod
    def _host_path(path: str, process: int) -> str:
        return f"{path}.host{process}"

    def _device_layout(self, shard: FlatIndex) -> Iterator[np.ndarray]:
        """A shard's whole capacity in the JAX package's device layout
        (int8: ``[cap/4, D]`` int32 words; int4: ``[cap/8, D]`` words),
        chunk by chunk."""
        for a in range(0, self._local_capacity, _IO_CHUNK_SLOTS):
            b = min(a + _IO_CHUNK_SLOTS, self._local_capacity)
            if self.dtype == "int8":
                yield pack_int8_rows_host(_host(shard._vectors[a:b]))
            elif self.dtype == "int4":
                yield bytes_to_words_host(_host(shard._vectors[a // 2: b // 2]))
            else:
                yield _host(shard._vectors[a:b])

    def _save_per_host(self, path: str) -> None:
        me = process_index()
        owned = list(self._shards)
        cap = self._local_capacity
        base = {"dim": self.dim, "metric": self.metric, "dtype": self.dtype,
                "count": self._count, "n_shards": self.n_shards,
                "local_capacity": cap, "process_count": process_count()}
        rows = {"int8": cap // 4, "int4": cap // 8}.get(self.dtype, cap)
        vec_dtype = "int32" if self.dtype in _QUANTIZED else self.dtype
        sections = []
        for s in owned:
            shard = self._shards[s]
            sections.append((f"vectors{s}", vec_dtype, (rows, self.dim),
                             self._device_layout(shard)))
            sections.append((f"valid{s}", "uint8", (cap,),
                             iter([_host(shard._valid)])))
            if self.dtype in _QUANTIZED:
                sections.append((f"scales{s}", "float32", (cap,),
                                 iter([_host(shard._scales)])))
        write_file(self._host_path(path, me),
                   {**base, "kind": "flat_shards_host", "process": me,
                    "shard_ids": owned}, sections)
        if me == 0:
            write_file(path, {**base, "kind": "flat_shards_manifest"}, [])
        # Every process's file and the manifest exist once save() returns
        # on any process.
        dist.barrier()

    @classmethod
    def _load_per_host(cls, path: str, mesh: Mesh,
                       header: Dict) -> "ShardedFlatIndex":
        index = cls(dim=header["dim"], mesh=mesh, metric=header["metric"],
                    dtype=header["dtype"])
        if header["n_shards"] != index.n_shards:
            raise ValueError(
                f"manifest has {header['n_shards']} shards, mesh has "
                f"{index.n_shards} — per-host loads need the same topology")
        host_header, arrays = read_file(
            cls._host_path(path, process_index()))
        cap = header["local_capacity"]
        index._count = header["count"]
        index._local_capacity = cap
        for s in host_header["shard_ids"]:
            shard = index._shards[s]
            vectors = arrays[f"vectors{s}"]
            if index.dtype == "int8":
                vectors = unpack_int8_rows_host(np.asarray(vectors))
            elif index.dtype == "int4":
                vectors = words_to_bytes_host(np.asarray(vectors))
            dtype = {"int8": "int8", "int4": "uint8"}.get(index.dtype,
                                                           index.dtype)
            shard._vectors = upload_rows(vectors, dtype, vectors.shape[0],
                                         shard.device)
            shard._valid = torch.from_numpy(
                np.asarray(arrays[f"valid{s}"]).astype(np.bool_)).to(
                    shard.device)
            if index.dtype in _QUANTIZED:
                shard._scales = torch.from_numpy(np.array(
                    arrays[f"scales{s}"], dtype=np.float32)).to(shard.device)
            shard._capacity = cap
            shard._count = index._local_count(s)
            shard._mutated()
        return index

    @classmethod
    def load(cls, path: str, mesh: Mesh,
             dtype: Optional[str] = None) -> "ShardedFlatIndex":
        """A TPUSIDX2 ``flat`` file (either package's flat or sharded
        save), a per-process manifest, or a round-1 npz file, sharded over
        ``mesh``; ``dtype`` converts the rows (dequantized, then cast or
        quantized as an add would) where it differs from the file's."""
        if is_streamed_file(path):
            header, arrays = read_file(path)
            if header.get("kind") == "flat_shards_manifest":
                return cls._load_per_host(path, mesh, header)
            if header.get("kind", "flat") != "flat":
                raise ValueError(
                    f"{path} holds a {header.get('kind')!r} index, not a "
                    f"flat one")
            vectors, valid = arrays["vectors"], arrays["valid"]
            scales, src = arrays.get("scales"), header["dtype"]
        else:  # the round-1 npz format: f32 rows, re-added in the dtype
            import json

            with np.load(path, allow_pickle=False) as data:
                header = json.loads(str(data["header"]))
                vectors = np.asarray(data["vectors"], dtype=np.float32)
                valid = np.asarray(data["valid"])
            scales, src = None, "float32"
        index = cls(dim=header["dim"], mesh=mesh, metric=header["metric"],
                    dtype=dtype or header["dtype"])
        count = header["count"]
        if not count:
            return index
        index._ensure_capacity(count)
        S = index.n_shards
        for a in range(0, cdiv(count, S), _IO_CHUNK_SLOTS):
            lo = a * S
            hi = min(count, lo + _IO_CHUNK_SLOTS * S)
            index._load_rows(src, vectors, scales, lo, hi)
            live = torch.from_numpy(np.asarray(valid[lo:hi]).astype(np.bool_))
            for s, shard in index._shards.items():
                mine = live[s::S]
                shard._valid[a: a + mine.shape[0]] = mine.to(shard.device)
        index._count = count
        for shard in index._shards.values():
            shard._mutated()
        return index

    def _load_rows(self, src: str, vectors, scales, lo: int, hi: int) -> None:
        """Global rows ``[lo, hi)`` of a file (``lo`` a multiple of 8,192
        x S) into every local shard, at the shard's next local slots."""
        S = self.n_shards
        if src == "int4":
            stored = torch.from_numpy(np.array(vectors[lo // 2: cdiv(hi, 2)]))
        elif src == "bfloat16":
            stored = torch.from_numpy(
                np.array(vectors[lo:hi]).view(np.int16)).view(torch.bfloat16)
        else:
            stored = torch.from_numpy(np.array(vectors[lo:hi]))
        sc = None if scales is None else torch.from_numpy(
            np.array(scales[lo:hi], dtype=np.float32))
        if src == self.dtype and src in _QUANTIZED:
            # The file's codes and scales as they are (no requantization).
            codes = (bytes_to_nibble_rows(stored)[: hi - lo]
                     if src == "int4" else stored)
            for s, shard in self._shards.items():
                mine, at = codes[s::S], shard._count
                m = mine.shape[0]
                if src == "int4":
                    shard._write_nibbles(mine.to(shard.device), at)
                else:
                    shard._vectors[at: at + m] = mine.to(shard.device)
                shard._scales[at: at + m] = sc[s::S].to(shard.device)
                shard._count = at + m
            return
        rows = dequantize_rows(src, stored, sc, hi - lo)
        for s, shard in self._shards.items():
            mine = rows[s::S]
            if mine.shape[0]:
                shard.add(mine)
