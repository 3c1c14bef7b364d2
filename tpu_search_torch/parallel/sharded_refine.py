"""Sharded refine tier: id-keyed high-fidelity rows over the shards of a
mesh.

Counterpart of ``tpu_search/parallel/sharded_refine.py``: the refine rows
of a :class:`~tpu_search_torch.parallel.sharded_ivf.ShardedIVFIndex`,
which re-rank its coarse merge.

- **Placement.**  Id ``i`` lives on shard ``i % S`` at local slot
  ``i // S``.  Ids come from the owning index in order, so a batch lands
  as one contiguous id range and every shard's fill stays within one row
  of the others.  Each local shard holds a ``[lcap, D]`` tensor (int8 with
  a ``[lcap]`` f32 scale, or bf16) on its mesh device; ``lcap`` is a
  multiple of 512 grown by 1.25, the JAX store's rule, so both packages
  size a shard alike.  A cluster re-layout (rebalance) never moves them.
- **Quantization.**  int8 rows quantize per row as the single-device
  ``RefineStore`` does (``index.flat.quantize_rows_int8``), bit for bit
  with the JAX store; bf16 rows are cast.
- **Rescore** (:func:`sharded_refine_rescore`): the merged ``[Q, R]``
  candidate ids; each shard gathers the rows it owns, scores them against
  the queries with the single-device ``refine_rescore``'s batched product,
  and zeroes the rest; the partial scores add up on the merge device (and
  across processes in one ``all_reduce``).  Exactly one term of each sum
  is not zero, so the scores are the single-device store's on the same
  rows.  Then the stable top-k, a tie to the earlier candidate.
- **Truth scan** (:meth:`ShardedRefineStore.topk_all`): each shard's live
  rows through the port's flat scans (``flat_topk_int8.cu`` /
  ``flat_topk.cu`` on the card), then ``merge_shards``.
- **Persistence** writes the id-ordered ``refine_rows`` /
  ``refine_scales`` sections of the single-device store, so sharded and
  single-device saves are interchangeable.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..index.flat import quantize_rows_int8
from ..index.refine import REFINE_DTYPES
from ..index.serialize import _to_numpy as _host
from ..index.serialize import upload_rows
from ..ops.flat_topk import flat_topk_scan
from ..ops.flat_topk_int8 import flat_topk_int8_scan
from ..ops.topk_scan import select_topk
from ..utils.shapes import cdiv, round_up
from .mesh import Mesh
from .sharded_index import _all_gather, _current, _gathers, merge_shards

__all__ = ["ShardedRefineStore", "sharded_refine_rescore"]

# Per-shard slot granularity; the global capacity is S times the local.
_LOCAL_ALIGN = 512
_GROWTH = 1.25
# Rows a compaction moves at a time.
_MOVE_CHUNK = 65536


def _owned(ids: torch.Tensor, n_shards: int, shard: int, lcap: int):
    """``(own, safe)``: which of ``ids`` live on ``shard``, and their local
    slots (0 where not owned)."""
    own = (ids >= 0) & (ids % n_shards == shard)
    safe = torch.where(own, torch.div(ids, n_shards, rounding_mode="floor"),
                       0).clamp(0, lcap - 1).long()
    return own, safe


def sharded_refine_rescore(
    buffers: Sequence[Optional[torch.Tensor]],
    shards: Sequence[int],
    n_shards: int,
    gather: bool,
    queries: torch.Tensor,
    ids: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank the merged candidates ``ids [Q, R]`` (global, -1 = none) by
    the refine rows: ``buffers`` each local shard's ``(rows, scales or
    None)`` in the order of ``shards``; ``gather``: the ranks' partial
    scores are summed with ``all_reduce``.  ``(scores [Q, k'], ids [Q,
    k'])``, ``k' = min(k, R)``, on ``ids``' device, ``-inf`` / ``-1`` past
    the real candidates."""
    merge_device = ids.device
    full = torch.zeros(ids.shape, dtype=torch.float32, device=merge_device)
    for i, shard in enumerate(shards):
        rows, scales = buffers[2 * i], buffers[2 * i + 1]
        dev = rows.device
        with _current(dev):
            cand_ids = ids.to(dev)
            own, safe = _owned(cand_ids, n_shards, shard, rows.shape[0])
            cand = rows[safe].float()  # [Q, R, D]
            if scales is not None:
                cand = cand * scales[safe][..., None]
            part = torch.bmm(cand, queries.to(dev).float()[:, :, None])[..., 0]
            part = torch.where(own, part, torch.zeros_like(part))
        full = full + part.to(merge_device)
    if gather:
        dist.all_reduce(full)
    rescored = torch.where(ids >= 0, full,
                           torch.full_like(full, float("-inf")))
    top, pos = select_topk(rescored, min(k, ids.shape[1]))
    out_ids = torch.gather(ids, 1, pos.clamp(min=0).long())
    return top, torch.where(torch.isfinite(top), out_ids,
                            torch.full_like(out_ids, -1))


class ShardedRefineStore:
    """Dense id-keyed high-fidelity row store over the ``data`` shards of a
    :class:`Mesh` (each process holds its own shards)."""

    def __init__(self, dim: int, mesh: Mesh, dtype: str = "int8") -> None:
        if dtype not in REFINE_DTYPES:
            raise ValueError(
                f"refine dtype must be one of {REFINE_DTYPES}, got {dtype!r}")
        self.dim = dim
        self.mesh = mesh
        self.dtype = dtype
        self.n_shards = mesh.shape["data"]
        self.rows: Dict[int, torch.Tensor] = {}  # local shard -> [lcap, D]
        self.scales: Dict[int, torch.Tensor] = {}  # [lcap] f32 (int8 only)
        self.lcap = 0  # slots a shard
        self.count = 0  # ids [0, count) hold written rows

    @property
    def capacity(self) -> int:
        return self.lcap * self.n_shards

    def _merge_device(self) -> torch.device:
        return self.mesh.shard_device(self.mesh.local_shards()[0])

    def _ensure(self, needed_global: int) -> None:
        """Grow every shard so that global ids below ``needed_global`` fit
        (each shard's tensors padded in place of the old: local slots never
        move)."""
        needed_local = cdiv(needed_global, self.n_shards)
        target = round_up(max(needed_local, 1), _LOCAL_ALIGN)
        if target <= self.lcap:
            return
        if self.lcap:
            target = max(target, round_up(int(self.lcap * _GROWTH),
                                          _LOCAL_ALIGN))
        tdt = torch.int8 if self.dtype == "int8" else torch.bfloat16
        for s in self.mesh.local_shards():
            dev = self.mesh.shard_device(s)
            rows = torch.zeros((target, self.dim), dtype=tdt, device=dev)
            if s in self.rows:
                rows[: self.lcap] = self.rows[s]
            self.rows[s] = rows
            if self.dtype == "int8":
                scales = torch.zeros((target,), dtype=torch.float32,
                                     device=dev)
                if s in self.scales:
                    scales[: self.lcap] = self.scales[s]
                self.scales[s] = scales
        self.lcap = target

    def append(self, batch, n_new: int, reserve: Optional[int] = None) -> None:
        """Land the first ``n_new`` rows of ``batch`` ([B, D] f32, host or
        device) at ids ``[count, count + n_new)``.  ``reserve``: the ids the
        capacity must cover past ``count`` (default ``B``; the owning index
        passes its padded batch size, as the JAX store sees it)."""
        if n_new <= 0:
            return
        batch = torch.as_tensor(batch)
        start = self.count
        self._ensure(start + (batch.shape[0] if reserve is None else reserve))
        S = self.n_shards
        for s, rows in self.rows.items():
            first = (s - start) % S  # the batch row of this shard's first id
            mine = batch[first:n_new:S]
            m = mine.shape[0]
            if not m:
                continue
            at = cdiv(start - s, S) if start > s else 0
            piece = mine.to(device=rows.device, dtype=torch.float32)
            if self.dtype == "int8":
                q, sc = quantize_rows_int8(piece)
                rows[at: at + m] = q
                self.scales[s][at: at + m] = sc
            else:
                rows[at: at + m] = piece.to(torch.bfloat16)
        self.count = start + n_new

    # -- reconstruction ------------------------------------------------------

    def gather_device(self, ids) -> torch.Tensor:
        """Dequantized ``[n, D]`` f32 rows of the given ids on the merge
        device (the rebalance's and the autotune's reconstruction source):
        each row from its owning shard, summed across processes."""
        dev = self._merge_device()
        idx = torch.as_tensor(np.asarray(ids, np.int64)).to(dev)
        out = torch.zeros((idx.shape[0], self.dim), dtype=torch.float32,
                          device=dev)
        for s, rows in self.rows.items():
            own, safe = _owned(idx.to(rows.device), self.n_shards, s,
                               self.lcap)
            got = rows[safe].float()
            if self.dtype == "int8":
                got = got * self.scales[s][safe][:, None]
            got = torch.where(own[:, None], got, torch.zeros_like(got))
            out = out + got.to(dev)
        if _gathers(self.mesh):
            dist.all_reduce(out)
        return out

    def topk_all(
        self, queries: np.ndarray, live_mask: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k of f32 ``queries`` against every live refine row
        (``live_mask``: host bool over ids), the calibration's truth scan:
        each shard's live rows through the flat scan of its dtype, then one
        merge.  Host ``(scores [Q, k], ids [Q, k])``."""
        q = np.asarray(queries).shape[0]
        if not self.rows or self.count == 0:
            return (np.full((q, k), -np.inf, np.float32),
                    np.full((q, k), -1, np.int64))
        S, lcap = self.n_shards, self.lcap
        padded = np.zeros((self.capacity,), np.bool_)
        n = min(self.count, len(live_mask))
        padded[:n] = np.asarray(live_mask, np.bool_)[:n]
        k_eff = min(k, int(padded.sum()) or 1, lcap)
        used = cdiv(self.count, S)
        n_scan = min(lcap, max(round_up(used, 128), k_eff))
        scores, ids = [], []
        dev0 = self._merge_device()
        qh = np.asarray(queries, np.float32)
        for s, rows in self.rows.items():
            dev = rows.device
            live = torch.from_numpy(
                padded.reshape(lcap, S)[:n_scan, s].copy()).to(dev)
            qt = torch.from_numpy(qh).to(dev)
            with _current(dev):
                if self.dtype == "int8":
                    penalty = torch.where(live, 0.0, float("-inf"))
                    sc, li = flat_topk_int8_scan(
                        rows[:n_scan], self.scales[s][:n_scan], penalty, qt,
                        k_eff)
                else:
                    penalty = torch.where(live, 0.0, float("inf"))
                    sc, li = flat_topk_scan(rows[:n_scan], penalty, qt, k_eff)
            scores.append(sc.to(dev0))
            ids.append(li.to(dev0))
        if _gathers(self.mesh):
            scores, ids = _all_gather(torch.stack(scores), torch.stack(ids))
        top, gids = merge_shards(scores, ids, k_eff, S)
        top = top.cpu().numpy()
        out_ids = gids.cpu().numpy().astype(np.int64)
        out_ids[~np.isfinite(top)] = -1
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            top = np.pad(top, pad, constant_values=-np.inf)
            out_ids = np.pad(out_ids, pad, constant_values=-1)
        return top, out_ids

    def buffers(self) -> tuple:
        """Each local shard's ``(rows, scales or None)``, in shard order:
        the fused scan's refine buffers."""
        return tuple(t for s in self.mesh.local_shards()
                     for t in (self.rows[s], self.scales.get(s)))

    def compact(self, keep_ids: np.ndarray) -> None:
        """Re-key after the owning index renumbered: new id ``n`` is old id
        ``keep_ids[n]``.  Rows change shards (``n % S`` is not ``keep_ids[n]
        % S``), so they move as dequantized f32 chunks and append again;
        for int8 that is bit-lossless (a row's largest component
        requantizes to 127 under the same scale, every other to its
        code)."""
        keep_ids = np.asarray(keep_ids, np.int64)
        if not self.rows or self.count == 0 or keep_ids.size == 0:
            self.clear()
            return
        old = ShardedRefineStore(self.dim, self.mesh, self.dtype)
        old.rows, old.scales = self.rows, self.scales
        old.lcap, old.count = self.lcap, self.count
        self.clear()
        n = int(keep_ids.size)
        self._ensure(n)
        for lo in range(0, n, _MOVE_CHUNK):
            hi = min(lo + _MOVE_CHUNK, n)
            self.append(old.gather_device(keep_ids[lo:hi]), hi - lo)

    def clear(self) -> None:
        self.rows = {}
        self.scales = {}
        self.lcap = 0
        self.count = 0

    # -- persistence (TPUSIDX2 sections) --------------------------------------

    def _iter_id_order(self, part) -> Iterator[np.ndarray]:
        """``part(shard)``'s local slots in global id order (id ``j * S +
        p`` is slot ``j`` of shard ``p``), 65,536 ids at a time."""
        S = self.n_shards
        used = cdiv(self.count, S)
        step = max(1, _MOVE_CHUNK // S)
        for j0 in range(0, used, step):
            j1 = min(j0 + step, used)
            block = np.stack([_host(part(p)[j0:j1]) for p in range(S)],
                             axis=1)
            block = block.reshape((-1,) + block.shape[2:])
            yield block[: max(0, min(self.count - j0 * S, block.shape[0]))]

    def sections(self) -> list:
        """The single-device store's id-ordered sections (every shard in
        this process)."""
        out = [("refine_rows", self.dtype, (self.count, self.dim),
                self._iter_id_order(lambda p: self.rows[p]))]
        if self.dtype == "int8":
            out.append(("refine_scales", "float32", (self.count,),
                        self._iter_id_order(lambda p: self.scales[p])))
        return out

    @classmethod
    def from_arrays(
        cls,
        dim: int,
        dtype: str,
        arrays: dict,
        mesh: Mesh,
        count: Optional[int] = None,
    ) -> "ShardedRefineStore":
        """Rebuild from memory-mapped id-ordered sections (a single-device
        or sharded save: the same format); each local shard uploads its
        strided view ``rows[p::S]``."""
        store = cls(dim, mesh, dtype=dtype)
        rows = arrays.get("refine_rows")
        n = int(rows.shape[0]) if rows is not None else 0
        if count is not None:
            n = min(n, count)
        if n == 0:
            return store
        store._ensure(n)
        S = store.n_shards
        for s in mesh.local_shards():
            dev = mesh.shard_device(s)
            store.rows[s] = upload_rows(np.ascontiguousarray(rows[s:n:S]),
                                        dtype, store.lcap, dev)
            if dtype == "int8":
                store.scales[s] = upload_rows(
                    np.ascontiguousarray(arrays["refine_scales"][s:n:S],
                                         np.float32), "float32", store.lcap,
                    dev)
        store.count = n
        return store
