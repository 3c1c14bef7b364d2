"""IVF index sharded over the ``data`` axis of a mesh: a probe scan per
shard, one merge, the refine tier's rescore.

Counterpart of ``tpu_search/parallel/sharded_ivf.py``'s
``ShardedIVFIndex``.

- **Replicated centroids.**  The coarse quantizer (and pq's codebooks and
  OPQ rotation) is trained once, on the first local shard's device, and
  copied to every shard's device: each shard scores all centroids and
  picks the same probes, with no communication.
- **Slot-sharded cluster blocks.**  The logical ``[nlist, cap, D]`` blocks
  are split along the slot axis: each shard is a port ``IVFIndex`` on its
  mesh device holding ``[nlist, lcap, .]`` in the single-device layout of
  its dtype (int4 and pq as nibble-pair bytes, ``lcap / 2`` byte rows a
  cluster; ``lcap`` a multiple of 256, so even).  A global slot is
  ``shard * lcap + local``; the id planes hold global ids.  Each shard has
  its own fills, validity, ``|v|^2``, scales and penalty.
- **Balanced slots.**  A cluster's new rows water-fill its least-filled
  shard slices (:func:`_water_fill`, exact integer water-filling); the
  JAX package's ``_SLOT_ALIGN`` 256, ``_GROWTH`` 1.25 and growth rule, so
  the same adds give the same layout slot for slot, and the same ``lcap``
  (``k_eff = min(k, nprobe * lcap)`` agrees).  A batch is planned whole
  and moved to the devices in 65,536-row slices.
- **Search** (:func:`sharded_ivf_scan`): each shard runs the port's
  ``index.ivf.ivf_scan`` (the centroid scan, then the probe scan of its
  dtype over its own penalty and fills: ``ivf_topk.cu``,
  ``ivf_topk_int8.cu`` or ``ivf_topk_int4.cu`` on the card, their plain
  versions on the CPU, ``ops.pq.ivf_pq_topk`` for pq) with its card
  current; the ``[Q, k]`` results meet in one stable merge over the
  shard-major concatenation (a tie to the lower shard, as ``lax.top_k``
  orders it).  With a refine tier the coarse stage over-fetches
  ``max(k, min(k * refine_factor, nprobe * lcap))`` and
  the rescore (``refine_part`` a card, ``refine_select``) trims to ``k``.
  Over several processes each
  scans its own shards and the ranks' results meet in one ``all_gather``
  before the merge (the rescore's partial sums in one ``all_reduce``),
  each a collective step of its own in ``card_plan``.
- **Host metadata** (``[nlist, S * lcap]`` ids and validity, ``[nlist,
  S]`` fills, per-id slot lookups) is numpy and, over several processes,
  the same on every process (each plans from the same stream).
- **Persistence** writes the single-device TPUSIDX2 ``kind="ivf"``
  container in dense per-cluster order (shard 0's prefix of a cluster,
  then shard 1's, ...), so a sharded save loads in either package's
  ``IVFIndex`` or ``ShardedIVFIndex`` and the reverse.  With more than
  one process each writes ``<path>.host<p>`` with its shards in the JAX
  package's device layout and the ``ivf_shards_manifest`` (the host
  metadata, the same on every process) at ``path``.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..index.ivf import (
    _DTYPES,
    _LOAD_CHUNK_ROWS,
    _NIBBLE,
    _QUANTIZED,
    IVFIndex,
    _words_to_nibble_bytes,
    apply_pq_tune,
    ivf_scan,
    tune_pq_config,
)
from ..index.serialize import _to_numpy as _host
from ..index.serialize import read_file, upload_rows, write_file
from ..ops.int4_pack import bytes_to_words_host, nibble_rows_to_disk_bytes
from ..ops.kmeans import assign_clusters, kmeans
from ..ops.pq import train_opq_for_ivf, train_pq_for_ivf
from ..utils.shapes import bucket_size, round_up
from .distributed import process_count, process_index
from .mesh import Mesh
from .sharded_index import (
    CardPlan,
    Stage,
    _gathers,
    colocated,
    gather_ranks,
    in_shard_order,
    run_plan,
    shards_by_card,
    sum_ranks,
)
from .sharded_refine import ShardedRefineStore, refine_part, refine_select

logger = logging.getLogger(__name__)

__all__ = [
    "ShardedIVFIndex",
    "card_plan",
    "merge_global",
    "sharded_ivf_scan",
]

_UPDATE_BUCKETS = (256, 4096, 65536, 1 << 20)
_SLOT_ALIGN = 256  # per-shard slot granularity
_GROWTH = 1.25
_BALANCE = 0.5


def _water_fill(fills: np.ndarray, n: int) -> np.ndarray:
    """Distribute ``n`` new rows over shards minimizing the resulting max
    fill (exact integer water-filling). Returns per-shard counts."""
    fills = fills.astype(np.int64)
    if n <= 0:
        return np.zeros_like(fills)
    lo, hi = int(fills.min()) + 1, int(fills.max()) + n
    while lo < hi:  # smallest level L with capacity-below-L >= n
        mid = (lo + hi) // 2
        if int(np.maximum(mid - fills, 0).sum()) >= n:
            hi = mid
        else:
            lo = mid + 1
    counts = np.maximum(lo - fills, 0)
    excess = int(counts.sum()) - n
    if excess > 0:
        at_level = np.nonzero(counts > 0)[0]
        counts[at_level[:excess]] -= 1
    return counts


def merge_global(scores: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the shard-major concatenation of each shard's
    ``[Q, k']`` scores (every shard, in global shard order, on one device):
    the first ``k`` of a stable descending sort, with the winners' ids
    (already global), -1 where the score is not finite."""
    top, pos = torch.sort(torch.cat(list(scores), dim=1), dim=1,
                          descending=True, stable=True)
    top = top[:, :k].contiguous()
    out = torch.cat(list(ids), dim=1).gather(1, pos[:, :k]).long()
    return top, torch.where(torch.isfinite(top), out, torch.full_like(out, -1))


def card_plan(scan_key: tuple, buffers: tuple, staged: tuple, k: int,
              merge_device: Optional[torch.device] = None) -> CardPlan:
    """The search of :meth:`ShardedIVFIndex.make_scan_fn` as a
    :class:`~tpu_search_torch.parallel.sharded_index.CardPlan`: each card
    runs the port's ``index.ivf.ivf_scan`` (the centroid scan and the
    probe scan) over the shards it holds, ``local`` stacks the results in
    shard order, then :func:`merge_global` on ``merge_device`` (default the
    first shard's) keeps the top ``k_coarse``.  With a refine tier a second
    stage follows: each card sums the rescore terms of the candidates its
    shards own (``refine_part``), ``local`` adds the cards' sums, and the
    merge keeps the top ``k`` (``refine_select``).  Over processes each
    stage's collective step joins the ranks' parts: an ``all_gather`` of
    the coarse results (:func:`~tpu_search_torch.parallel.sharded_index.
    gather_ranks`), an ``all_reduce`` of the rescore (``sum_ranks``)."""
    (_, mesh, shards, gather, dtype, metric, nprobe, by_residual,
     refine_factor, *codec) = scan_key
    stride = 6 if dtype == "pq" else 4
    n_local = len(shards)
    k_coarse = k
    if refine_factor:
        reach = nprobe * buffers[3].shape[1]
        k_coarse = max(k, min(k * refine_factor, reach))
    key = ("ivf", dtype, metric, nprobe, by_residual, 0, *codec)
    groups = shards_by_card(mesh, shards)

    def coarse(j, inputs):
        out = []
        for i in groups[j][1]:
            dcent, blocks, dids, dscale, *books = buffers[stride * i:
                                                          stride * (i + 1)]
            out += ivf_scan(key, (dcent, blocks, dids, dscale, None, None,
                                  *books), staged[2 * i: 2 * i + 2],
                            inputs[0], k_coarse)
        return tuple(out)

    def stacked(outs, inputs):
        scores, ids = in_shard_order(groups, outs, n_local)
        return torch.stack(scores), torch.stack(ids)

    def merge(part, inputs):
        top, out = merge_global(part[0].unbind(0), part[1].unbind(0),
                                k_coarse)
        return (inputs[0], out) if refine_factor else (top, out)

    stages = [Stage(coarse, stacked, merge,
                    gather_ranks if gather else None)]
    if refine_factor:
        refine = buffers[stride * n_local:]

        def rescore(j, inputs):
            queries, cand = inputs
            part = None
            for i in groups[j][1]:
                term = refine_part(refine[2 * i], refine[2 * i + 1],
                                   shards[i], mesh.shape["data"], queries,
                                   cand)
                part = term if part is None else part + term
            return (part,)

        def summed(outs, inputs):
            full = torch.zeros(inputs[1].shape, dtype=torch.float32,
                               device=inputs[1].device)
            for (part,) in outs:
                full = full + part
            return (full,)

        def finish(part, inputs):
            return refine_select(part[0], inputs[1], k)

        stages.append(Stage(rescore, summed, finish,
                            sum_ranks if gather else None))
    return CardPlan(merge_device or buffers[1].device,
                    tuple(d for d, _ in groups), tuple(stages))


def sharded_ivf_scan(scan_key: tuple, buffers: tuple, staged: tuple,
                     queries: torch.Tensor, k: int):
    """The search of :meth:`ShardedIVFIndex.make_scan_fn` (the port's form
    of the JAX package's ``sharded_ivf_scan_fn_for(scan_key)``):
    ``buffers`` each local shard's ``(centroids, blocks, block ids,
    scales)`` (pq: then its books and rotation), then with a refine tier
    each local shard's refine ``(rows, scales)``; ``staged`` each local
    shard's ``(penalty, fills)``; ``queries [Q, D]`` f32; ``k`` at most
    ``nprobe * lcap``.  ``(scores [Q, k] f32, global ids [Q, k] int64)`` on
    the first shard's device, ``-inf`` / ``-1`` past the candidates:
    :func:`card_plan` run eagerly."""
    return run_plan(card_plan(scan_key, buffers, staged, k), queries)


class ShardedIVFIndex:
    """IVF index sharded over the ``data`` axis of a :class:`Mesh`."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        metric: str = "ip",
        dtype: str = "bfloat16",
        nlist: int = 100,
        train_iters: int = 10,
        seed: int = 0,
        balanced: bool = True,
        by_residual: Optional[bool] = None,
        pq_m: int = 0,
        opq: bool = False,
        refine_dtype: str = "none",
        refine_factor: int = 4,
        pq_auto: bool = False,
        pq_target_recall: float = 0.9,
    ) -> None:
        if metric not in ("ip", "l2"):
            raise ValueError(f"Unknown metric: {metric}")
        if pq_auto and dtype in _NIBBLE and refine_dtype == "none":
            # As IVFIndex: the int8 tier is the calibration's lever and
            # truth source, and cannot be enabled later.
            refine_dtype = "int8"
        if refine_dtype not in ("none", "int8", "bfloat16"):
            raise ValueError(
                "refine_dtype must be 'none', 'int8' or 'bfloat16', "
                f"got {refine_dtype!r}")
        if refine_dtype != "none" and metric != "ip":
            raise ValueError(
                "the refine tier scores metric='ip' only (same contract "
                "as the quantized dtypes it re-ranks)")
        if refine_dtype == "int8" and dtype == "int8":
            logger.warning(
                "refine_dtype='int8' cannot out-resolve int8 coarse "
                "storage (residual-encoded); using 'bfloat16' refine rows")
            refine_dtype = "bfloat16"
        if dtype not in _DTYPES:
            raise ValueError(
                f"ShardedIVFIndex supports dtypes {sorted(_DTYPES)}, got "
                f"{dtype!r}")
        if dtype in _QUANTIZED and metric == "l2":
            raise ValueError(f"{dtype} IVF storage supports metric='ip' only")
        if dtype == "pq":
            pq_m = pq_m or max(1, dim // 4)
            if dim % pq_m:
                raise ValueError(f"pq_m={pq_m} must divide dim={dim}")
        self.pq_m = pq_m if dtype == "pq" else 0
        self._pq_books: Optional[torch.Tensor] = None  # [M, 16, dsub] f32
        self.opq = bool(opq) and dtype == "pq"
        self._pq_rot: Optional[torch.Tensor] = None  # [D, D] f32
        self.dim = dim
        self.mesh = mesh
        self.metric = metric
        self.dtype = dtype
        self.nlist = nlist
        self.train_iters = train_iters
        self.seed = seed
        self.balanced = balanced
        self.by_residual = (
            dtype in _QUANTIZED if by_residual is None
            else bool(by_residual) and dtype in _QUANTIZED)
        self.n_shards = mesh.shape["data"]
        self.refine_dtype = refine_dtype
        self.refine_factor = max(1, int(refine_factor))
        self.pq_auto = bool(pq_auto) and dtype in _NIBBLE
        self.pq_target_recall = float(pq_target_recall)
        self._pq_tune_report: Optional[Dict] = None
        self._quant_cal: Optional[Dict] = None
        self._refine: Optional[ShardedRefineStore] = None
        self.nprobe_hint = 0
        self._tuned_live = 0
        self._rebalance_futile_at = 0

        self.centroids: Optional[np.ndarray] = None  # [nlist, D] f32 host
        self._dcent: Optional[torch.Tensor] = None  # on the merge device
        self._local_capacity = 0  # slots a cluster a shard
        self._count = 0
        # Host slot metadata; slots are global: shard * lcap + local.
        self._ids: Optional[np.ndarray] = None  # [nlist, S * lcap] int32
        self._valid: Optional[np.ndarray] = None  # [nlist, S * lcap] bool
        self._fill: Optional[np.ndarray] = None  # [nlist, S] int32
        self._slot_cluster = np.empty((0,), np.int32)
        self._slot_pos = np.empty((0,), np.int32)
        # The staged scan inputs per predicate digest (None: no predicate),
        # each local shard's (penalty, fills); cleared by every write.
        self._lock = threading.Lock()
        self._staged: Dict[Optional[bytes], tuple] = {}
        self._shards: Dict[int, IVFIndex] = self._empty_shards()

    def _empty_shards(self) -> Dict[int, IVFIndex]:
        return {s: IVFIndex(self.dim, self.metric, self.dtype,
                            device=self.mesh.shard_device(s),
                            nlist=self.nlist, by_residual=self.by_residual,
                            pq_m=self.pq_m)
                for s in self.mesh.local_shards()}

    def _mutated(self) -> None:
        with self._lock:
            self._staged.clear()

    # -- size accounting -----------------------------------------------------

    @property
    def _cols(self) -> int:
        """Block columns: D vector dims, or M code columns for pq."""
        return self.pq_m if self.dtype == "pq" else self.dim

    @property
    def ntotal(self) -> int:
        return self._count

    @property
    def live(self) -> int:
        return int(self._valid.sum()) if self._valid is not None else 0

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    @property
    def _cluster_capacity(self) -> int:
        """Global slots a cluster (all shards)."""
        return self._local_capacity * self.n_shards

    @property
    def capacity(self) -> int:
        return self.nlist * self._cluster_capacity

    def padding_stats(self) -> Dict[str, float]:
        if self._fill is None or self._local_capacity == 0:
            return {"slots": 0, "filled": 0, "fill_fraction": 1.0}
        filled = int(self._fill.sum())
        per_cluster = self._fill.sum(axis=1)
        return {
            "slots": self.capacity,
            "filled": filled,
            "fill_fraction": filled / self.capacity,
            "max_fill": int(per_cluster.max()),
            "min_fill": int(per_cluster.min()),
            "max_shard_fill": int(self._fill.max()),
        }

    def _merge_device(self) -> torch.device:
        return self.mesh.shard_device(self.mesh.local_shards()[0])

    def colocated(self, device: torch.device) -> bool:
        """Whether every shard lies on ``device`` in this process, so that
        one program runs the encode, every shard's scan, the merge and the
        rescore (``parallel.sharded_index.colocated``)."""
        return colocated(self.mesh, self._shards, device)

    # -- training ------------------------------------------------------------

    def train(
        self,
        vectors: Union[np.ndarray, torch.Tensor],
        init_idx: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> None:
        """Fit the coarse quantizer (the port's balanced k-means, seeded
        from ``seed``, on the first local shard's device; ``init_idx`` /
        ``noise`` replace its random numbers) and for pq the codebooks
        (with ``pq_auto`` what :func:`tune_pq_config` measures), then copy
        them to every shard's device."""
        n = vectors.shape[0]
        if n < self.nlist:
            raise ValueError(
                f"Need >= nlist={self.nlist} training vectors, got {n}")
        dev = self._merge_device()
        dv = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        centroids, _ = kmeans(
            dv, self.nlist, iters=self.train_iters, metric=self.metric,
            balance=_BALANCE if self.balanced else -1.0, generator=gen,
            init_idx=init_idx, noise=noise)
        self._dcent = centroids.contiguous()
        self.centroids = centroids.cpu().numpy()
        if self.dtype == "pq":
            if self.pq_auto:
                apply_pq_tune(self, tune_pq_config(
                    dv, self._dcent, self.metric, dim=self.dim,
                    by_residual=self.by_residual,
                    target_recall=self.pq_target_recall, seed=self.seed))
            elif self.opq:
                self._pq_rot, self._pq_books = train_opq_for_ivf(
                    dv, self._dcent, self.metric, self.pq_m,
                    by_residual=self.by_residual, seed=self.seed)
            else:
                self._pq_books = train_pq_for_ivf(
                    dv, self._dcent, self.metric, self.pq_m,
                    by_residual=self.by_residual, seed=self.seed)
        self._replicate()

    def _replicate(self) -> None:
        """The centroids, books and rotation (and the knobs the pq tuner
        sets) on every shard."""
        for shard in self._shards.values():
            shard.nlist = self.nlist
            shard.pq_m, shard.opq = self.pq_m, self.opq
            if self.centroids is not None and self._dcent is not None:
                shard.centroids = self.centroids
                shard._dcent = self._dcent.to(shard.device)
            for name in ("_pq_books", "_pq_rot"):
                t = getattr(self, name)
                setattr(shard, name, None if t is None else t.to(shard.device))

    # -- device block management --------------------------------------------

    def _materialize(self) -> None:
        if self._dcent is None and self.centroids is not None:
            self._dcent = torch.as_tensor(self.centroids, dtype=torch.float32,
                                          device=self._merge_device())
        self._replicate()
        lcap = self._local_capacity
        if lcap:
            for shard in self._shards.values():
                if shard._dblocks is None:
                    shard._cluster_capacity = lcap
                    shard._materialize()

    def _ensure_local_capacity(self, needed_local_max: int) -> None:
        """Grow every shard to the local capacity ``needed_local_max`` rows
        need: a multiple of ``_SLOT_ALIGN``, at least ``_GROWTH`` times the
        old (each shard's slice padded on its device; host global slots
        move from ``s * old + j`` to ``s * new + j``)."""
        target = max(_SLOT_ALIGN, round_up(needed_local_max, _SLOT_ALIGN))
        if target <= self._local_capacity:
            return
        if self._local_capacity:
            target = max(target, round_up(
                int(self._local_capacity * _GROWTH), _SLOT_ALIGN))
        old_lcap = self._local_capacity
        self._local_capacity = target
        materialized = any(sh._dblocks is not None
                           for sh in self._shards.values())
        if old_lcap == 0 or not materialized:
            if self._ids is None:
                cap = target * self.n_shards
                self._ids = np.full((self.nlist, cap), -1, np.int32)
                self._valid = np.zeros((self.nlist, cap), np.bool_)
            return
        for shard in self._shards.values():
            shard._regrow(target)
        self._mutated()

        def regrow(a, fill_value):
            a3 = a.reshape(self.nlist, self.n_shards, old_lcap)
            out = np.full((self.nlist, self.n_shards, target), fill_value,
                          a.dtype)
            out[:, :, :old_lcap] = a3
            return out.reshape(self.nlist, self.n_shards * target)

        self._ids = regrow(self._ids, -1)
        self._valid = regrow(self._valid, False)
        if len(self._slot_cluster):
            known = self._slot_pos >= 0
            s = self._slot_pos[known] // old_lcap
            j = self._slot_pos[known] % old_lcap
            self._slot_pos[known] = (s * target + j).astype(np.int32)

    def _plan_slots(
        self, assign: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Water-fill each cluster's new rows over its shard slices without
        touching device state: ``(shards, locals, needed_local_max)`` a
        row.  The caller grows the capacity, then :meth:`_commit_slots`."""
        n = len(assign)
        shards = np.empty((n,), np.int64)
        locals_ = np.empty((n,), np.int64)
        counts = np.bincount(assign, minlength=self.nlist)
        order = np.argsort(assign, kind="stable")
        starts = np.zeros((self.nlist,), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        needed = 0
        for c in np.nonzero(counts)[0]:
            rows = order[starts[c]: starts[c] + counts[c]]
            per_shard = _water_fill(self._fill[c], len(rows))
            sh, lo = [], []
            for s in np.nonzero(per_shard)[0]:
                f0 = int(self._fill[c, s])
                sh.append(np.full((per_shard[s],), s, np.int64))
                lo.append(np.arange(f0, f0 + per_shard[s], dtype=np.int64))
                needed = max(needed, f0 + int(per_shard[s]))
            shards[rows] = np.concatenate(sh)
            locals_[rows] = np.concatenate(lo)
        return shards, locals_, needed

    def _commit_slots(
        self, assign: np.ndarray, shards: np.ndarray, locals_: np.ndarray
    ) -> np.ndarray:
        """A plan as global slots at the current local capacity; bumps the
        fills."""
        gslots = shards * self._local_capacity + locals_
        np.add.at(self._fill, (assign, shards), 1)
        return gslots

    def _scatter(self, cl: np.ndarray, gs: np.ndarray, vecs: torch.Tensor,
                 ids: np.ndarray, valid: np.ndarray,
                 scales: Optional[torch.Tensor] = None) -> None:
        """Land rows at ``(cluster, global slot)`` on their local shards
        (``IVFIndex._scatter_rows``: float rows quantize or encode there,
        rows in storage form adopt ``scales``); other processes' rows
        drop."""
        lcap = self._local_capacity
        owner = gs // lcap
        for s, shard in self._shards.items():
            sel = np.nonzero(owner == s)[0]
            if not len(sel):
                continue
            st = torch.from_numpy(sel).to(vecs.device)
            shard._scatter_rows(
                torch.from_numpy(cl[sel]),
                torch.from_numpy(gs[sel] - s * lcap),
                vecs[st].to(shard.device), torch.from_numpy(ids[sel]),
                torch.from_numpy(valid[sel]),
                None if scales is None else scales[st].to(shard.device))
        self._mutated()

    def _gather_rows(self, shards: Dict[int, IVFIndex], lcap: int,
                     cl: np.ndarray, gs: np.ndarray, dequant: bool = True):
        """Rows at ``(cluster, global slot)`` of ``shards`` (local capacity
        ``lcap``) on the merge device, each from its owning shard (summed
        across processes): dequantized f32 (``IVFIndex._gather_dequant``,
        plus the slot's centroid for residual rows), or with ``dequant``
        False ``(stored values as f32, scales)``."""
        dev = self._merge_device()
        m = len(cl)
        width = self.dim if dequant else self._cols
        out = torch.zeros((m, width), dtype=torch.float32, device=dev)
        scales = torch.zeros((m,), dtype=torch.float32, device=dev)
        owner = gs // lcap
        for s, shard in shards.items():
            sel = np.nonzero(owner == s)[0]
            if not len(sel):
                continue
            fi = torch.from_numpy(
                cl[sel].astype(np.int64) * lcap + gs[sel] - s * lcap).to(
                    shard.device)
            st = torch.from_numpy(sel).to(dev)
            if dequant:
                rows = shard._gather_dequant(
                    fi, shard._dcent if self.by_residual else None)
            else:
                rows, sc = shard._gather_stored(fi)
                scales[st] = sc.float().to(dev)
            out[st] = rows.float().to(dev)
        if _gathers(self.mesh):
            dist.all_reduce(out)
            if not dequant:
                dist.all_reduce(scales)
        return out if dequant else (out, scales)

    # -- mutation ------------------------------------------------------------

    def add(
        self, vectors: Union[np.ndarray, torch.Tensor], n: Optional[int] = None
    ) -> np.ndarray:
        """Append rows; returns their global ids.  A device tensor is
        adopted without a host round trip; ``n`` is its live row count when
        it carries padding rows.  The batch's layout is planned whole; its
        assignment and scatter run in slices of 65,536 rows."""
        on_device = isinstance(vectors, torch.Tensor)
        if not on_device:
            vectors = np.asarray(vectors, dtype=np.float32)
            if n is not None:
                vectors = vectors[:n]
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        prepadded = on_device and n is not None and n != vectors.shape[0]
        if n is None or not on_device:
            n = vectors.shape[0]
        elif n > vectors.shape[0]:
            raise ValueError(
                f"live count {n} > padded rows {vectors.shape[0]}")
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        if vectors.shape[1] != self.dim:
            raise ValueError(
                f"Expected dim {self.dim}, got {vectors.shape[1]}")
        dev = self._merge_device()
        rows = torch.as_tensor(vectors[:n]).to(device=dev, dtype=torch.float32)
        if not self.is_trained:
            if self.nlist == 0:
                self.nlist = int(min(4096, max(16, round(n ** 0.5))))
            if n < self.nlist:
                self.nlist = max(1, n // 2 or 1)
            self.train(rows)
        self._materialize()
        chunk = _LOAD_CHUNK_ROWS
        assign = np.concatenate([
            assign_clusters(rows[c0: c0 + chunk], self._dcent,
                            self.metric).cpu().numpy()
            for c0 in range(0, n, chunk)]).astype(np.int64)

        if self._fill is None:
            self._fill = np.zeros((self.nlist, self.n_shards), np.int32)
        shards, locals_, need_local = self._plan_slots(assign)
        self._ensure_local_capacity(need_local)
        self._materialize()
        gslots = self._commit_slots(assign, shards, locals_)

        ids = np.arange(self._count, self._count + n, dtype=np.int64)
        ids32 = ids.astype(np.int32)
        self._ids[assign, gslots] = ids32
        self._valid[assign, gslots] = True
        self._append_slot_lookup(ids, assign, gslots)
        self._count += n
        refine = self._refine_store()
        if refine is not None:
            # Id-keyed raw rows, before any residual encoding; the capacity
            # covers the padded batch the JAX index hands its store.
            b = vectors.shape[0] if prepadded else bucket_size(
                n, _UPDATE_BUCKETS)
            refine.append(rows, n, reserve=b)
        valid = np.ones((n,), np.bool_)
        for c0 in range(0, n, chunk):
            c1 = min(n, c0 + chunk)
            self._scatter(assign[c0:c1], gslots[c0:c1], rows[c0:c1],
                          ids32[c0:c1], valid[c0:c1])
        return ids

    # The per-id slot lookup over global slots, as on one device.
    _append_slot_lookup = IVFIndex._append_slot_lookup

    def remove(self, ids: Iterable[int]) -> int:
        """Tombstone the given ids; returns how many were live."""
        if self._valid is None or self._count == 0:
            return 0
        ids = np.asarray(list(ids) if not hasattr(ids, "shape") else ids)
        if ids.size == 0:
            return 0
        ids = ids.astype(np.int64).ravel()
        ids = ids[(ids >= 0) & (ids < len(self._slot_cluster))]
        cl = self._slot_cluster[ids]
        pos = self._slot_pos[ids]
        known = cl >= 0
        cl, pos = cl[known], pos[known]
        was_live = self._valid[cl, pos]
        cl, pos = cl[was_live], pos[was_live]
        removed = int(len(cl))
        if not removed:
            return 0
        self._valid[cl, pos] = False
        lcap = self._local_capacity
        owner = pos // lcap
        for s, shard in self._shards.items():
            sel = owner == s
            if sel.any():
                dev = shard.device
                shard._dvalid[torch.from_numpy(cl[sel]).long().to(dev),
                              torch.from_numpy(pos[sel] - s * lcap).long().to(
                                  dev)] = False
                shard._mutated()
        self._mutated()
        return removed

    def compact(self) -> Dict[int, int]:
        """Drop tombstones and renumber ids contiguously (order-preserving
        within each shard slice); returns old -> new.  Each shard permutes
        its own slots (``IVFIndex._permute``); the capacity is kept."""
        if self._count == 0:
            return {}
        keep_ids = np.sort(self._ids[self._valid].astype(np.int64))
        mapping = {int(old): new for new, old in enumerate(keep_ids)}
        if not len(keep_ids):
            self.clear()
            return {}
        lut = np.full((self._count,), -1, np.int32)
        lut[keep_ids] = np.arange(len(keep_ids), dtype=np.int32)
        lcap = self._local_capacity
        v3 = self._valid.reshape(self.nlist, self.n_shards, lcap)
        perm3 = np.argsort(~v3, axis=2, kind="stable").astype(np.int32)
        new_valid3 = np.take_along_axis(v3, perm3, axis=2)
        ids3 = self._ids.reshape(self.nlist, self.n_shards, lcap)
        old_at = np.take_along_axis(ids3, perm3, axis=2)
        new_ids3 = np.where(
            new_valid3, lut[np.clip(old_at, 0, self._count - 1)], -1
        ).astype(np.int32)
        for s, shard in self._shards.items():
            shard._permute(np.ascontiguousarray(perm3[:, s]), lut)
        self._ids = new_ids3.reshape(self.nlist, self.n_shards * lcap)
        self._valid = new_valid3.reshape(self.nlist, self.n_shards * lcap)
        self._fill = new_valid3.sum(axis=2).astype(np.int32)
        self._count = len(keep_ids)
        refine = self._refine_store()
        if refine is not None and refine.count:
            refine.compact(keep_ids)
        cc, ss, jj = np.nonzero(new_valid3)
        new_id_of = new_ids3[cc, ss, jj].astype(np.int64)
        self._slot_cluster = np.full((self._count,), -1, np.int32)
        self._slot_pos = np.full((self._count,), -1, np.int32)
        self._slot_cluster[new_id_of] = cc.astype(np.int32)
        self._slot_pos[new_id_of] = (ss * lcap + jj).astype(np.int32)
        self._mutated()
        return mapping

    def clear(self) -> None:
        self._local_capacity = 0
        self._count = 0
        self._ids = self._valid = self._fill = None
        self._slot_cluster = np.empty((0,), np.int32)
        self._slot_pos = np.empty((0,), np.int32)
        self._shards = self._empty_shards()
        self._mutated()
        if self._refine is not None:
            self._refine.clear()

    # -- tuning and maintenance ----------------------------------------------

    def _sample_live_rows(self, n: int, rng) -> np.ndarray:
        """``n`` randomly sampled live rows as f32 (the autotune query
        proxy): from the refine tier when it covers every id, else
        reconstructed from the owning shards."""
        cc, pp = np.nonzero(self._valid)
        take = min(n, len(cc))
        sel = rng.choice(len(cc), take, replace=False)
        refine = self._refine_store()
        if refine is not None and refine.count == self._count > 0:
            rows = refine.gather_device(
                self._ids[cc[sel], pp[sel]].astype(np.int64))
        else:
            rows = self._gather_rows(self._shards, self._local_capacity,
                                     cc[sel], pp[sel])
        return rows.cpu().numpy().astype(np.float32)

    # IVFIndex's, on the sharded layout: the ladder over ``search`` with
    # :meth:`_sample_live_rows` as queries; the deployed-recall calibration,
    # its truth scan the sharded refine store's ``topk_all``.
    tune_nprobe = IVFIndex.tune_nprobe
    nprobe_hint_fresh = IVFIndex.nprobe_hint_fresh
    calibrate_quant = IVFIndex.calibrate_quant

    def maybe_rebalance(self, skew_threshold: float = 2.5,
                        train_sample: int = 500_000) -> bool:
        """``IVFIndex.maybe_rebalance`` on the fills summed over shards."""
        if self._fill is None or self.nlist < 2:
            return False
        live = self.live
        if live < max(self.nlist * 8, 2):
            return False
        futile_at = self._rebalance_futile_at
        if futile_at and live < 1.1 * futile_at:
            return False
        mean_fill = live / self.nlist
        if int(self._fill.sum(axis=1).max()) <= skew_threshold * mean_fill:
            return False
        self.rebalance(train_sample=train_sample)
        still_skewed = (
            int(self._fill.sum(axis=1).max()) > skew_threshold * mean_fill)
        self._rebalance_futile_at = live if still_skewed else 0
        return True

    def rebalance(
        self,
        train_sample: int = 500_000,
        seed: Optional[int] = None,
        init_idx: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, float]:
        """Retrain the coarse quantizer on the live corpus and re-lay every
        live row out under the new centroids in a fresh water-filled
        layout, ids preserved, tombstones dropped.  Rows reconstruct from
        the refine tier when it covers every id, else from the old shards:
        residual rows against the old centroids and pq rows through the
        old codec (then re-encoded against the new), raw int8 / int4 rows
        moving with their scales, bit-lossless.  ``init_idx`` / ``noise``
        go to :meth:`train`.  Returns ``padding_stats()``."""
        if self._count == 0 or self._fill is None:
            return self.padding_stats()
        cc, pp = np.nonzero(self._valid)
        live = len(cc)
        if live < max(self.nlist, 2):
            return self.padding_stats()
        ids64 = self._ids[cc, pp].astype(np.int64)
        old_shards, old_lcap = self._shards, self._local_capacity
        refine = self._refine_store()
        use_refine = refine is not None and refine.count == self._count > 0

        def recon(sel: np.ndarray) -> torch.Tensor:
            if use_refine:
                return refine.gather_device(ids64[sel])
            return self._gather_rows(old_shards, old_lcap, cc[sel], pp[sel])

        chunk = _LOAD_CHUNK_ROWS
        n_train = min(live, max(50 * self.nlist, train_sample))
        rng = np.random.default_rng(self.seed if seed is None else seed)
        tr_idx = rng.choice(live, n_train, replace=False)
        self._shards = self._empty_shards()  # the new layout's
        self.train(recon(tr_idx), init_idx=init_idx, noise=noise)
        assign = np.empty((live,), np.int64)
        for c0 in range(0, live, chunk):
            sel = np.arange(c0, min(live, c0 + chunk))
            assign[sel] = assign_clusters(recon(sel), self._dcent,
                                          self.metric).cpu().numpy()

        old_count = self._count
        self._local_capacity = 0
        self._ids = self._valid = None
        self._fill = np.zeros((self.nlist, self.n_shards), np.int32)
        shards, locals_, need_local = self._plan_slots(assign)
        self._ensure_local_capacity(need_local)
        self._materialize()
        gslots = self._commit_slots(assign, shards, locals_)
        ids32 = ids64.astype(np.int32)
        self._ids[assign, gslots] = ids32
        self._valid[assign, gslots] = True
        self._count = old_count
        self._slot_cluster = np.full((old_count,), -1, np.int32)
        self._slot_pos = np.full((old_count,), -1, np.int32)
        self._slot_cluster[ids64] = assign.astype(np.int32)
        self._slot_pos[ids64] = gslots.astype(np.int32)
        valid = np.ones((live,), np.bool_)
        for c0 in range(0, live, chunk):
            sel = np.arange(c0, min(live, c0 + chunk))
            if self.by_residual or self.dtype == "pq":
                stored, scales = recon(sel), None
            else:
                stored, scales = self._gather_rows(
                    old_shards, old_lcap, cc[sel], pp[sel], dequant=False)
                stored = stored.to(_DTYPES[self.dtype])
            self._scatter(assign[sel], gslots[sel], stored, ids32[sel],
                          valid[sel], scales)
        del old_shards
        return self.padding_stats()

    # -- search --------------------------------------------------------------

    def device_block_mask(self, mask: Optional[np.ndarray] = None) -> tuple:
        """Validity & the global-id predicate ``mask`` in block layout:
        each local shard's ``[nlist, lcap]`` bool on its device."""
        if mask is None:
            return tuple(sh._dvalid for sh in self._shards.values())
        mask = np.asarray(mask, dtype=np.bool_)
        horizon = np.zeros((self._count,), dtype=np.bool_)
        horizon[: min(mask.shape[0], self._count)] = mask[: self._count]
        per_block = np.zeros_like(self._valid)
        live = self._ids >= 0
        per_block[live] = horizon[self._ids[live]]
        lcap = self._local_capacity
        return tuple(
            sh._dvalid & torch.from_numpy(np.ascontiguousarray(
                per_block[:, s * lcap: (s + 1) * lcap])).to(sh.device)
            for s, sh in self._shards.items())

    def scan_staged(self, mask: Optional[np.ndarray] = None) -> tuple:
        """Each local shard's ``(penalty [nlist, lcap] f32, fills [nlist]
        int32)`` in turn: validity & ``mask`` folded into the shard's
        penalty, cached per digest of ``mask`` (FIFO of 8) until the next
        write, read under one lock."""
        key = None
        if mask is not None:
            mask = np.asarray(mask, dtype=np.bool_)
            key = hashlib.blake2b(mask.tobytes(), digest_size=16).digest()
        with self._lock:
            cached = self._staged.get(key)
            if cached is not None:
                return cached
            staged = []
            for (s, shard), block_mask in zip(self._shards.items(),
                                              self.device_block_mask(mask)):
                staged.append(shard._penalty_of(block_mask))
                staged.append(torch.from_numpy(np.ascontiguousarray(
                    self._fill[:, s], dtype=np.int32)).to(shard.device))
            if len(self._staged) >= 8:
                self._staged.pop(next(iter(self._staged)))
            self._staged[key] = tuple(staged)
            return self._staged[key]

    def _refine_store(self) -> Optional[ShardedRefineStore]:
        """The lazily built id-sharded refine tier (None when disabled)."""
        if self.refine_dtype == "none":
            return None
        if self._refine is None:
            self._refine = ShardedRefineStore(self.dim, self.mesh,
                                              dtype=self.refine_dtype)
        return self._refine

    def make_scan_fn(self, nprobe: int) -> Tuple[tuple, tuple]:
        """``(scan_key, buffers)`` for :func:`sharded_ivf_scan` at
        ``nprobe``: the key holds what a program bakes in (the mesh, the
        local shards, whether the ranks gather, dtype, metric, nprobe,
        residual encoding, the refine factor once the tier holds rows, pq's
        OPQ flag), ``buffers`` the tensors it reads in place until a growth,
        compact, rebalance or train moves them; the staged penalty and
        fills change between calls (:meth:`scan_staged`)."""
        refine = self._refine_store()
        use_refine = refine is not None and refine.count > 0
        codec = (self._pq_rot is not None,) if self.dtype == "pq" else ()
        scan_key = ("sharded_ivf", self.mesh, tuple(self._shards),
                    _gathers(self.mesh), self.dtype, self.metric,
                    min(nprobe, self.nlist), self.by_residual,
                    self.refine_factor if use_refine else 0, *codec)
        buffers = []
        for shard in self._shards.values():
            buffers += [shard._dcent, shard._dblocks, shard._dids,
                        shard._dscale]
            if self.dtype == "pq":
                buffers += [shard._pq_books, shard._pq_rot]
        if use_refine:
            buffers += list(refine.buffers())
        return scan_key, tuple(buffers)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        mask: Optional[np.ndarray] = None,
        nprobe: int = 8,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Replicated queries -> a probe scan per shard -> one merge (->
        the refine rescore).  ``(scores [Q, k] f32, ids [Q, k] int64)``,
        ``-inf`` / ``-1`` past the candidates."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        q = queries.shape[0]
        if self._count == 0 or k <= 0:
            shape = (q, max(k, 0))
            return (np.full(shape, -np.inf, dtype=np.float32),
                    np.full(shape, -1, dtype=np.int64))
        # Each shard holds lcap slots of a probed cluster.
        k_eff = min(k, min(nprobe, self.nlist) * self._local_capacity)
        qt = torch.from_numpy(queries).to(self._merge_device())
        scan_key, buffers = self.make_scan_fn(nprobe)
        scores, ids = sharded_ivf_scan(scan_key, buffers,
                                       self.scan_staged(mask), qt, k_eff)
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        ids[~np.isfinite(scores)] = -1
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            scores = np.pad(scores, pad, constant_values=-np.inf)
            ids = np.pad(ids, pad, constant_values=-1)
        return scores, ids

    # -- persistence ---------------------------------------------------------

    def _dense_order(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(clusters, global slots)`` of every assigned slot in the dense
        save order: cluster by cluster, shard 0's prefix, then shard 1's."""
        counts = self._fill.reshape(-1).astype(np.int64)
        pair = np.repeat(np.arange(counts.shape[0]), counts)
        start = np.cumsum(counts) - counts
        j = np.arange(int(counts.sum())) - np.repeat(start, counts)
        s = pair % self.n_shards
        return pair // self.n_shards, s * self._local_capacity + j

    def _iter_dense(self, cl: np.ndarray, gs: np.ndarray,
                    fill: np.ndarray) -> Iterator[np.ndarray]:
        """The stored rows in dense order on the host, whole clusters of
        about 65,536 rows at a time: the storage dtype's rows, or for int4
        / pq each cluster's nibble-pair bytes (``ceil(fill / 2)`` byte rows,
        an odd fill's last high nibble zero)."""
        bounds = np.concatenate([[0], np.cumsum(fill)])
        c0 = 0
        while c0 < self.nlist:
            c1 = int(np.searchsorted(bounds, bounds[c0] + _LOAD_CHUNK_ROWS,
                                     side="right")) - 1
            c1 = min(self.nlist, max(c1, c0 + 1))
            lo, hi = int(bounds[c0]), int(bounds[c1])
            if hi > lo:
                stored, _ = self._gather_rows(self._shards,
                                              self._local_capacity,
                                              cl[lo:hi], gs[lo:hi],
                                              dequant=False)
                if self.dtype in _NIBBLE:
                    rows = stored.to(torch.uint8).cpu().numpy()
                    yield np.concatenate([
                        nibble_rows_to_disk_bytes(
                            rows[bounds[c] - lo: bounds[c + 1] - lo])
                        for c in range(c0, c1) if fill[c]])
                else:
                    yield _host(stored.to(_DTYPES[self.dtype]))
            c0 = c1

    def _header(self) -> Dict:
        """The TPUSIDX2 header keys both file kinds share."""
        header = {
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype,
            "nlist": self.nlist,
            "count": self._count,
            "by_residual": self.by_residual,
            "nprobe_hint": int(self.nprobe_hint),
            "nprobe_tuned_live": int(self._tuned_live),
        }
        if self.dtype == "pq":
            header["pq_m"] = self.pq_m
            header["opq"] = bool(self._pq_rot is not None)
            if self._pq_tune_report is not None:
                header["pq_tune"] = self._pq_tune_report
        if self.dtype in _NIBBLE:
            header["pq_auto"] = bool(self.pq_auto)
            header["pq_target_recall"] = float(self.pq_target_recall)
        if self._quant_cal is not None:
            header["quant_cal"] = self._quant_cal
        if self.refine_dtype != "none":
            header["refine_dtype"] = self.refine_dtype
            header["refine_factor"] = self.refine_factor
        return header

    def _codec_sections(self) -> list:
        out = []
        for name, t in (("pq_books", self._pq_books),
                        ("pq_rot", self._pq_rot)):
            if self.dtype == "pq" and t is not None:
                arr = np.ascontiguousarray(t.cpu().numpy(), np.float32)
                out.append((name, "float32", arr.shape, iter([arr])))
        return out

    def _centroid_section(self) -> tuple:
        cents = (self.centroids if self.centroids is not None
                 else np.empty((0, self.dim), np.float32))
        return ("centroids", "float32", tuple(cents.shape),
                iter([np.ascontiguousarray(cents, np.float32)]))

    def save(self, path: str) -> None:
        """The single-device TPUSIDX2 ``kind="ivf"`` container (dense
        per-cluster prefixes in the storage dtype, ids, validity, fills,
        centroids, scales, the pq books and rotation, the refine rows),
        loadable by either package's ``IVFIndex`` or ``ShardedIVFIndex``;
        with more than one process, the per-process files and the manifest
        instead."""
        if process_count() > 1:
            self._save_per_host(path)
            return
        header = {"kind": "ivf", **self._header(),
                  "cluster_capacity": self._cluster_capacity}
        fill = (self._fill.sum(axis=1).astype(np.int32)
                if self._fill is not None
                else np.zeros((self.nlist,), np.int32))
        total = int(fill.sum())
        vec_dtype = "uint8" if self.dtype in _NIBBLE else self.dtype
        rows_out = int(np.sum((fill + 1) // 2)) if self.dtype in _NIBBLE else (
            total)
        if total:
            cl, gs = self._dense_order()
            dense_ids = self._ids[cl, gs].astype(np.int32)
            dense_valid = self._valid[cl, gs].astype(np.uint8)
            vectors = self._iter_dense(cl, gs, fill)
            scales = self._dense_scales(cl, gs)
        else:
            dense_ids = np.empty((0,), np.int32)
            dense_valid = np.empty((0,), np.uint8)
            vectors = iter(())
            scales = np.empty((0,), np.float32)
        sections = [
            ("vectors", vec_dtype, (rows_out, self._cols), vectors),
            ("ids", "int32", (total,), iter([dense_ids])),
            ("valid", "uint8", (total,), iter([dense_valid])),
            ("fill", "int32", (self.nlist,), iter([fill])),
            self._centroid_section(),
        ]
        if self.dtype in ("int8", "int4"):
            sections.append(("scales", "float32", (total,), iter([scales])))
        sections += self._codec_sections()
        if self._refine is not None and self._refine.count:
            sections.extend(self._refine.sections())
        write_file(path, header, sections)

    def _dense_scales(self, cl: np.ndarray, gs: np.ndarray) -> np.ndarray:
        lcap = self._local_capacity
        out = np.zeros((len(cl),), np.float32)
        owner = gs // lcap
        for s, shard in self._shards.items():
            sel = np.nonzero(owner == s)[0]
            fi = cl[sel].astype(np.int64) * lcap + gs[sel] - s * lcap
            flat = shard._dscale.reshape(-1)
            out[sel] = flat[torch.from_numpy(fi).to(flat.device)].cpu().numpy()
        return out

    @staticmethod
    def _host_path(path: str, process: int) -> str:
        return f"{path}.host{process}"

    def _save_per_host(self, path: str) -> None:
        """Each process writes its own shards (``<path>.host<p>``, the JAX
        package's device layout: int4 / pq as ``[nlist, lcap / 8, cols]``
        int32 words) and its refine slices, and the manifest with the host
        metadata (the same bytes on every process, whose ``path`` may be on
        a disk of its own); the save ends on a barrier."""
        me = process_index()
        lcap = self._local_capacity
        base = {**self._header(), "n_shards": self.n_shards,
                "local_capacity": lcap, "process_count": process_count()}
        refine = self._refine if self.refine_dtype != "none" else None
        if refine is not None:
            base["refine_count"] = int(refine.count)
            base["refine_lcap"] = int(refine.lcap)
        owned = list(self._shards) if lcap else []
        sections = []
        for s in owned:
            shard = self._shards[s]
            blocks = _host(shard._dblocks)
            if self.dtype in _NIBBLE:
                cols = blocks.shape[2]
                blocks = bytes_to_words_host(
                    blocks.reshape(-1, cols)).reshape(self.nlist, -1, cols)
            disk = "int32" if self.dtype in _NIBBLE else self.dtype
            sections.append((f"blocks{s}", disk, blocks.shape, iter([blocks])))
            if self.dtype in ("int8", "int4"):
                sc = _host(shard._dscale)
                sections.append((f"scales{s}", "float32", sc.shape,
                                 iter([sc])))
        if refine is not None and refine.count:
            for s in self._shards:
                rows = _host(refine.rows[s])
                sections.append((f"refine{s}", self.refine_dtype, rows.shape,
                                 iter([rows])))
                if self.refine_dtype == "int8":
                    sc = _host(refine.scales[s])
                    sections.append((f"refine_scales{s}", "float32", sc.shape,
                                     iter([sc])))
        write_file(self._host_path(path, me),
                   {**base, "kind": "ivf_shards_host", "process": me,
                    "shard_ids": owned}, sections)
        ids = (self._ids if self._ids is not None
               else np.full((self.nlist, 0), -1, np.int32))
        valid = (self._valid if self._valid is not None
                 else np.zeros((self.nlist, 0), np.bool_))
        fill = (self._fill if self._fill is not None
                else np.zeros((self.nlist, self.n_shards), np.int32))
        manifest = [
            ("ids", "int32", ids.shape,
             iter([np.ascontiguousarray(ids, np.int32)])),
            ("valid", "uint8", valid.shape,
             iter([np.ascontiguousarray(valid, np.uint8)])),
            ("fill", "int32", fill.shape,
             iter([np.ascontiguousarray(fill, np.int32)])),
            self._centroid_section(),
            *self._codec_sections(),
        ]
        write_file(path, {**base, "kind": "ivf_shards_manifest"}, manifest)
        # Every process's file and the manifest exist once save() returns
        # on any process.
        dist.barrier()

    @classmethod
    def _from_header(cls, header: Dict, mesh: Mesh) -> "ShardedIVFIndex":
        index = cls(
            dim=header["dim"], mesh=mesh, metric=header["metric"],
            dtype=header["dtype"], nlist=header["nlist"],
            by_residual=bool(header.get("by_residual", False)),
            pq_m=int(header.get("pq_m", 0)),
            opq=bool(header.get("opq", False)),
            refine_dtype=header.get("refine_dtype", "none"),
            refine_factor=int(header.get("refine_factor", 4)),
            pq_auto=bool(header.get("pq_auto", False)),
            pq_target_recall=float(header.get("pq_target_recall", 0.9)),
        )
        if header.get("pq_tune") is not None:
            index._pq_tune_report = dict(header["pq_tune"])
        if header.get("quant_cal") is not None:
            index._quant_cal = dict(header["quant_cal"])
        index.nprobe_hint = int(header.get("nprobe_hint", 0))
        index._tuned_live = int(header.get("nprobe_tuned_live", 0))
        index._count = int(header["count"])
        return index

    def _adopt_codec(self, arrays: Dict) -> None:
        """Centroids, books and rotation from a file, onto every shard."""
        dev = self._merge_device()
        cents = np.asarray(arrays["centroids"], np.float32)
        if len(cents):
            self.centroids = np.array(cents)
            self._dcent = torch.from_numpy(self.centroids).to(dev)
        for name, attr in (("pq_books", "_pq_books"), ("pq_rot", "_pq_rot")):
            if name in arrays:
                setattr(self, attr, torch.from_numpy(
                    np.array(arrays[name], np.float32)).to(dev))
        self._replicate()

    @classmethod
    def _load_per_host(cls, path: str, mesh: Mesh,
                       header: Dict) -> "ShardedIVFIndex":
        index = cls._from_header(header, mesh)
        if header["n_shards"] != index.n_shards:
            raise ValueError(
                f"manifest has {header['n_shards']} shards, mesh has "
                f"{index.n_shards} — per-host loads need the same topology")
        _, marrays = read_file(path)
        index._adopt_codec(marrays)
        lcap = int(header["local_capacity"])
        if lcap == 0:
            return index
        index._local_capacity = lcap
        # Copies: the sections are read-only maps, and later writes change
        # these in place.
        index._ids = np.array(marrays["ids"], np.int32, copy=True)
        index._valid = np.asarray(marrays["valid"]).astype(np.bool_)
        index._fill = np.array(marrays["fill"], np.int32, copy=True)
        cc, gs = np.nonzero(index._ids >= 0)
        index._append_slot_lookup(index._ids[cc, gs].astype(np.int64), cc, gs)
        host_header, arrays = read_file(index._host_path(path,
                                                         process_index()))
        for s in host_header["shard_ids"]:
            shard = index._shards[s]
            dev = shard.device
            blocks = np.asarray(arrays[f"blocks{s}"])
            if index.dtype in _NIBBLE:
                blocks = _words_to_nibble_bytes(blocks)
            if index.dtype == "bfloat16":
                t = torch.from_numpy(np.array(blocks).view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(blocks)).to(_DTYPES[index.dtype])
            shard._cluster_capacity = lcap
            shard._dblocks = t.to(dev)
            cols = slice(s * lcap, (s + 1) * lcap)
            shard._dids = torch.from_numpy(
                np.ascontiguousarray(index._ids[:, cols])).to(dev)
            shard._dvalid = torch.from_numpy(
                np.ascontiguousarray(index._valid[:, cols])).to(dev)
            if index.dtype in ("int8", "int4"):
                shard._dscale = torch.from_numpy(
                    np.array(arrays[f"scales{s}"], np.float32)).to(dev)
            else:
                shard._dscale = torch.ones((index.nlist, lcap),
                                           dtype=torch.float32, device=dev)
            # |v|^2 is read by the l2 penalty alone (float dtypes).
            shard._dsq = (shard._dblocks.float().square().sum(-1)
                          if index.dtype not in _QUANTIZED else
                          torch.zeros((index.nlist, lcap), dtype=torch.float32,
                                      device=dev))
            shard._mutated()
        r_count = int(header.get("refine_count", 0))
        if index.refine_dtype != "none" and r_count:
            store = ShardedRefineStore(index.dim, mesh, index.refine_dtype)
            store.lcap, store.count = int(header["refine_lcap"]), r_count
            for s in host_header["shard_ids"]:
                dev = mesh.shard_device(s)
                store.rows[s] = upload_rows(arrays[f"refine{s}"],
                                            index.refine_dtype, store.lcap,
                                            dev)
                if index.refine_dtype == "int8":
                    store.scales[s] = upload_rows(
                        arrays[f"refine_scales{s}"], "float32", store.lcap,
                        dev)
            index._refine = store
        return index

    @classmethod
    def load(cls, path: str, mesh: Mesh) -> "ShardedIVFIndex":
        """Any ``kind="ivf"`` TPUSIDX2 file (a single-device or a sharded
        save, of either package), its rows re-laid out over ``mesh``; a
        per-process manifest reloads each process's own file."""
        header, arrays = read_file(path)
        if header.get("kind") == "ivf_shards_manifest":
            return cls._load_per_host(path, mesh, header)
        if header.get("kind") != "ivf":
            raise ValueError(f"Not an IVF container: {path}")
        index = cls._from_header(header, mesh)
        fill = np.asarray(arrays["fill"], np.int64)
        total = int(fill.sum())
        index._adopt_codec(arrays)
        if index.refine_dtype != "none" and total:
            if "refine_rows" in arrays:
                index._refine = ShardedRefineStore.from_arrays(
                    index.dim, index.refine_dtype, arrays, mesh,
                    count=index._count)
            else:
                logger.warning(
                    "refine_dtype=%s in header but no refine_rows section; "
                    "disabling the refine tier", index.refine_dtype)
                index.refine_dtype = "none"
        if not total:
            return index
        dense_ids = np.asarray(arrays["ids"], np.int64)
        dense_valid = np.asarray(arrays["valid"]).astype(np.bool_)
        clusters = np.repeat(np.arange(index.nlist, dtype=np.int64), fill)
        index._fill = np.zeros((index.nlist, index.n_shards), np.int32)
        shards, locals_, need_local = index._plan_slots(clusters)
        index._ensure_local_capacity(need_local)
        index._materialize()
        gslots = index._commit_slots(clusters, shards, locals_)
        index._ids[clusters, gslots] = dense_ids.astype(np.int32)
        index._valid[clusters, gslots] = dense_valid
        index._append_slot_lookup(dense_ids, clusters, gslots)

        vecs = arrays["vectors"]
        scales = (np.asarray(arrays["scales"], np.float32)
                  if index.dtype in ("int8", "int4") else None)
        if index.dtype in _NIBBLE:
            # Dense row r of cluster c sits at byte row bcum[c] + pos // 2,
            # nibble pos % 2.
            cum = np.zeros((index.nlist,), np.int64)
            np.cumsum(fill[:-1], out=cum[1:])
            bcum = np.zeros((index.nlist,), np.int64)
            np.cumsum((fill[:-1] + 1) // 2, out=bcum[1:])
        for c0 in range(0, total, _LOAD_CHUNK_ROWS):
            c1 = min(c0 + _LOAD_CHUNK_ROWS, total)
            if index.dtype in _NIBBLE:
                c = clusters[c0:c1]
                p = np.arange(c0, c1) - cum[c]
                brows = np.asarray(vecs[bcum[c] + p // 2])
                rows = torch.from_numpy(np.where(
                    (p % 2 == 1)[:, None], brows >> 4, brows & 0xF
                ).astype(np.uint8))
            elif index.dtype == "bfloat16":
                rows = torch.from_numpy(
                    np.array(vecs[c0:c1]).view(np.int16)).view(torch.bfloat16)
            else:
                rows = torch.from_numpy(np.array(vecs[c0:c1]))
            sc = (None if scales is None
                  else torch.from_numpy(scales[c0:c1].copy()))
            index._scatter(clusters[c0:c1], gslots[c0:c1], rows,
                           dense_ids[c0:c1].astype(np.int32),
                           dense_valid[c0:c1], sc)
        return index
