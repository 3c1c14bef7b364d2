"""IVF (inverted-file) approximate index with device-resident cluster blocks.

Counterpart of ``tpu_search/index/ivf.py``:

- vectors live in a dense ``[nlist, cap, D]`` block on the index's device
  (bf16 / f32 rows, int8 rows, or int4 as ``[nlist, cap/2, D]`` uint8
  nibble-pair bytes with rows in logical order, the TPUSIDX2 layout; the
  JAX package's ``[nlist, cap/8, D]`` int32 words are a TPU DMA layout
  and are not carried over).  Clusters are padded to a capacity that is a
  multiple of 256 (``_SLOT_ALIGN``), grown by ``_GROWTH``;
- int8 and int4 rows are residuals against their centroid by default
  (``by_residual``), quantized to the JAX package's bits;
- a search scores the centroids, takes the top ``nprobe`` clusters, and
  runs the probe scan of the storage dtype (``ops.ivf_scan``: the CUDA
  kernels on the card, their plain versions on the CPU) over the fill
  prefix of each probed cluster; ids come back as flat slots and map
  through the block ids.  An int8 / bf16 refine tier (``index.refine``)
  re-ranks an over-fetched stage 1;
- training is the port's balanced k-means; ``rebalance``, ``tune_nprobe``
  and the deployed-recall calibration are the JAX package's, step for
  step; ``save`` / ``load`` speak TPUSIDX2 with the JAX package's header
  keys, so both packages read each other's files;
- ``make_scan_fn`` / ``scan_staged`` hand the fused query path
  (``api/fused.py``) the whole search (centroid scan, probe scan, refine)
  as one function over device tensors.

The device programs of the JAX package (``_scatter_rows``, ``_grow_blocks``,
``_permute_slots``, ...) are plain PyTorch here and update the block
tensors in place where that saves a copy (scatters, tombstones).  Host
metadata (``[nlist, cap]`` ids / validity, per-id slot lookups) is numpy,
as in the JAX package.  Product quantization (``dtype="pq"``) and OPQ are
not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..ops.int4_pack import NIBBLE_BIAS, quantize_rows_int4
from ..ops.ivf_scan import (
    IVF_TILE,
    ivf_topk_int4_scan,
    ivf_topk_int8_scan,
    ivf_topk_scan,
)
from ..ops.kmeans import assign_clusters, kmeans
from ..utils.shapes import round_up
from .flat import quantize_rows_int8
from .refine import refine_rescore

logger = logging.getLogger(__name__)

__all__ = [
    "IVFIndex",
    "deployed_quant_calibration",
    "ivf_scan",
    "ivf_index_from_numpy",
    "nprobe_ladder",
    "probe_clusters",
]

_MIN_CLUSTER_CAPACITY = 256
_SLOT_ALIGN = 256
_GROWTH = 1.25
_BALANCE = 0.5
_LOAD_CHUNK_ROWS = 65536
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int4": torch.uint8,
}
_QUANTIZED = ("int8", "int4")
assert _SLOT_ALIGN % IVF_TILE == 0


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding (XLA fuses it into an FMA under jit):
    the float64 product of an int8 or nibble value and an f32 is exact."""
    return (a.double() * b.double() + c.double()).float()


def probe_clusters(
    queries: torch.Tensor, centroids: torch.Tensor, metric: str, nprobe: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cluster_scores [Q, nlist] f32, probe_ids [Q, nprobe] int32)``:
    the centroid scan of every IVF search (l2: ``2 q.c - |c|^2``)."""
    cs = queries.float() @ centroids.T
    if metric == "l2":
        cs = 2.0 * cs - (centroids * centroids).sum(dim=-1)[None, :]
    return cs, torch.topk(cs, nprobe, dim=1).indices.to(torch.int32)


def ivf_scan(scan_key: tuple, buffers: tuple, staged: tuple,
             queries: torch.Tensor, k: int):
    """The search of :meth:`IVFIndex.make_scan_fn` on the device: the
    centroid scan, the probe scan of the storage dtype over ``staged``
    ``(penalty [nlist, cap], fills [nlist])``, the slot -> id map, and with
    a refine tier stage 1 at ``k * refine_factor`` (at most the probed
    reach) re-ranked by the refine rows.  ``buffers`` = ``(centroids,
    blocks, block ids, scales, refine rows, refine scales)``.  Returns
    ``(scores [Q, k] f32, ids [Q, k])``, ``-inf`` / ``-1`` past the
    candidates; ``k`` is at most the reach."""
    _, dtype, metric, nprobe, by_residual, refine_factor = scan_key
    dcent, dblocks, dids, dscale, rrows, rscales = buffers
    penalty, fills = staged
    k_s = k
    if rrows is not None:
        reach = nprobe * dscale.shape[1]
        k_s = max(k, min(k * refine_factor, reach))
    cs, probe = probe_clusters(queries, dcent, metric, nprobe)
    cbias = torch.gather(cs, 1, probe.long()) if by_residual else None
    if dtype == "int4":
        scores, pos = ivf_topk_int4_scan(dblocks, dscale, penalty, fills,
                                         probe, queries, k_s, cbias)
    elif dtype == "int8":
        scores, pos = ivf_topk_int8_scan(dblocks, dscale, penalty, fills,
                                         probe, queries, k_s, cbias)
    else:
        scores, pos = ivf_topk_scan(dblocks, penalty, fills, probe, queries,
                                    k_s, 2.0 if metric == "l2" else 1.0)
    ids = dids.reshape(-1)[pos.clamp(min=0).long()]
    ids = torch.where(torch.isfinite(scores), ids, torch.full_like(ids, -1))
    if rrows is not None:
        scores, ids = refine_rescore(rrows, rscales, queries, ids, k)
    return scores, ids


def nprobe_ladder(search_fn, queries: np.ndarray, nlist: int, k: int,
                  target_recall: float) -> Tuple[int, float]:
    """Smallest power-of-two nprobe whose recall@k against a full-probe
    scan (``nprobe == nlist``) meets ``target_recall``."""
    truth = search_fn(queries, k, nlist)[1]

    def recall_at(nprobe: int) -> float:
        ids = search_fn(queries, k, nprobe)[1]
        hits = total = 0
        for t_row, g_row in zip(truth, ids):
            t = {int(x) for x in t_row if x >= 0}
            if not t:
                continue
            g = {int(x) for x in g_row if x >= 0}
            hits += len(t & g)
            total += len(t)
        return (hits / total) if total else 1.0

    nprobe = 1
    while nprobe < nlist:
        r = recall_at(nprobe)
        if r >= target_recall:
            return nprobe, r
        nprobe *= 2
    return nlist, 1.0


def deployed_quant_calibration(
    index: "IVFIndex",
    target_recall: Optional[float] = None,
    k: int = 10,
    n_queries: int = 64,
    seed: Optional[int] = None,
    margin: float = 0.02,
    factor_ladder: Tuple[int, ...] = (4, 8, 16, 32, 64),
    max_nprobe_escalations: int = 2,
) -> Dict:
    """Measure the deployed recall@k of a quantized IVF index's search
    path (tuned nprobe, probe scan, refine re-rank) against an exact scan
    of its refine rows, and escalate ``refine_factor`` up the ladder, then
    nprobe doublings, until it meets the target (plus ``margin``).  A
    ladder that tops out short leaves ``target_unreachable: True``.  The
    JAX function step for step."""
    target = (index.pq_target_recall if target_recall is None
              else float(target_recall))
    report: Dict = {
        "calibrated": False,
        "recall": None,
        "target": float(target),
        "sampled": 0,
        "refine_factor": int(index.refine_factor),
        "nprobe": int(index.nprobe_hint) or 8,
        "target_unreachable": False,
        "trail": [],
    }
    if not index.pq_auto:
        report["reason"] = "pq_auto off"
        return report
    refine = index._refine_store()
    if refine is None or refine.count == 0 or refine.count < index._count:
        report["reason"] = (
            "no full-coverage refine tier (deployed-recall truth "
            "source; indexes from pre-auto files lack it)")
        return report
    if index._valid is None:
        report["reason"] = "empty index"
        return report
    live_ids = index._ids[index._valid]
    live_ids = live_ids[live_ids >= 0]
    if live_ids.size < max(4 * k, 32):
        report["reason"] = "too few live rows"
        return report

    rng = np.random.default_rng(index.seed if seed is None else seed)
    queries = index._sample_live_rows(n_queries, rng)
    if index.metric == "ip":
        norms = np.linalg.norm(queries, axis=1, keepdims=True)
        queries = queries / np.clip(norms, 1e-12, None)
    live_mask = np.zeros((index._count,), np.bool_)
    live_mask[live_ids] = True
    k_eff = min(k, int(live_ids.size))
    _, truth = refine.topk_all(queries, live_mask, k_eff)
    truth_sets = [set(t[t >= 0].tolist()) for t in truth]

    internal = min(0.995, target + margin)
    base_np = int(index.nprobe_hint) or 8
    factors = [f for f in factor_ladder if f >= index.refine_factor]
    if not factors:
        factors = [int(index.refine_factor)]
    nprobes: list = []
    np_step = base_np
    for _ in range(max_nprobe_escalations + 1):
        capped = min(np_step, index.nlist)
        if capped not in nprobes:
            nprobes.append(capped)
        np_step *= 2

    best = (-1.0, int(index.refine_factor), base_np)
    met = False
    for np_probe in nprobes:
        for factor in factors:
            index.refine_factor = int(factor)
            _, got = index.search(queries, k_eff, nprobe=np_probe)
            recall = float(np.mean([
                len(set(g[g >= 0].tolist()) & ts) / max(1, len(ts))
                for g, ts in zip(got, truth_sets)
            ]))
            report["trail"].append({
                "nprobe": int(np_probe),
                "refine_factor": int(factor),
                "recall": recall,
            })
            if recall > best[0]:
                best = (recall, int(factor), int(np_probe))
            if recall >= internal:
                met = True
                break
        if met:
            break

    recall, factor, np_probe = best
    index.refine_factor = int(factor)
    if np_probe != base_np:
        index.nprobe_hint = int(np_probe)
        index._tuned_live = int(live_ids.size)
    report.update(
        calibrated=True,
        recall=float(recall),
        sampled=int(queries.shape[0]),
        refine_factor=int(factor),
        nprobe=int(np_probe),
        internal_target=float(internal),
        target_unreachable=bool(recall < target),
        live=int(live_ids.size),
    )
    index._quant_cal = dict(report)
    if report["target_unreachable"]:
        logger.warning(
            "Deployed-recall calibration could not reach %.2f: best "
            "measured recall@%d is %.3f at refine_factor=%d nprobe=%d "
            "(marker persisted; consider int8 storage or a flat index)",
            target, k_eff, recall, factor, np_probe)
    return report


class IVFIndex:
    """Coarse-quantized ANN index with device-resident dense cluster blocks."""

    accepts_device_adds = True
    # Bulk adoptions above this row count land in slices of it.
    BULK_ADD_ROWS = 16384

    def __init__(
        self,
        dim: int,
        metric: str = "ip",
        dtype: str = "bfloat16",
        device: Optional[torch.device] = None,
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
        if dtype == "pq" or pq_m:
            raise NotImplementedError(
                "product quantization (dtype='pq') is not ported")
        if opq:
            raise NotImplementedError("OPQ is not ported")
        if pq_auto and dtype == "int4" and refine_dtype == "none":
            # The int8 refine tier is both the calibration's escalation
            # lever and its truth source, and cannot be enabled later.
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
                f"IVFIndex supports dtypes {sorted(_DTYPES)}, got {dtype!r}")
        if dtype in _QUANTIZED and metric == "l2":
            raise ValueError(
                f"{dtype} IVF storage supports metric='ip' only (same "
                "contract as FlatIndex)")
        self.pq_m = 0
        self.opq = False
        self.refine_dtype = refine_dtype
        self.refine_factor = max(1, int(refine_factor))
        self._refine = None
        self.pq_auto = bool(pq_auto) and dtype == "int4"
        self.pq_target_recall = float(pq_target_recall)
        self._quant_cal: Optional[Dict] = None
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else (
            resolve_device())
        self.nlist = nlist
        self.train_iters = train_iters
        self.seed = seed
        self.balanced = balanced
        self.by_residual = (
            dtype in _QUANTIZED if by_residual is None
            else bool(by_residual) and dtype in _QUANTIZED)
        self.nprobe_hint = 0
        self._tuned_live = 0
        self._rebalance_futile_at = 0

        self.centroids: Optional[np.ndarray] = None  # [nlist, D] f32 (host)
        self._cluster_capacity = 0
        self._count = 0
        self._ids: Optional[np.ndarray] = None  # [nlist, cap] int32
        self._valid: Optional[np.ndarray] = None  # [nlist, cap] bool
        self._fill: Optional[np.ndarray] = None  # [nlist] int32
        self._slot_cluster = np.empty((0,), np.int32)
        self._slot_pos = np.empty((0,), np.int32)
        self._dcent: Optional[torch.Tensor] = None  # [nlist, D] f32
        self._dblocks: Optional[torch.Tensor] = None
        self._dids: Optional[torch.Tensor] = None  # [nlist, cap] int32
        self._dvalid: Optional[torch.Tensor] = None  # [nlist, cap] bool
        self._dsq: Optional[torch.Tensor] = None  # [nlist, cap] f32
        self._dscale: Optional[torch.Tensor] = None  # [nlist, cap] f32
        self._dfill: Optional[torch.Tensor] = None  # [nlist] int32 (lazy)
        # Penalty streams per predicate digest (None = no predicate),
        # cleared whenever slot validity or layout changes.
        self._penalty_cache: Dict[Optional[bytes], torch.Tensor] = {}

    def _mutated(self) -> None:
        self._penalty_cache.clear()
        self._dfill = None

    # -- size accounting -----------------------------------------------------

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
    def capacity(self) -> int:
        return self.nlist * self._cluster_capacity

    def padding_stats(self) -> Dict[str, float]:
        """Fraction of the block's slots actually filled."""
        if self._fill is None or self._cluster_capacity == 0:
            return {"slots": 0, "filled": 0, "fill_fraction": 1.0}
        filled = int(self._fill.sum())
        slots = self.nlist * self._cluster_capacity
        return {
            "slots": slots,
            "filled": filled,
            "fill_fraction": filled / slots,
            "max_fill": int(self._fill.max()),
            "min_fill": int(self._fill.min()),
        }

    # -- training ------------------------------------------------------------

    def train(
        self,
        vectors: Union[np.ndarray, torch.Tensor],
        init_idx: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> None:
        """Fit the coarse quantizer (balanced k-means on the device), with
        a generator seeded from ``seed``; ``init_idx`` / ``noise`` replace
        its random numbers (see ``ops.kmeans.kmeans``)."""
        n = vectors.shape[0]
        if n < self.nlist:
            raise ValueError(
                f"Need >= nlist={self.nlist} training vectors, got {n}")
        dv = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        centroids, _ = kmeans(
            dv, self.nlist, iters=self.train_iters, metric=self.metric,
            balance=_BALANCE if self.balanced else -1.0, generator=gen,
            init_idx=init_idx, noise=noise)
        self._dcent = centroids.contiguous()
        self.centroids = centroids.cpu().numpy()

    # -- device block management ----------------------------------------------

    def _block_rows(self, cap: int) -> int:
        return cap // 2 if self.dtype == "int4" else cap

    def _materialize(self) -> None:
        """Allocate the device blocks at the current capacity."""
        cap = self._cluster_capacity
        if self._dcent is None and self.centroids is not None:
            self._dcent = torch.as_tensor(
                self.centroids, dtype=torch.float32, device=self.device)
        if self._dblocks is None and cap:
            dev = self.device
            self._dblocks = torch.zeros(
                (self.nlist, self._block_rows(cap), self.dim),
                dtype=_DTYPES[self.dtype], device=dev)
            self._dids = torch.full((self.nlist, cap), -1, dtype=torch.int32,
                                    device=dev)
            self._dvalid = torch.zeros((self.nlist, cap), dtype=torch.bool,
                                       device=dev)
            self._dsq = torch.zeros((self.nlist, cap), dtype=torch.float32,
                                    device=dev)
            self._dscale = torch.ones((self.nlist, cap), dtype=torch.float32,
                                      device=dev)
            self._mutated()

    def _regrow(self, new_cap: int) -> None:
        """Re-lay the device blocks out at ``new_cap`` slots a cluster (the
        JAX ``_grow_blocks`` / ``_shrink_blocks``), on the device."""
        old_cap = self._cluster_capacity
        keep, keep_rows = min(old_cap, new_cap), self._block_rows(min(old_cap, new_cap))
        old = (self._dblocks, self._dids, self._dvalid, self._dsq, self._dscale)
        self._dblocks = None
        self._cluster_capacity = new_cap
        self._materialize()
        self._dblocks[:, :keep_rows] = old[0][:, :keep_rows]
        for new, prev in zip((self._dids, self._dvalid, self._dsq,
                              self._dscale), old[1:]):
            new[:, :keep] = prev[:, :keep]
        self._mutated()

    def _ensure_cluster_capacity(self, needed_max: int) -> None:
        target = max(_MIN_CLUSTER_CAPACITY, round_up(needed_max, _SLOT_ALIGN))
        if target <= self._cluster_capacity:
            return
        if self._cluster_capacity:
            target = max(target, round_up(
                int(self._cluster_capacity * _GROWTH), _SLOT_ALIGN))
        grow = target - self._cluster_capacity
        if self._ids is not None:
            self._ids = np.pad(self._ids, ((0, 0), (0, grow)),
                               constant_values=-1)
            self._valid = np.pad(self._valid, ((0, 0), (0, grow)))
        else:
            self._ids = np.full((self.nlist, target), -1, np.int32)
            self._valid = np.zeros((self.nlist, target), np.bool_)
            self._fill = np.zeros((self.nlist,), np.int32)
        if self._dblocks is not None:
            self._regrow(target)
        self._cluster_capacity = target

    def _device_fills(self) -> torch.Tensor:
        if self._dfill is None:
            self._dfill = torch.from_numpy(
                self._fill.astype(np.int32)).to(self.device)
        return self._dfill

    def _scatter_rows(self, clusters, slots, vecs, ids, valid, scales=None):
        """Land a batch of rows at ``(clusters, slots)`` in place.  Float
        rows quantize here (int8 / int4, as residuals against their
        cluster's centroid with ``by_residual``); rows already in storage
        form (int8 rows, or uint8 biased nibbles for int4) adopt
        ``scales`` as they are.  The JAX ``_scatter_rows_impl``."""
        dev = self.device
        cl = torch.as_tensor(clusters, device=dev).long()
        sl = torch.as_tensor(slots, device=dev).long()
        if cl.numel() == 0:
            return
        vecs = torch.as_tensor(vecs, device=dev)
        quantized = self.dtype in _QUANTIZED
        pre = quantized and vecs.dtype == _DTYPES[self.dtype]
        cent = self._dcent[cl] if self.by_residual else None
        if pre:
            stored = vecs
            scale = torch.as_tensor(scales, dtype=torch.float32, device=dev)
        elif quantized:
            target = vecs.float() - cent if cent is not None else vecs.float()
            quant = quantize_rows_int4 if self.dtype == "int4" else quantize_rows_int8
            stored, scale = quant(target)
        else:
            stored = vecs.to(_DTYPES[self.dtype])
            scale = torch.ones((cl.shape[0],), dtype=torch.float32, device=dev)
        if quantized:
            codes = stored.float() - NIBBLE_BIAS if self.dtype == "int4" else stored
            dequant = (_fma(codes, scale[:, None], cent) if cent is not None
                       else codes.float() * scale[:, None])
        else:
            dequant = stored.float()
        if self.dtype == "int4":
            byte = sl // 2
            for parity, keep, shift in ((0, 0xF0, 0), (1, 0x0F, 4)):
                sel = (sl % 2) == parity
                c, b = cl[sel], byte[sel]
                old = self._dblocks[c, b]
                self._dblocks[c, b] = (old & keep) | (stored[sel] << shift)
        else:
            self._dblocks[cl, sl] = stored
        self._dids[cl, sl] = torch.as_tensor(ids, device=dev).to(torch.int32)
        self._dvalid[cl, sl] = torch.as_tensor(valid, device=dev).bool()
        self._dsq[cl, sl] = (dequant * dequant).sum(dim=-1)
        self._dscale[cl, sl] = scale
        self._mutated()

    def _flat_blocks(self) -> torch.Tensor:
        return self._dblocks.reshape(-1, self.dim)

    def _gather_stored(self, fi: torch.Tensor):
        """Flat slots -> rows in storage form (int4: uint8 nibbles) and
        their scales (the rebalance's move pass for raw rows)."""
        if self.dtype == "int4":
            b = self._flat_blocks()[fi // 2]
            rows = torch.where((fi % 2 == 1)[:, None], b >> 4, b & 0x0F)
        else:
            rows = self._flat_blocks()[fi]
        return rows, self._dscale.reshape(-1)[fi]

    def _gather_dequant(self, fi: torch.Tensor, centroids=None) -> torch.Tensor:
        """Flat slots -> dequantized f32 rows (``stored * scale``, plus the
        slot's centroid for residual rows, one rounding as XLA's FMA)."""
        rows, scale = self._gather_stored(fi)
        codes = rows.float() - NIBBLE_BIAS if self.dtype == "int4" else rows.float()
        if centroids is not None:
            return _fma(codes, scale[:, None],
                        centroids[fi // self._cluster_capacity])
        return codes * scale[:, None]

    def _penalty(self, mask: Optional[np.ndarray]) -> torch.Tensor:
        """Cached ``[nlist, cap]`` f32 penalty of validity & predicate:
        int8 / int4 add 0 / ``-inf``; bf16 / f32 subtract 0 or ``|v|^2``
        (l2) / ``+inf``."""
        key = None
        if mask is not None:
            mask = np.asarray(mask, dtype=np.bool_)
            key = hashlib.blake2b(mask.tobytes(), digest_size=16).digest()
        cached = self._penalty_cache.get(key)
        if cached is not None:
            return cached
        block_mask = self.device_block_mask(mask)
        if self.dtype in _QUANTIZED:
            penalty = torch.where(block_mask, 0.0, float("-inf"))
        else:
            live = self._dsq if self.metric == "l2" else torch.zeros_like(self._dsq)
            penalty = torch.where(block_mask, live, float("inf"))
        if len(self._penalty_cache) >= 8:
            self._penalty_cache.pop(next(iter(self._penalty_cache)))
        self._penalty_cache[key] = penalty.contiguous()
        return self._penalty_cache[key]

    def device_block_mask(self, mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """Validity & global-id predicate in block layout (``[nlist, cap]``
        bool on the device); ``mask`` is a host bool array over ids."""
        if mask is None:
            return self._dvalid
        mask = np.asarray(mask, dtype=np.bool_)
        horizon = np.zeros((self._count,), dtype=np.bool_)
        horizon[: min(mask.shape[0], self._count)] = mask[: self._count]
        per_block = np.zeros_like(self._valid)
        live = self._ids >= 0
        per_block[live] = horizon[self._ids[live]]
        return self._dvalid & torch.from_numpy(per_block).to(self.device)

    def _refine_store(self):
        """The lazily-built id-keyed refine tier (None when disabled)."""
        if self.refine_dtype == "none":
            return None
        if self._refine is None:
            from .refine import RefineStore

            self._refine = RefineStore(self.dim, dtype=self.refine_dtype,
                                       device=self.device)
        return self._refine

    def _append_slot_lookup(self, ids, clusters, slots) -> None:
        need = int(ids.max()) + 1 if len(ids) else 0
        if need > len(self._slot_cluster):
            new_len = max(need, 2 * len(self._slot_cluster), 1024)
            grow = new_len - len(self._slot_cluster)
            self._slot_cluster = np.concatenate(
                [self._slot_cluster, np.full((grow,), -1, np.int32)])
            self._slot_pos = np.concatenate(
                [self._slot_pos, np.full((grow,), -1, np.int32)])
        self._slot_cluster[ids] = clusters
        self._slot_pos[ids] = slots

    # -- mutation ------------------------------------------------------------

    def add(
        self,
        vectors: Union[np.ndarray, torch.Tensor],
        n: Optional[int] = None,
    ) -> np.ndarray:
        """Append rows; returns their global ids.  A device tensor is
        adopted without a host round trip (only the ``[n]`` cluster
        assignment comes back); ``n`` is its live row count when it carries
        padding rows.  Batches over ``BULK_ADD_ROWS`` land in slices, after
        auto-training on a sample of the whole batch."""
        on_device = isinstance(vectors, torch.Tensor)
        if not on_device:
            vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        total_rows = vectors.shape[0]
        live_rows = total_rows if n is None else min(n, total_rows)
        if n is not None and n > total_rows and on_device:
            raise ValueError(f"live count {n} > padded rows {total_rows}")
        vectors = vectors[:live_rows]
        if live_rows > self.BULK_ADD_ROWS:
            if not self.is_trained:
                if self.nlist == 0:
                    self.nlist = int(min(4096, max(16, round(live_rows ** 0.5))))
                self.train(vectors[: min(live_rows, 500_000)])
            return np.concatenate([
                self.add(vectors[lo: lo + self.BULK_ADD_ROWS])
                for lo in range(0, live_rows, self.BULK_ADD_ROWS)
            ])
        n = live_rows
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        if vectors.shape[1] != self.dim:
            raise ValueError(f"Expected dim {self.dim}, got {vectors.shape[1]}")
        rows = torch.as_tensor(vectors, device=self.device).float()
        if not self.is_trained:
            if self.nlist == 0:
                self.nlist = int(min(4096, max(16, round(n ** 0.5))))
            if n < self.nlist:
                self.nlist = max(1, n // 2 or 1)
            self.train(rows)
        self._materialize()
        assign = assign_clusters(rows, self._dcent, self.metric).cpu().numpy()
        assign = assign.astype(np.int64)

        if self._fill is None:
            self._fill = np.zeros((self.nlist,), np.int32)
        counts = np.bincount(assign, minlength=self.nlist)
        self._ensure_cluster_capacity(int((self._fill + counts).max()))
        self._materialize()
        order = np.argsort(assign, kind="stable")
        starts = np.zeros((self.nlist,), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        ranks = np.empty((n,), np.int64)
        ranks[order] = np.arange(n) - starts[assign[order]]
        slots = (self._fill[assign] + ranks).astype(np.int32)

        ids = np.arange(self._count, self._count + n, dtype=np.int64)
        ids32 = ids.astype(np.int32)
        self._ids[assign, slots] = ids32
        self._valid[assign, slots] = True
        self._fill += counts.astype(np.int32)
        self._append_slot_lookup(ids, assign, slots)
        self._count += n

        refine = self._refine_store()
        if refine is not None:
            # Id-keyed raw rows, before any residual encoding touches them.
            refine.append(rows, n)
        self._scatter_rows(torch.from_numpy(assign), torch.from_numpy(slots),
                           rows, torch.from_numpy(ids32),
                           torch.ones((n,), dtype=torch.bool))
        return ids

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
        self._dvalid[torch.from_numpy(cl).long().to(self.device),
                     torch.from_numpy(pos).long().to(self.device)] = False
        self._mutated()
        return removed

    def _permute(self, perm: np.ndarray, lut: np.ndarray) -> None:
        """Within-cluster slot permutation + id renumbering on the device
        (the JAX ``_permute_slots``); int4 permutes at nibble granularity,
        a group of clusters at a time."""
        dev = self.device
        p = torch.from_numpy(perm).long().to(dev)
        cap = self._cluster_capacity
        if self.dtype == "int4":
            g = max(1, min(self.nlist, (64 << 20) // (cap * self.dim)))
            for c0 in range(0, self.nlist, g):
                blk = self._dblocks[c0: c0 + g]
                u = torch.stack([blk & 0x0F, blk >> 4], dim=2).reshape(
                    blk.shape[0], cap, self.dim)
                u = torch.gather(u, 1, p[c0: c0 + g, :, None].expand(-1, -1, self.dim))
                self._dblocks[c0: c0 + g] = u[:, 0::2] | (u[:, 1::2] << 4)
        else:
            self._dblocks = torch.gather(
                self._dblocks, 1, p[:, :, None].expand(-1, -1, self.dim))
        self._dsq = torch.gather(self._dsq, 1, p)
        self._dscale = torch.gather(self._dscale, 1, p)
        self._dvalid = torch.gather(self._dvalid, 1, p)
        old = torch.gather(self._dids, 1, p).long()
        lut_t = torch.from_numpy(lut).to(dev)
        self._dids = torch.where(
            self._dvalid, lut_t[old.clamp(0, lut_t.shape[0] - 1)],
            torch.full_like(self._dids, -1))
        self._mutated()

    def compact(self) -> Dict[int, int]:
        """Drop tombstones and renumber ids contiguously (order-preserving);
        returns old -> new.  The vector blocks are permuted on the device."""
        if self._count == 0:
            return {}
        keep_ids = np.sort(self._ids[self._valid].astype(np.int64))
        mapping = {int(old): new for new, old in enumerate(keep_ids)}
        if not len(keep_ids):
            self.clear()
            return {}
        lut = np.full((self._count,), -1, np.int32)
        lut[keep_ids] = np.arange(len(keep_ids), dtype=np.int32)
        perm = np.argsort(~self._valid, axis=1, kind="stable").astype(np.int32)
        new_valid = np.take_along_axis(self._valid, perm, axis=1)
        old_at = np.take_along_axis(self._ids, perm, axis=1)
        new_ids = np.where(
            new_valid, lut[np.clip(old_at, 0, self._count - 1)], -1
        ).astype(np.int32)
        self._permute(perm, lut)
        self._ids, self._valid = new_ids, new_valid
        self._fill = new_valid.sum(axis=1).astype(np.int32)
        self._count = len(keep_ids)
        if self._refine is not None and self._refine.count:
            self._refine.compact(keep_ids)
        cc, pp = np.nonzero(new_valid)
        self._slot_cluster = np.full((self._count,), -1, np.int32)
        self._slot_pos = np.full((self._count,), -1, np.int32)
        self._slot_cluster[new_ids[cc, pp]] = cc.astype(np.int32)
        self._slot_pos[new_ids[cc, pp]] = pp.astype(np.int32)
        target = max(_MIN_CLUSTER_CAPACITY,
                     round_up(int(self._fill.max()), _SLOT_ALIGN))
        if target < self._cluster_capacity:
            self._regrow(target)
            self._ids = self._ids[:, :target]
            self._valid = self._valid[:, :target]
        self._mutated()
        return mapping

    def clear(self) -> None:
        self._cluster_capacity = 0
        self._count = 0
        self._ids = self._valid = self._fill = None
        self._slot_cluster = np.empty((0,), np.int32)
        self._slot_pos = np.empty((0,), np.int32)
        self._dblocks = self._dids = self._dvalid = None
        self._dsq = self._dscale = None
        self._mutated()
        if self._refine is not None:
            self._refine.clear()

    # -- tuning and maintenance ------------------------------------------------

    def _sample_live_rows(self, n: int, rng) -> np.ndarray:
        """``n`` randomly sampled live rows, reconstructed as f32 (the
        autotune query proxy)."""
        cc, pp = np.nonzero(self._valid)
        take = min(n, len(cc))
        sel = rng.choice(len(cc), take, replace=False)
        cap = self._cluster_capacity
        flat_idx = (cc[sel].astype(np.int64) * cap + pp[sel])
        refine = self._refine_store()
        if refine is not None and refine.count == self._count > 0:
            rows = refine.gather(self._ids[cc[sel], pp[sel]].astype(np.int64))
        else:
            rows = self._gather_dequant(
                torch.from_numpy(flat_idx).to(self.device),
                self._dcent if self.by_residual else None)
        return rows.cpu().numpy().astype(np.float32)

    def tune_nprobe(
        self,
        target_recall: float = 0.95,
        k: int = 10,
        sample: int = 64,
        seed: Optional[int] = None,
    ) -> Dict[str, float]:
        """Smallest power-of-two nprobe whose recall@k against a full-probe
        scan meets ``target_recall``, measured with reconstructed live rows
        as queries; remembered as ``nprobe_hint``."""
        report = {
            "nprobe": int(self.nprobe_hint) or 8,
            "recall": 1.0,
            "target": target_recall,
            "sampled": 0,
            "tuned": False,
        }
        if self._fill is None or self.nlist < 2 or self._count == 0:
            return report
        live = int(self._valid.sum())
        if live < max(4 * k, 2):
            return report
        rng = np.random.default_rng(self.seed if seed is None else seed)
        queries = self._sample_live_rows(sample, rng)
        if self.metric == "ip":
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.clip(norms, 1e-12, None)
        chosen, measured = nprobe_ladder(
            lambda q_, k_, p: self.search(q_, k_, nprobe=p),
            queries, self.nlist, k, target_recall)
        self.nprobe_hint = int(chosen)
        self._tuned_live = live
        report.update(nprobe=int(chosen), recall=float(measured),
                      sampled=int(queries.shape[0]), tuned=True)
        return report

    def nprobe_hint_fresh(self, drift: float = 0.25) -> bool:
        """True when a tuned hint exists and the live count is within
        ``drift`` of the count it was measured at."""
        if self.nprobe_hint <= 0 or self._tuned_live <= 0:
            return False
        live = self.live
        return ((1.0 - drift) * self._tuned_live <= live
                <= (1.0 + drift) * self._tuned_live)

    def calibrate_quant(self, **kwargs: object) -> Dict:
        """Deployed-recall calibration (:func:`deployed_quant_calibration`)."""
        return deployed_quant_calibration(self, **kwargs)

    def maybe_rebalance(self, skew_threshold: float = 2.5,
                        train_sample: int = 500_000) -> bool:
        """Rebalance when the hottest cluster holds more than
        ``skew_threshold`` times the mean live fill; stays quiet after a
        futile rebalance until the corpus grows 10 % past it."""
        if self._fill is None or self.nlist < 2:
            return False
        live = self.live
        if live < max(self.nlist * 8, 2):
            return False
        futile_at = self._rebalance_futile_at
        if futile_at and live < 1.1 * futile_at:
            return False
        mean_fill = live / self.nlist
        if int(self._fill.max()) <= skew_threshold * mean_fill:
            return False
        self.rebalance(train_sample=train_sample)
        still_skewed = int(self._fill.max()) > skew_threshold * mean_fill
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
        live row out under the new centroids, ids preserved, in chunks of
        ``_LOAD_CHUNK_ROWS``.  Residual rows reconstruct against the old
        centroids and re-encode against the new ones; raw int8 / int4 rows
        move with their scales.  ``init_idx`` / ``noise`` go to
        :meth:`train`.  Returns ``padding_stats()``."""
        if self._count == 0 or self._fill is None:
            return self.padding_stats()
        cc, pp = np.nonzero(self._valid)
        live = len(cc)
        if live < max(self.nlist, 2):
            return self.padding_stats()
        dev = self.device
        ids64 = self._ids[cc, pp].astype(np.int64)
        cap = self._cluster_capacity
        flat_idx = torch.from_numpy(cc.astype(np.int64) * cap + pp).to(dev)
        by_res = self.by_residual
        old_cent = self._dcent if by_res else None
        old = IVFIndex.__new__(IVFIndex)  # the old layout, for the gathers
        old.__dict__.update(self.__dict__)
        refine = self._refine_store()
        use_refine = refine is not None and refine.count == self._count > 0
        rid = torch.from_numpy(ids64).to(dev)

        def recon(sel):
            if use_refine:
                return refine.gather(rid[sel])
            return old._gather_dequant(flat_idx[sel], old_cent)

        chunk = _LOAD_CHUNK_ROWS
        n_train = min(live, max(50 * self.nlist, train_sample))
        rng = np.random.default_rng(self.seed if seed is None else seed)
        tr_idx = torch.from_numpy(rng.choice(live, n_train, replace=False)).to(dev)
        self.train(recon(tr_idx), init_idx=init_idx, noise=noise)
        assign = np.empty((live,), np.int64)
        for c0 in range(0, live, chunk):
            sel = torch.arange(c0, min(live, c0 + chunk), device=dev)
            assign[c0: c0 + chunk] = assign_clusters(
                recon(sel), self._dcent, self.metric).cpu().numpy()

        counts = np.bincount(assign, minlength=self.nlist)
        old_count = self._count
        self._cluster_capacity = 0
        self._ids = self._valid = self._fill = None
        self._dblocks = self._dids = self._dvalid = None
        self._dsq = self._dscale = None
        self._ensure_cluster_capacity(int(counts.max()))
        self._materialize()
        order = np.argsort(assign, kind="stable")
        starts = np.zeros((self.nlist,), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        ranks = np.empty((live,), np.int64)
        ranks[order] = np.arange(live) - starts[assign[order]]
        slots = ranks.astype(np.int32)
        ids32 = ids64.astype(np.int32)
        self._ids[assign, slots] = ids32
        self._valid[assign, slots] = True
        self._fill = counts.astype(np.int32)
        self._count = old_count
        self._slot_cluster = np.full((old_count,), -1, np.int32)
        self._slot_pos = np.full((old_count,), -1, np.int32)
        self._slot_cluster[ids64] = assign.astype(np.int32)
        self._slot_pos[ids64] = slots
        for c0 in range(0, live, chunk):
            sel = torch.arange(c0, min(live, c0 + chunk), device=dev)
            if by_res:
                stored, scales = recon(sel), None
            else:
                stored, scales = old._gather_stored(flat_idx[sel])
            self._scatter_rows(
                torch.from_numpy(assign[c0: c0 + chunk]),
                torch.from_numpy(slots[c0: c0 + chunk]), stored,
                torch.from_numpy(ids32[c0: c0 + chunk]),
                torch.ones((sel.shape[0],), dtype=torch.bool), scales)
        return self.padding_stats()

    # -- search --------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int,
        mask: Optional[np.ndarray] = None,
        nprobe: int = 8,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the ``nprobe`` nearest clusters of each query, with an
        optional predicate mask over ids; ``(scores [Q, k] f32, ids [Q, k]
        int64)``, ``-inf`` / ``-1`` past the candidates.  With a refine tier,
        stage 1 fetches ``k * refine_factor`` candidates and the refine rows
        re-rank them."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        q = queries.shape[0]
        if self._count == 0 or k <= 0:
            shape = (q, max(k, 0))
            return (np.full(shape, -np.inf, dtype=np.float32),
                    np.full(shape, -1, dtype=np.int64))
        k_eff = min(k, min(nprobe, self.nlist) * self._cluster_capacity)
        qt = torch.from_numpy(queries).to(self.device)
        scan_key, buffers = self.make_scan_fn(nprobe)
        scores, ids = ivf_scan(scan_key, buffers, self.scan_staged(mask),
                               qt, k_eff)
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        ids[~np.isfinite(scores)] = -1
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            scores = np.pad(scores, pad, constant_values=-np.inf)
            ids = np.pad(ids, pad, constant_values=-1)
        return scores, ids

    def _scan(self, qt, nprobe, k, penalty):
        """Stage 1 alone (the centroid and probe scans, no refine tier) at
        ``nprobe <= nlist`` -> ``(scores, ids)`` on the device."""
        scan_key = ("ivf", self.dtype, self.metric, nprobe, self.by_residual,
                    0)
        buffers = (self._dcent, self._dblocks, self._dids, self._dscale,
                   None, None)
        return ivf_scan(scan_key, buffers, (penalty, self._device_fills()),
                        qt, k)

    def make_scan_fn(self, nprobe: int) -> Tuple[tuple, tuple]:
        """``(scan_key, buffers)`` for :func:`ivf_scan` at ``nprobe``: the
        key holds what a program bakes in (dtype, metric, nprobe, residual
        encoding, the refine factor), ``buffers`` the tensors it reads in
        place (valid until they move: growth, rebalance, compact, train);
        the penalty and the fills change between calls
        (:meth:`scan_staged`).  The refine rows join once the tier holds
        rows."""
        refine = self._refine_store()
        rows = scales = None
        if refine is not None and refine.count > 0:
            rows, scales = refine.rows, refine.scales
        scan_key = ("ivf", self.dtype, self.metric, min(nprobe, self.nlist),
                    self.by_residual,
                    self.refine_factor if rows is not None else 0)
        return scan_key, (self._dcent, self._dblocks, self._dids,
                          self._dscale, rows, scales)

    def scan_staged(self, mask: Optional[np.ndarray] = None) -> tuple:
        """``(penalty [nlist, cap] f32, fills [nlist] int32)``: validity &
        the predicate ``mask`` in block layout (``device_block_mask``,
        cached per mask until the next mutation) and the cluster fills."""
        return self._penalty(mask), self._device_fills()

    # -- persistence ---------------------------------------------------------

    def _dense_rows(self) -> torch.Tensor:
        """Every cluster's fill prefix, dense, on the device: ``[total, D]``
        rows, or for int4 ``ceil(fill / 2)`` byte rows a cluster with the
        unused high nibble of an odd fill cleared."""
        fill = torch.from_numpy(self._fill.astype(np.int64)).to(self.device)
        if self.dtype != "int4":
            keep = torch.arange(self._cluster_capacity,
                                device=self.device)[None, :] < fill[:, None]
            return self._dblocks[keep]
        nb = (fill + 1) // 2
        keep = torch.arange(self._cluster_capacity // 2,
                            device=self.device)[None, :] < nb[:, None]
        dense = self._dblocks[keep].clone()
        last = torch.cumsum(nb, 0) - 1
        odd = (fill % 2 == 1)
        dense[last[odd]] &= 0x0F
        return dense

    def save(self, path: str) -> None:
        """TPUSIDX2 file with the JAX package's header keys and sections:
        dense per-cluster prefixes in the storage dtype (int4: nibble-pair
        byte rows, ``ceil(fill / 2)`` a cluster), ids, validity, fills,
        centroids, scales (int8 / int4) and the refine rows."""
        from .serialize import tensor_section, write_file

        header = {
            "kind": "ivf",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype,
            "nlist": self.nlist,
            "count": self._count,
            "cluster_capacity": self._cluster_capacity,
            "by_residual": self.by_residual,
            "nprobe_hint": int(self.nprobe_hint),
            "nprobe_tuned_live": int(self._tuned_live),
        }
        if self.dtype == "int4":
            header["pq_auto"] = bool(self.pq_auto)
            header["pq_target_recall"] = float(self.pq_target_recall)
        if self._quant_cal is not None:
            header["quant_cal"] = self._quant_cal
        if self.refine_dtype != "none":
            header["refine_dtype"] = self.refine_dtype
            header["refine_factor"] = self.refine_factor
        fill = (self._fill if self._fill is not None
                else np.zeros((self.nlist,), np.int32))
        total = int(fill.sum())
        vec_dtype = "uint8" if self.dtype == "int4" else self.dtype
        if total:
            keep = np.arange(self._cluster_capacity)[None, :] < fill[:, None]
            dense_ids = self._ids[keep].astype(np.int32)
            dense_valid = self._valid[keep].astype(np.uint8)
            dense = self._dense_rows()
            vectors = tensor_section("vectors", vec_dtype, dense,
                                     dense.shape[0])
            scales = self._dscale.cpu().numpy()[keep].astype(np.float32)
        else:
            dense_ids = np.empty((0,), np.int32)
            dense_valid = np.empty((0,), np.uint8)
            vectors = ("vectors", vec_dtype, (0, self.dim), iter(()))
            scales = np.empty((0,), np.float32)
        centroids = (self.centroids if self.centroids is not None
                     else np.empty((0, self.dim), np.float32))
        sections = [
            vectors,
            ("ids", "int32", (total,), iter([dense_ids])),
            ("valid", "uint8", (total,), iter([dense_valid])),
            ("fill", "int32", (self.nlist,), iter([fill.astype(np.int32)])),
            ("centroids", "float32", tuple(centroids.shape),
             iter([np.ascontiguousarray(centroids, np.float32)])),
        ]
        if self.dtype in _QUANTIZED:
            sections.append(("scales", "float32", (total,), iter([scales])))
        if self._refine is not None and self._refine.count:
            sections.extend(self._refine.sections())
        write_file(path, header, sections)

    @classmethod
    def load(cls, path: str, device: Optional[torch.device] = None) -> "IVFIndex":
        from .serialize import is_streamed_file, read_file

        if not is_streamed_file(path):
            raise NotImplementedError(
                f"{path} is not a TPUSIDX2 file; the round-1 npz format is "
                f"not ported")
        header, arrays = read_file(path)
        if header.get("kind") != "ivf":
            raise ValueError(f"{path} holds a {header.get('kind')!r} index")
        return ivf_index_from_numpy(header, arrays, device, disk=True)


def _words_to_nibble_bytes(words: np.ndarray) -> np.ndarray:
    """The JAX package's int4 blocks ``[nlist, cap/8, D]`` int32 (slot
    ``p`` in nibble ``p % 8`` of word ``p // 8``) -> ``[nlist, cap/2, D]``
    nibble-pair bytes in logical slot order."""
    w = np.ascontiguousarray(words).view(np.uint32)
    nlist, cap_w, d = w.shape
    u = np.stack([(w >> (4 * j)) & 0xF for j in range(8)], axis=2)
    u = u.reshape(nlist, cap_w * 8, d).astype(np.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def ivf_index_from_numpy(header: Dict, arrays: Dict, device=None,
                         disk: bool = False) -> IVFIndex:
    """An :class:`IVFIndex` from state given as numpy arrays.

    ``disk=True``: the TPUSIDX2 sections (dense per-cluster prefixes,
    ``ids``, ``valid``, ``fill``, ``centroids``, ``scales``, the refine
    sections), as :meth:`IVFIndex.load` reads them.  Otherwise a JAX
    ``IVFIndex``'s device state: ``centroids``, ``blocks`` (``[nlist, cap,
    D]``; int4 as the JAX ``[nlist, cap/8, D]`` int32 words), ``ids``,
    ``valid``, ``fill``, ``sq``, ``scale``, and ``refine_rows`` /
    ``refine_scales`` when the index has a refine tier, with ``header``
    carrying the TPUSIDX2 header keys (``count`` and ``cluster_capacity``
    included).  bf16 arrays may be any 2-byte numpy type (their bit
    patterns are taken)."""
    index = IVFIndex(
        dim=header["dim"],
        metric=header["metric"],
        dtype=header["dtype"],
        device=device,
        nlist=header["nlist"],
        by_residual=bool(header.get("by_residual", False)),
        pq_m=int(header.get("pq_m", 0)),
        opq=bool(header.get("opq", False)),
        refine_dtype=header.get("refine_dtype", "none"),
        refine_factor=int(header.get("refine_factor", 4)),
        pq_auto=bool(header.get("pq_auto", False)),
        pq_target_recall=float(header.get("pq_target_recall", 0.9)),
    )
    if header.get("quant_cal") is not None:
        index._quant_cal = dict(header["quant_cal"])
    index.nprobe_hint = int(header.get("nprobe_hint", 0))
    index._tuned_live = int(header.get("nprobe_tuned_live", 0))
    if np.asarray(arrays["centroids"]).shape[0]:
        index.centroids = np.array(arrays["centroids"], dtype=np.float32)
    if index.refine_dtype != "none":
        if "refine_rows" in arrays:
            from .refine import RefineStore

            index._refine = RefineStore.from_arrays(
                index.dim, index.refine_dtype, arrays, device=index.device,
                count=header["count"])
        elif header["count"]:
            logger.warning(
                "refine_dtype=%s in header but no refine_rows section; "
                "disabling the refine tier", index.refine_dtype)
            index.refine_dtype = "none"
    index._count = int(header["count"])
    cap = int(header["cluster_capacity"])
    index._materialize()
    if not cap:
        return index
    nlist = index.nlist
    fill = np.asarray(arrays["fill"]).astype(np.int32)
    index._cluster_capacity = cap
    index._fill = fill.copy()
    if not disk:
        ids = np.asarray(arrays["ids"]).astype(np.int32)
        valid = np.asarray(arrays["valid"]).astype(np.bool_)
        index._ids, index._valid = ids.copy(), valid.copy()
        live_c, live_p = np.nonzero(ids >= 0)
        index._append_slot_lookup(ids[live_c, live_p].astype(np.int64),
                                  live_c.astype(np.int32),
                                  live_p.astype(np.int32))
        blocks = np.asarray(arrays["blocks"])
        if index.dtype == "int4":
            blocks = _words_to_nibble_bytes(blocks)
        elif index.dtype == "bfloat16":
            blocks = blocks.view(np.uint16).view(np.int16)
        dev = index.device
        t = torch.from_numpy(np.array(blocks)).to(dev)
        index._dblocks = (t.view(torch.bfloat16) if index.dtype == "bfloat16"
                          else t.to(_DTYPES[index.dtype]))
        index._dids = torch.from_numpy(ids).to(dev)
        index._dvalid = torch.from_numpy(valid).to(dev)
        index._dsq = torch.from_numpy(
            np.asarray(arrays["sq"], np.float32).copy()).to(dev)
        index._dscale = torch.from_numpy(
            np.asarray(arrays["scale"], np.float32).copy()).to(dev)
        return index
    total = int(fill.sum())
    cum = np.zeros((nlist + 1,), np.int64)
    np.cumsum(fill, out=cum[1:])
    cluster_of = np.repeat(np.arange(nlist, dtype=np.int32), fill)
    pos_of = (np.arange(total) - cum[cluster_of]).astype(np.int32)
    index._ids = np.full((nlist, cap), -1, np.int32)
    index._valid = np.zeros((nlist, cap), np.bool_)
    dense_ids = np.array(arrays["ids"], dtype=np.int32)
    dense_valid = np.asarray(arrays["valid"]).astype(np.bool_)
    index._ids[cluster_of, pos_of] = dense_ids
    index._valid[cluster_of, pos_of] = dense_valid
    live = dense_ids >= 0
    index._append_slot_lookup(dense_ids[live].astype(np.int64),
                              cluster_of[live], pos_of[live])
    index._materialize()
    vecs = arrays["vectors"]
    scales = arrays.get("scales")
    if index.dtype == "int4":
        # Dense row r of cluster c sits at byte row bcum[c] + pos // 2,
        # nibble pos % 2.
        bcum = np.zeros((nlist,), np.int64)
        np.cumsum((fill[:-1] + 1) // 2, out=bcum[1:])
    for start in range(0, total, _LOAD_CHUNK_ROWS):
        stop = min(total, start + _LOAD_CHUNK_ROWS)
        c = cluster_of[start:stop]
        p = pos_of[start:stop]
        if index.dtype == "int4":
            brows = np.asarray(vecs[bcum[c] + p // 2])
            rows = torch.from_numpy(np.where(
                (p % 2 == 1)[:, None], brows >> 4, brows & 0xF
            ).astype(np.uint8))
        elif index.dtype == "bfloat16":
            rows = torch.from_numpy(
                np.array(vecs[start:stop]).view(np.int16)).view(torch.bfloat16)
        else:
            rows = torch.from_numpy(np.array(vecs[start:stop]))
        sc = (torch.from_numpy(np.array(scales[start:stop], np.float32))
              if scales is not None else None)
        index._scatter_rows(torch.from_numpy(c), torch.from_numpy(p), rows,
                            torch.from_numpy(dense_ids[start:stop]),
                            torch.from_numpy(dense_valid[start:stop]), sc)
    return index
