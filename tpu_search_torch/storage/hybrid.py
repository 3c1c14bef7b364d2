"""Hybrid storage: a device-resident vector index + SQLite metadata.

Counterpart of ``tpu_search/storage/hybrid.py``: a flat or IVF index
(``index_type``) in float32, bfloat16, int8 or int4 storage, or product
quantization on IVF (``storage_dtype="pq"``, with OPQ under ``pq_opq``),
the IVF one with its refine tier, skew-triggered rebalance, nprobe
autotune and, for int4 and pq, the deployed-recall calibration, run after
every write batch as in the JAX package.  The SQLite schema and the index file name are the JAX
package's, so one data directory serves both packages.  Filters compile
to a predicate mask fused into the scan; hits are hydrated with one
batched SQL query.

The warm server's hits hydrate through :meth:`HybridStorage.hydrate_wire`
into pre-serialized result fragments, cached per vector id
(``CLAUDE_SEARCH_WIRE_CACHE`` entries, FIFO) until ``_data_version``
moves: every write and every maintenance step that moves index buffers
(compact, rebalance, calibration, growth) bumps it.

With ``shard_devices`` N > 1 (the first N devices of the storage's
platform, on the CPU as many as ``XLA_FLAGS`` gives the JAX package's CPU
mesh) a flat index is a ``parallel.ShardedFlatIndex`` and an IVF index a
``parallel.ShardedIVFIndex`` (with its refine tier) over them, built,
loaded and restored as in the JAX package, the IVF maintenance hooks
unchanged.  Auto (0) shards over every card when there are two or more,
as the JAX package shards over every accelerator; under a process group
of several ranks, over every card of every process (:meth:`HybridStorage.
_index_mesh`).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from time import monotonic
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..devices.capability import (
    DeviceCapability,
    assess_device_capability,
    platform_devices,
    resolve_device,
)
from ..index.registry import create_index, load_index
from ..ingest.chunker import Chunk
from ..parallel.distributed import process_count
from ..parallel.mesh import build_mesh
from ..parallel.sharded_index import ShardedFlatIndex, any_rank
from ..parallel.sharded_ivf import ShardedIVFIndex
from ..utils.profiling import PhaseTimer
from .filters import mask_for_filters, matches_filters
from .metadata import MetadataStore

logger = logging.getLogger(__name__)

__all__ = ["StorageConfig", "SearchConfig", "SearchResult", "HybridStorage",
           "normalize_queries", "resolve_nprobe"]


@dataclass
class StorageConfig:
    data_dir: str = "~/.claude-semantic-search/data"
    db_name: str = "metadata.db"
    index_name: str = "embeddings.tpuidx.npz"
    embedding_dim: int = 768
    index_type: str = "flat"  # "flat" | "ivf" ("hnsw" falls back to flat)
    ivf_nlist: int = 100
    # Rebalance the IVF layout after a write batch when the hottest
    # cluster's fill exceeds this many times the mean live fill (<= 0: off).
    ivf_rebalance_skew: float = 2.5
    # optimize() and the write path tune IVF nprobe to the smallest value
    # meeting this recall@10 against a full-probe scan (<= 0: off).
    ivf_autotune_recall: float = 0.95
    # OPQ rotation for storage_dtype="pq" (FAISS OPQMatrix pretransform).
    pq_opq: bool = False
    # Quantization auto-config: a pq IVF index picks pq_m / OPQ / the int8
    # refine factor by measured recall at train time (tune_pq_config); pq
    # and int4 IVF indexes get an int8 refine tier and the deployed-recall
    # calibration against pq_target_recall, unless OPQ or the refine knobs
    # were set by hand.
    pq_auto: bool = True
    pq_target_recall: float = 0.9
    # "float32" | "bfloat16" | "int8" | "int4" | "pq" (int8/int4/pq are
    # ip-only; pq needs IVF, so a flat index stores it as int4).
    storage_dtype: str = "bfloat16"
    # IVF refine tier: "none" | "int8" | "bfloat16" rows re-ranking the
    # probe scan's top k * refine_factor candidates.
    refine_dtype: str = "none"
    refine_factor: int = 4
    normalize_embeddings: bool = True
    auto_save: bool = True
    save_interval_s: float = 0.0  # min seconds between auto-saves
    device: Optional[str] = None  # None -> $CLAUDE_SEARCH_DEVICE -> "cuda"
    shard_devices: int = 0  # 0 auto (every card, if 2+), 1 one, N shard


@dataclass
class SearchConfig:
    top_k: int = 10
    similarity_threshold: float = 0.0
    include_metadata: bool = True
    include_text: bool = True
    # IVF probe count; 0 = auto: the index's measured-recall nprobe_hint,
    # else 8.
    nprobe: int = 0


def normalize_queries(queries: torch.Tensor) -> torch.Tensor:
    """Unit rows, ``q / (|q| + 1e-8)``: the query normalize of both search
    paths (the classic scan on the host, the fused program on the
    index's device), one op so that the two agree on the CPU."""
    return queries / (torch.linalg.norm(queries, dim=1, keepdim=True) + 1e-8)


def resolve_nprobe(cfg_nprobe: int, index: object) -> int:
    """``SearchConfig.nprobe=0`` means auto: the index's ``nprobe_hint``
    (set by ``tune_nprobe``) when it has one, else 8."""
    if cfg_nprobe > 0:
        return cfg_nprobe
    return int(getattr(index, "nprobe_hint", 0) or 0) or 8


@dataclass
class SearchResult:
    chunk_id: str
    similarity: float
    chunk: Optional[Chunk] = None
    metadata: Optional[Dict[str, Any]] = None
    text: Optional[str] = None


def _check_supported(config: StorageConfig) -> None:
    if config.index_type not in ("flat", "ivf"):
        raise ValueError(f"Unknown index type: {config.index_type}")


class HybridStorage:
    """Vector index + metadata store behind the reference-compatible API."""

    def __init__(self, config: Optional[StorageConfig] = None) -> None:
        self.config = config or StorageConfig()
        if self.config.index_type == "hnsw":
            logger.warning(
                "index_type 'hnsw' is not supported; using 'flat' (exact "
                "scan; 'ivf' is the ANN option of the JAX package)"
            )
            self.config.index_type = "flat"
        _check_supported(self.config)
        self.logger = logger
        self.data_dir = Path(self.config.data_dir).expanduser()
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.db_path = self.data_dir / self.config.db_name
        self.index_path = self.data_dir / self.config.index_name
        self.meta = MetadataStore(str(self.db_path))
        self.index = None  # (Sharded)FlatIndex | (Sharded)IVFIndex
        self.chunk_id_to_faiss_id: Dict[str, int] = {}
        self.faiss_id_to_chunk_id: Dict[int, str] = {}
        self._capability: Optional[DeviceCapability] = None
        self._device: Optional[torch.device] = None
        self._last_save = 0.0
        self._initialized = False
        # vec_id -> pre-serialized result JSON (hydrate_wire); any mutation
        # bumps _data_version and the cache clears on the next hydrate.
        self._data_version = 0
        self._wire_cache: Dict[int, bytes] = {}
        self._wire_cache_version = -1
        # One read of the shared SQLite connection at a time: concurrent
        # reads on one connection can come back short, and the warm
        # server hydrates on several finisher threads.
        self._read_lock = threading.Lock()
        self.timer = PhaseTimer()
        self.total_chunks = 0
        self.embedding_dim = self.config.embedding_dim

    # -- lifecycle -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(self.config.device)
            self._capability = assess_device_capability(device=self._device)
        return self._device

    def _effective_dtype(self) -> str:
        """``config.storage_dtype`` resolved against the metric and the
        index type, the JAX package's rules: quantized storage scores ip
        only, so an l2 (un-normalized) corpus falls back to bfloat16; PQ
        needs IVF, so a flat index stores int4.  The build and the load
        path both resolve through here."""
        dtype = self.config.storage_dtype
        if dtype in ("int8", "int4", "pq") and not self.config.normalize_embeddings:
            self.logger.warning(
                "storage_dtype '%s' with l2 metric is not supported; "
                "using 'bfloat16'", dtype,
            )
            dtype = "bfloat16"
        if dtype == "pq" and self.config.index_type != "ivf":
            self.logger.warning(
                "storage_dtype 'pq' requires index_type 'ivf'; using 'int4'"
            )
            dtype = "int4"
        return dtype

    def _effective_refine(self) -> str:
        """``config.refine_dtype`` resolved as the JAX package does: off on
        a flat index (already exact over its dtype) and with l2 (the tier
        scores ip only), off for an unknown value."""
        refine = self.config.refine_dtype
        if refine in (None, "", "none"):
            return "none"
        if refine not in ("int8", "bfloat16"):
            self.logger.warning(
                "refine_dtype %r unknown; disabling the refine tier", refine)
            return "none"
        if self.config.index_type != "ivf":
            self.logger.warning(
                "refine_dtype '%s' requires index_type 'ivf'; disabling "
                "(the flat index is already exact over its storage dtype)",
                refine)
            return "none"
        if not self.config.normalize_embeddings:
            self.logger.warning(
                "refine tier scores ip-only; disabling for l2 metric")
            return "none"
        return refine

    def _effective_pq_auto(self) -> bool:
        """Quantization auto-config only where the refine knobs are left
        at their defaults (an explicit choice is a manual operating point)."""
        return (
            self.config.pq_auto
            and self.config.storage_dtype in ("pq", "int4")
            and not self.config.pq_opq
            and self.config.refine_dtype == "none"
        )

    def _index_mesh(self):
        """The mesh to shard a flat or IVF index over, or None for one
        device: the JAX package's rule.  ``shard_devices`` 1 keeps one
        device; 0 (auto) shards over every card
        (``devices.platform_devices("cuda")``) when there are two or more,
        and never over the CPU; N > 1 over the first N devices of the
        storage's platform.

        Under a process group of P > 1 ranks the devices are every
        process's, process-major, as JAX's global ``jax.devices()``: each
        process holds the same number of its own devices (L), so auto on
        cards, and an N of P x L, build ``build_mesh(n_data=P * L,
        dcn_data=P)`` over this process's L devices (process p owns shards
        ``p * L`` .. ``p * L + L - 1``), and any other N > 1 raises
        ``ValueError`` (JAX's first N of the global list would leave ranks
        without shards).  Every rank must then index the same
        conversations in the same order (JAX's SPMD contract): the ranks'
        SQLite ids agree, and each hydrates its results from its own."""
        if self.config.index_type not in ("flat", "ivf"):
            return None
        n = self.config.shard_devices
        if n == 1:
            return None
        procs = process_count()
        if procs > 1:
            if n == 0 and self.device.type != "cuda":
                return None
            local = platform_devices(self.device.type)
            total = procs * len(local)
            if n not in (0, total):
                raise ValueError(
                    f"shard_devices={n} under {procs} processes of "
                    f"{len(local)} {self.device.type} devices each: a mesh "
                    f"over processes holds every process's devices, "
                    f"shard_devices=0 or {total}")
            if total <= 1:
                return None
            return build_mesh(n_data=total, n_model=1, devices=local,
                              dcn_data=procs)
        if n == 0:
            if self.device.type != "cuda":
                return None
            devices = platform_devices("cuda")
            if len(devices) <= 1:
                return None
        else:
            devices = platform_devices(self.device.type)
            if len(devices) < n:
                self.logger.warning(
                    "shard_devices=%d but only %d devices; not sharding",
                    n, len(devices))
                return None
            devices = devices[:n]
        return build_mesh(n_data=len(devices), n_model=1, devices=devices)

    def _load_index(self, path: str):
        """An index file onto this storage's device or mesh (an IVF file
        through the sharded IVF loader: its dense per-cluster rows are not
        in the flat loader's id order)."""
        mesh = self._index_mesh()
        if mesh is None:
            return load_index(path, device=self.device)
        if self.config.index_type == "ivf":
            return ShardedIVFIndex.load(path, mesh=mesh)
        return ShardedFlatIndex.load(path, mesh=mesh,
                                     dtype=self._effective_dtype())

    def _build_index(self):
        _check_supported(self.config)
        mesh = self._index_mesh()
        metric = "ip" if self.config.normalize_embeddings else "l2"
        if mesh is not None and self.config.index_type == "flat":
            self.logger.info("Sharded flat index over %d devices",
                             mesh.shape["data"])
            return ShardedFlatIndex(
                dim=self.embedding_dim, mesh=mesh, metric=metric,
                dtype=self._effective_dtype())
        if mesh is not None:  # index_type "ivf"
            self.logger.info("Sharded IVF index over %d devices",
                             mesh.shape["data"])
            return ShardedIVFIndex(
                dim=self.embedding_dim, mesh=mesh, metric=metric,
                dtype=self._effective_dtype(),
                nlist=self.config.ivf_nlist,
                opq=self.config.pq_opq,
                refine_dtype=self._effective_refine(),
                refine_factor=self.config.refine_factor,
                pq_auto=self._effective_pq_auto(),
                pq_target_recall=self.config.pq_target_recall)
        return create_index(
            self.config.index_type,
            dim=self.embedding_dim,
            metric="ip" if self.config.normalize_embeddings else "l2",
            dtype=self._effective_dtype(),
            device=self.device,
            nlist=self.config.ivf_nlist,
            opq=self.config.pq_opq,
            refine_dtype=self._effective_refine(),
            refine_factor=self.config.refine_factor,
            pq_auto=self._effective_pq_auto(),
            pq_target_recall=self.config.pq_target_recall,
        )

    def rebuild_index(self, embedding_dim: int) -> None:
        self.config.embedding_dim = embedding_dim
        self.embedding_dim = embedding_dim
        self.index = self._build_index()
        self._data_version += 1

    def initialize_metadata(self) -> None:
        """Open only SQLite: enough for chunk-by-id, session and project
        reads without loading the vector index onto the device."""
        self.meta.open()

    def initialize(self) -> None:
        """Open SQLite, create or load the index, rebuild the id maps."""
        if self._initialized:
            return
        self.meta.open()
        if self.index_path.exists():
            try:
                self.index = self._load_index(str(self.index_path))
            except (OSError, ValueError, KeyError) as exc:
                self.logger.warning("Could not load existing index: %s", exc)
                self.index = None
            if self.index is not None:
                self.logger.info("Loaded %s index with %d vectors",
                                 self.index.dtype, self.index.ntotal)
                # The file's dtype is authoritative (it was written with
                # the dtype the config resolved to when it was built).
                if self.index.dtype != self._effective_dtype():
                    self.logger.info(
                        "storage_dtype resolves to %r; keeping the saved "
                        "%r index", self._effective_dtype(),
                        self.index.dtype,
                    )
                if self.index.dim != self.embedding_dim:
                    self.embedding_dim = self.index.dim
                    self.config.embedding_dim = self.index.dim
        if self.index is None:
            self.index = self._build_index()
        self._rebuild_id_mappings()
        self._recover_missing_vectors()
        self._initialized = True

    def close(self) -> None:
        if self.config.auto_save and self._initialized:
            self.save_index()
        self.meta.close()
        self._initialized = False

    def __enter__(self) -> "HybridStorage":
        self.initialize()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def _rebuild_id_mappings(self) -> None:
        fwd, rev = self.meta.vec_id_mappings()
        self.chunk_id_to_faiss_id = fwd
        self.faiss_id_to_chunk_id = rev
        self.total_chunks = len(fwd)
        self._data_version += 1

    def _recover_missing_vectors(self) -> None:
        """Metadata rows whose vectors the loaded index lacks (a crash
        before the debounced save): reset their files' tracking so the
        next index run re-embeds them."""
        if not self.faiss_id_to_chunk_id or self.index is None:
            return
        assigned = int(self.index.ntotal)
        if max(self.faiss_id_to_chunk_id) < assigned:
            return
        files = self.meta.files_with_vec_ids_at_or_above(assigned)
        dropped = self.meta.reset_file_tracking(files if files else None)
        self.logger.warning(
            "Vector index is missing mapped vectors; reset tracking for "
            "%d source files", dropped,
        )

    # -- writes --------------------------------------------------------------

    def add_chunks(
        self,
        chunks: List[Chunk],
        embeddings: "Optional[np.ndarray | torch.Tensor]" = None,
    ) -> None:
        """Append chunks and their embeddings.  ``embeddings`` may be a
        device tensor whose first ``len(chunks)`` rows align with
        ``chunks`` (the rest is padding); it stays on the device through
        the normalize and the index append."""
        if not chunks:
            return
        self._data_version += 1
        if embeddings is None:
            with_emb = [c for c in chunks if c.embedding is not None]
            if not with_emb:
                self.logger.warning("No chunks with embeddings to add")
                return
            embeddings = np.asarray(
                [c.embedding for c in with_emb], dtype=np.float32
            )
        else:
            with_emb = list(chunks)
            if int(embeddings.shape[0]) < len(with_emb):
                raise ValueError(
                    f"embeddings rows ({embeddings.shape[0]}) < "
                    f"chunks ({len(with_emb)})"
                )
        embeddings = embeddings[: len(with_emb)]
        if self.config.normalize_embeddings:
            with self.timer.phase("store.normalize"):
                if isinstance(embeddings, torch.Tensor):
                    norms = torch.linalg.norm(embeddings, dim=1, keepdim=True)
                else:
                    norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
                embeddings = embeddings / (norms + 1e-8)
        if self.index is None:
            raise RuntimeError("Index not initialized")
        start_id = self.index.ntotal
        planned = list(range(start_id, start_id + len(with_emb)))
        with self.timer.phase("store.upsert"):
            self.meta.upsert_chunks(list(zip(with_emb, planned)))
        with self.timer.phase("store.index_add"):
            vec_ids = self.index.add(embeddings)
        assert list(vec_ids) == planned, "index slot assignment drifted"
        for chunk, vec_id in zip(with_emb, vec_ids):
            self.chunk_id_to_faiss_id[chunk.id] = int(vec_id)
            self.faiss_id_to_chunk_id[int(vec_id)] = chunk.id
        self.total_chunks += len(with_emb)
        with self.timer.phase("store.maintain"):
            if not self._maybe_rebalance_index():
                # Freshness-gated: the first add past the sample floor
                # measures, later adds remeasure after > 25 % growth.
                self._maybe_autotune_nprobe(force=False)
                self._maybe_calibrate_quant(force=False)
        if self.config.auto_save:
            with self.timer.phase("store.save"):
                self._maybe_save()

    def _maybe_rebalance_index(self) -> bool:
        """Skew-triggered IVF rebalance on the write path; a rebalance
        retunes nprobe and recalibrates, since both measured the old
        layout."""
        if self.config.ivf_rebalance_skew <= 0 or self.index is None:
            return False
        maybe = getattr(self.index, "maybe_rebalance", None)
        if maybe is None:
            return False
        ran = bool(maybe(skew_threshold=self.config.ivf_rebalance_skew))
        if ran:
            self._data_version += 1
            stats = self.index.padding_stats()
            self.logger.info(
                "IVF layout skew exceeded %.1fx mean fill; rebalanced "
                "(fill_fraction=%.2f max_fill=%d)",
                self.config.ivf_rebalance_skew,
                stats.get("fill_fraction", 1.0), stats.get("max_fill", 0))
            self._maybe_autotune_nprobe(force=True)
            self._maybe_calibrate_quant(force=True)
        return ran

    def _maybe_calibrate_quant(self, force: bool = True) -> bool:
        """Deployed-recall calibration of a quantized IVF index
        (``IVFIndex.calibrate_quant``); ``force=False`` remeasures only
        when nothing was measured yet or the live count drifted > 25 %."""
        if self.index is None:
            return False
        calibrate = getattr(self.index, "calibrate_quant", None)
        if calibrate is None or not getattr(self.index, "pq_auto", False):
            return False
        if not force:
            prev = getattr(self.index, "_quant_cal", None)
            if prev and prev.get("calibrated"):
                live = int(self.index.live)
                at = int(prev.get("live", 0))
                if at and 0.75 * at <= live <= 1.25 * at:
                    return False
        report = calibrate(target_recall=self.config.pq_target_recall)
        self._data_version += 1
        if report.get("calibrated"):
            self.logger.info(
                "Quantization calibrated: deployed recall@10 %.3f (target "
                "%.2f) at refine_factor=%d nprobe=%d%s",
                report["recall"], report["target"], report["refine_factor"],
                report["nprobe"],
                " — TARGET UNREACHABLE at this code rate"
                if report.get("target_unreachable") else "")
        return bool(report.get("calibrated"))

    def _maybe_autotune_nprobe(self, force: bool = True) -> bool:
        """Measured-recall nprobe selection (``IVFIndex.tune_nprobe``);
        ``force=False`` retunes only without a fresh hint."""
        target = self.config.ivf_autotune_recall
        if target <= 0 or self.index is None:
            return False
        tune = getattr(self.index, "tune_nprobe", None)
        if tune is None:
            return False
        if not force and self.index.nprobe_hint_fresh():
            return False
        report = tune(target_recall=target)
        if report.get("tuned"):
            self.logger.info(
                "IVF nprobe autotuned to %d (recall@10 %.3f >= %.2f target, "
                "%d probe queries)", report["nprobe"], report["recall"],
                target, report["sampled"])
        return bool(report.get("tuned"))

    def _maybe_save(self) -> None:
        due = (self.config.save_interval_s <= 0
               or monotonic() - self._last_save >= self.config.save_interval_s)
        # Over processes the save ends on a barrier: every rank saves when
        # any rank's interval is up.
        if self._any_rank(due):
            self.save_index()

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` on any rank where the index gathers across processes
        (``flag`` itself otherwise): a decision that every rank takes
        alike, or one would leave a collective the others wait in."""
        index = self.index
        if not isinstance(index, (ShardedFlatIndex, ShardedIVFIndex)):
            return flag
        return any_rank(index.mesh, index._merge_device(), flag)

    def matches_nothing(self, mask: Optional[np.ndarray]) -> bool:
        """Whether a filter's mask (:meth:`filter_mask`; None: no filter)
        selects no row, on any rank: a rank whose own SQLite matched
        nothing still scans with the others."""
        return mask is not None and not self._any_rank(bool(mask.any()))

    # -- search --------------------------------------------------------------

    def search(
        self,
        query_embedding: np.ndarray,
        config: Optional[SearchConfig] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> List[SearchResult]:
        query = np.asarray(query_embedding, dtype=np.float32).reshape(1, -1)
        return self.search_many(query, config, filters)[0]

    def search_many(
        self,
        query_embeddings: np.ndarray,
        config: Optional[SearchConfig] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> List[List[SearchResult]]:
        """``[Q, D]`` queries sharing one filter set: one scan, one
        metadata fetch."""
        cfg = config or SearchConfig()
        queries = np.asarray(query_embeddings, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq = queries.shape[0]
        if self.index is None or self.index.ntotal == 0 or nq == 0:
            return [[] for _ in range(nq)]
        if self.config.normalize_embeddings:
            queries = normalize_queries(torch.from_numpy(queries)).numpy()
        mask = self.filter_mask(filters)
        if self.matches_nothing(mask):
            return [[] for _ in range(nq)]
        all_scores, all_ids = self.index.search(
            queries, k=cfg.top_k, mask=mask,
            nprobe=resolve_nprobe(cfg.nprobe, self.index))
        return self.hydrate_results(all_scores, all_ids, cfg)

    def filter_mask(
        self, filters: Optional[Dict[str, Any]]
    ) -> Optional[np.ndarray]:
        if self.index is None:
            return None
        with self._read_lock:
            return mask_for_filters(self.meta._conn(), filters,
                                    self.index.ntotal)

    def hydrate_results(
        self,
        all_scores: np.ndarray,
        all_ids: np.ndarray,
        config: Optional[SearchConfig] = None,
    ) -> List[List[SearchResult]]:
        cfg = config or SearchConfig()
        rows = self._rows_for_vec_ids(
            np.unique(all_ids[all_ids >= 0]).tolist()
        )
        out: List[List[SearchResult]] = []
        for qi in range(all_scores.shape[0]):
            scores, ids = all_scores[qi], all_ids[qi]
            hit = ids >= 0
            scores, ids = scores[hit], ids[hit]
            if self.index.metric == "l2":
                similarities = -scores
            else:
                keep = scores >= cfg.similarity_threshold
                similarities, ids = scores[keep], ids[keep]
            results: List[SearchResult] = []
            for sim, vec_id in zip(similarities, ids):
                row = rows.get(int(vec_id))
                if row is None:
                    continue
                meta = json.loads(row["metadata"]) if row["metadata"] else {}
                result = SearchResult(chunk_id=row["id"], similarity=float(sim))
                if cfg.include_metadata:
                    result.metadata = meta
                if cfg.include_text:
                    result.text = row["text"]
                if cfg.include_metadata and cfg.include_text:
                    result.chunk = Chunk(id=row["id"], text=row["text"],
                                         metadata=meta, embedding=None)
                results.append(result)
                if len(results) >= cfg.top_k:
                    break
            out.append(results)
        return out

    def _rows_for_vec_ids(self, vec_ids: List[int]) -> Dict[int, Dict]:
        with self._read_lock:
            return self.meta.rows_for_vec_ids(vec_ids)

    # Fragment-cache bound: fragments average ~0.5-2 KB (the chunk text
    # dominates), so 128k entries hold ~100-250 MB of host RAM of hot
    # result rows.  FIFO eviction (dicts keep insertion order).
    WIRE_CACHE_MAX = int(
        os.environ.get("CLAUDE_SEARCH_WIRE_CACHE", "131072")
    )

    def hydrate_wire(
        self,
        all_scores: np.ndarray,
        all_ids: np.ndarray,
        config: Optional[SearchConfig] = None,
    ) -> List[List[bytes]]:
        """Scan output -> per-query lists of pre-serialized result JSON
        fragments (bytes), the warm server's response fast path.  Each
        result row serializes once into a cached fragment (everything but
        the similarity, spliced per hit), so a response assembles by byte
        joins.  The same hits and keys as :meth:`hydrate_results` +
        ``format_search_result`` (the similarity leads, which JSON
        clients cannot observe).  Any storage mutation bumps
        ``_data_version`` and the cache clears here."""
        cfg = config or SearchConfig()
        wanted = [int(v) for v in np.unique(all_ids[all_ids >= 0])]
        # Under the read lock: the SQLite read, and the cache, which the
        # server's finisher threads fill and evict concurrently (each
        # takes its own tails, so another's eviction cannot drop a hit).
        with self._read_lock:
            cache = self._wire_cache
            if self._wire_cache_version != self._data_version:
                cache.clear()
                self._wire_cache_version = self._data_version
            need = [v for v in wanted if v not in cache]
            rows = self.meta.rows_for_vec_ids(need) if need else {}
            for vid, row in rows.items():
                meta = json.loads(row["metadata"]) if row["metadata"] else {}
                static = {
                    "chunk_id": row["id"],
                    "text": row["text"],
                    "metadata": meta,
                    "project": meta.get("project_name", "unknown"),
                    "session": meta.get("session_id", "unknown"),
                    "timestamp": meta.get("timestamp", "unknown"),
                    "has_code": meta.get("has_code", False),
                }
                # [1:] drops the opening brace; the similarity splice
                # below opens the object again.
                cache[int(vid)] = json.dumps(
                    static, separators=(",", ":")
                )[1:].encode("utf-8")
            tails = {v: cache[v] for v in wanted if v in cache}
            if len(cache) > self.WIRE_CACHE_MAX:
                drop = len(cache) - self.WIRE_CACHE_MAX
                for key in list(itertools.islice(iter(cache), drop)):
                    del cache[key]

        l2 = self.index is not None and self.index.metric == "l2"
        threshold = cfg.similarity_threshold
        out: List[List[bytes]] = []
        for qi in range(all_scores.shape[0]):
            frags: List[bytes] = []
            for score, vec_id in zip(all_scores[qi], all_ids[qi]):
                if vec_id < 0:
                    continue
                sim = -float(score) if l2 else float(score)
                if not l2 and sim < threshold:
                    continue
                tail = tails.get(int(vec_id))
                if tail is None:
                    continue  # the row went meanwhile: skip, as hydrate does
                frags.append(
                    b'{"similarity":%s,%s' % (repr(sim).encode("ascii"), tail)
                )
                if len(frags) >= cfg.top_k:
                    break
            out.append(frags)
        return out

    # -- point reads ---------------------------------------------------------

    def _get_chunk_data(self, chunk_id: str) -> Optional[Dict[str, Any]]:
        """The chunk's SQLite row (the warm server's ``get_chunk`` op)."""
        return self.meta.get_chunk_row(chunk_id)

    def _matches_filters(
        self, chunk_data: Dict[str, Any], filters: Dict[str, Any]
    ) -> bool:
        return matches_filters(chunk_data, filters)

    @staticmethod
    def _row_to_chunk(row: Dict[str, Any]) -> Chunk:
        return Chunk(
            id=row["id"],
            text=row["text"],
            metadata=json.loads(row["metadata"]) if row["metadata"] else {},
            embedding=None,
        )

    def get_chunk_by_id(self, chunk_id: str) -> Optional[Chunk]:
        row = self.meta.get_chunk_row(chunk_id)
        return self._row_to_chunk(row) if row else None

    def get_chunks_by_session(self, session_id: str) -> List[Chunk]:
        return [self._row_to_chunk(r)
                for r in self.meta.rows_for_session(session_id)]

    def get_chunks_by_project(self, project_name: str) -> List[Chunk]:
        return [self._row_to_chunk(r)
                for r in self.meta.rows_for_project(project_name)]

    def get_all_projects(self) -> List[str]:
        return self.meta.all_projects()

    # -- deletion ------------------------------------------------------------

    def delete_chunk(self, chunk_id: str) -> bool:
        """Drop one chunk's row and tombstone its vector."""
        vec_id = self.chunk_id_to_faiss_id.get(chunk_id)
        if vec_id is None or self.meta.delete_chunk(chunk_id) is None:
            return False
        self._data_version += 1
        self.chunk_id_to_faiss_id.pop(chunk_id, None)
        self.faiss_id_to_chunk_id.pop(vec_id, None)
        if self.index is not None:
            self.index.remove([vec_id])  # compacted by optimize()
        self.total_chunks = max(0, self.total_chunks - 1)
        return True

    def delete_chunks_by_session(self, session_id: str) -> int:
        rows = self.meta.rows_for_session(session_id)
        return sum(1 for r in rows if self.delete_chunk(r["id"]))

    def remove_chunks_for_file(self, file_path: str) -> int:
        return self.remove_chunks_for_files([file_path])

    def remove_chunks_for_files(self, file_paths: List[str]) -> int:
        """Drop the files' chunks from SQLite and tombstone their vectors
        (one transaction, one tombstone pass)."""
        with self.timer.phase("store.delete_meta"):
            removed = self.meta.delete_chunks_for_files(file_paths)
        if not removed:
            return 0
        self._data_version += 1
        vec_ids = []
        for chunk_id, vec_id in removed:
            self.chunk_id_to_faiss_id.pop(chunk_id, None)
            if vec_id is not None:
                self.faiss_id_to_chunk_id.pop(vec_id, None)
                vec_ids.append(vec_id)
        if self.index is not None and vec_ids:
            with self.timer.phase("store.tombstone"):
                self.index.remove(vec_ids)
        self.total_chunks = max(0, self.total_chunks - len(removed))
        return len(removed)

    def clear_all_data(self) -> None:
        self._data_version += 1
        self.meta.clear()
        if self.index is not None:
            self.index.clear()
        self.chunk_id_to_faiss_id.clear()
        self.faiss_id_to_chunk_id.clear()
        self.total_chunks = 0
        if self.config.auto_save:
            self.save_index()

    # -- incremental file tracking -------------------------------------------

    def update_file_info(self, file_path: str, chunk_count: int) -> None:
        self.meta.update_file_info(file_path, chunk_count)

    def update_file_infos(self, infos: List[Tuple[str, int]]) -> None:
        self.meta.update_file_infos(infos)

    def is_file_modified(self, file_path: str) -> bool:
        return self.meta.is_file_modified(file_path)

    # -- persistence / maintenance -------------------------------------------

    def save_index(self) -> None:
        if self.index is None:
            return
        self.index.save(str(self.index_path))
        self._last_save = monotonic()

    def backup(self, backup_dir: str) -> None:
        """The index (TPUSIDX2) and an online copy of the SQLite file into
        ``backup_dir``, under the names a data directory uses."""
        dest = Path(backup_dir)
        dest.mkdir(parents=True, exist_ok=True)
        if self.index is not None and self.index.ntotal > 0:
            self.index.save(str(dest / self.config.index_name))
        if self.db_path.exists() and self.meta.db is not None:
            self.meta.backup_to(str(dest / self.config.db_name))
        self.logger.info("Backup created in %s", dest)

    def restore(self, backup_dir: str) -> None:
        """Load a backup (of either package) onto this storage's device."""
        src = Path(backup_dir)
        index_file = src / self.config.index_name
        if index_file.exists():
            self.index = self._load_index(str(index_file))
            self.embedding_dim = self.config.embedding_dim = self.index.dim
        db_file = src / self.config.db_name
        if db_file.exists():
            self.meta.restore_from(str(db_file))
        self._rebuild_id_mappings()  # bumps _data_version
        self.logger.info("Restored from backup in %s", src)

    def optimize(self) -> None:
        """Vacuum SQLite, tombstone orphaned vectors (live slots without a
        metadata row), compact the index (drop tombstones, renumber, save
        at once), then rebalance if skewed, else retune nprobe and
        recalibrate."""
        self.logger.info("Optimizing storage...")
        self.meta.vacuum()
        if self.index is not None and self.index.ntotal:
            referenced = np.fromiter(self.meta.live_vec_ids(), dtype=np.int64)
            orphans = np.setdiff1d(
                np.arange(self.index.ntotal, dtype=np.int64), referenced)
            if len(orphans):
                removed = self.index.remove(orphans)
                if removed:
                    self.logger.info("Tombstoned %d orphaned vectors", removed)
        if self.index is not None and self.index.live != self.index.ntotal:
            self._data_version += 1
            mapping = self.index.compact()
            self.meta.update_vec_ids(mapping)
            self._rebuild_id_mappings()
            self.save_index()
        if not self._maybe_rebalance_index():
            self._maybe_autotune_nprobe()
            self._maybe_calibrate_quant(force=True)
        self.logger.info("Storage optimization complete")

    # -- stats ---------------------------------------------------------------

    def get_stats(self) -> Dict[str, Any]:
        stats = self.meta.stats()
        stats["projects"] = self.get_all_projects()
        index_size = (
            self.index_path.stat().st_size if self.index_path.exists() else 0
        )
        db_size = self.db_path.stat().st_size if self.db_path.exists() else 0
        stats.update({
            "faiss_index_size": index_size,
            "index_size": index_size,
            "database_size": db_size,
            "total_storage_size": index_size + db_size,
            "embedding_dimension": self.embedding_dim,
            "index_type": self.config.index_type,
            "storage_dtype": (
                self.index.dtype if self.index else self._effective_dtype()
            ),
            "live_vectors": self.index.live if self.index else 0,
            "tombstones": (
                (self.index.ntotal - self.index.live) if self.index else 0
            ),
        })
        nprobe_hint = getattr(self.index, "nprobe_hint", 0)
        if nprobe_hint:
            stats["ivf_nprobe_tuned"] = int(nprobe_hint)
        pq_tune = getattr(self.index, "_pq_tune_report", None)
        if pq_tune:
            stats["pq_tune"] = {
                key: pq_tune[key]
                for key in ("pq_m", "opq", "recall", "refine_factor",
                            "refine_recall", "target")
                if key in pq_tune
            }
        quant_cal = getattr(self.index, "_quant_cal", None)
        if quant_cal:
            stats["quant_cal"] = {
                key: quant_cal[key]
                for key in ("recall", "target", "refine_factor", "nprobe",
                            "target_unreachable", "sampled", "live")
                if key in quant_cal
            }
        if self._capability is not None:
            cap = self._capability
            info: Dict[str, Any] = {
                "backend": cap.backend,
                "gpu_available": cap.can_use_accelerator,
                "gpu_count": cap.device_count,
                "gpu_names": cap.device_names,
                "status_message": cap.status_message,
            }
            if cap.memory_total is not None:
                info["gpu_memory_total_gb"] = cap.memory_total / (1024**3)
            if cap.memory_free is not None:
                info["gpu_memory_free_gb"] = cap.memory_free / (1024**3)
            stats["device_info"] = info
        return stats
