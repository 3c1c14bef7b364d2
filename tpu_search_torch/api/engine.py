"""Index and search orchestration (the ``SearchEngine`` of the port).

Counterpart of ``tpu_search/api/engine.py``: one parser, chunker, encoder
and storage per engine, driving

- ``index_conversations``: incremental (unchanged files skip), chunk
  numbering continued from the stored maximum, files batched into waves
  of about 2048 chunks whose embeddings stay on the device from the
  encoder into the index, parse + chunk of upcoming files on one
  background thread, and one retry round for failed files;
- ``search_conversations``: the watcher daemon's warm query server when
  one listens on ``<data_dir>/query.sock`` (``use_warm_server``), else the
  fused path (``api/fused.py``: token ids in, encode + normalize + masked
  scan as one CUDA graph replay, one packed array back; exact on a flat
  index, the probe scan on an IVF one), else the classic path (embed,
  then scan) for the hashing encoder and more than 32 queries; hydrate
  from SQLite; with ``rerank`` (or ``CLAUDE_SEARCH_RERANK=1``) fetch
  ``top_k * factor`` (at most 100) and reorder them with the
  cross-encoder (``models/cross_encoder.py``;
  ``CLAUDE_SEARCH_RERANK_MODEL``, ``CLAUDE_SEARCH_RERANK_FACTOR``);
- ``optimize``: storage maintenance (vacuum, compact, rebalance, nprobe
  tuning, calibration);
- ``get_index_stats``, warm-server-first.

The device is explicit: ``device`` argument, else ``CLAUDE_SEARCH_DEVICE``,
else ``cuda``.  An error of the fused path (a capture, a build, a launch)
propagates; it never falls back to the classic path.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..devices.capability import resolve_device
from ..index.flat import FlatIndex, flat_scan
from ..index.ivf import IVFIndex, ivf_scan
from ..ingest.chunker import ChunkingConfig, ConversationChunker
from ..ingest.parser import JSONLParser
from ..models.cross_encoder import (
    CrossEncoder,
    CrossEncoderConfig,
    resolve_reranker_name,
)
from ..models.encoder import EmbeddingConfig, EmbeddingGenerator
from ..parallel.sharded_index import ShardedFlatIndex
from ..parallel.sharded_index import card_plan as sharded_flat_plan
from ..parallel.sharded_index import sharded_scan
from ..parallel.sharded_ivf import ShardedIVFIndex
from ..parallel.sharded_ivf import card_plan as sharded_ivf_plan
from ..parallel.sharded_ivf import sharded_ivf_scan
from ..storage.hybrid import (
    HybridStorage,
    SearchConfig,
    StorageConfig,
    resolve_nprobe,
)
from ..utils.profiling import PhaseTimer
from .fused import FusedPrograms, Window

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_DATA_DIR",
    "SearchEngine",
    "format_search_result",
    "rerank_fetch_k",
    "resolve_data_dir",
]

DEFAULT_DATA_DIR = "~/.claude-semantic-search/data"

# Cross-file embedding wave (chunks) and ingest lookahead (files), read
# from the environment once, as the JAX engine reads them; a lookahead of
# 0 parses and chunks each file on the calling thread (serial ingest).
_EMBED_WAVE_CHUNKS = int(os.environ.get("CLAUDE_SEARCH_EMBED_WAVE", 2048))
_PREFETCH_FILES = int(os.environ.get("CLAUDE_SEARCH_PREFETCH_FILES", 256))


class _FusedPending:
    """In-flight fused query: its packed output on its way to the host
    (``event`` marks the copy done; None on the CPU)."""

    __slots__ = ("packed", "k_eff", "q", "event")

    def __init__(self, packed, k_eff: int, q: int, event=None) -> None:
        self.packed = packed
        self.k_eff = k_eff
        self.q = q
        self.event = event


def format_search_result(result) -> Dict[str, Any]:
    """SearchResult -> the interface-facing dict (the CLI's result shape)."""
    meta = result.metadata or {}
    return {
        "chunk_id": result.chunk_id,
        "similarity": float(result.similarity),
        "text": result.text,
        "metadata": result.metadata,
        "project": meta.get("project_name", "unknown"),
        "session": meta.get("session_id", "unknown"),
        "timestamp": meta.get("timestamp", "unknown"),
        "has_code": meta.get("has_code", False),
    }


def rerank_fetch_k(top_k: int, spec: Dict[str, Any]) -> int:
    """Stage-1 fetch size for a rerank request: ``top_k * factor``, capped
    at 100 candidates (the cross-encoder's cost is linear in them)."""
    try:
        factor = int(spec.get("factor", 5) or 5)
    except (TypeError, ValueError, AttributeError):
        factor = 5  # a loose spec ({"rerank": true}): the default factor
    return min(max(top_k, top_k * max(1, factor)), max(top_k, 100))


def resolve_data_dir(data_dir: Optional[str] = None) -> str:
    """arg > $CLAUDE_SEARCH_DATA_DIR > default."""
    if data_dir is None:
        data_dir = os.environ.get("CLAUDE_SEARCH_DATA_DIR", DEFAULT_DATA_DIR)
    return str(Path(data_dir).expanduser())


def _env_choice(name: str, allowed: tuple) -> Optional[str]:
    value = os.environ.get(name)
    if value and value not in allowed:
        raise ValueError(f"{name}={value!r} is not one of {sorted(allowed)}")
    return value or None


def _env_number(name: str, kind: type, what: str):
    value = os.environ.get(name)
    if not value:
        return None
    try:
        return kind(value)
    except ValueError:
        raise ValueError(f"{name} must be {what}, got {value!r}") from None


def _storage_env() -> Dict[str, Any]:
    """The storage knobs of the environment, validated as the JAX engine
    validates them (``ValueError`` on a bad value):

    - ``CLAUDE_SEARCH_INDEX_TYPE`` = flat|ivf|hnsw,
      ``CLAUDE_SEARCH_STORAGE_DTYPE`` = float32|bfloat16|int8|int4|pq;
    - ``CLAUDE_SEARCH_REFINE`` = none|int8|bfloat16 (IVF refine tier),
      ``CLAUDE_SEARCH_REFINE_FACTOR`` = its stage-1 over-fetch (integer);
    - ``CLAUDE_SEARCH_NPROBE`` = fixed IVF probe count (integer, 0 = auto:
      the measured hint, else 8), returned under ``nprobe``;
    - ``CLAUDE_SEARCH_AUTOTUNE_RECALL`` = nprobe tuning target (float,
      <= 0 off).
    - ``CLAUDE_SEARCH_PQ_OPQ`` = 0|1, the OPQ rotation of
      ``storage_dtype="pq"`` (``pq_opq``);
    - ``CLAUDE_SEARCH_SHARD_DEVICES`` = device count (integer, 0 = auto:
      every card when there are two or more), passed on as
      ``shard_devices``: a flat index shards over that many devices
      (``parallel.ShardedFlatIndex``), an IVF index too
      (``parallel.ShardedIVFIndex``)."""
    kwargs: Dict[str, Any] = {}
    for env, key, allowed in (
        ("CLAUDE_SEARCH_INDEX_TYPE", "index_type", ("flat", "ivf", "hnsw")),
        ("CLAUDE_SEARCH_STORAGE_DTYPE", "storage_dtype",
         ("float32", "bfloat16", "int8", "int4", "pq")),
        ("CLAUDE_SEARCH_REFINE", "refine_dtype", ("none", "int8", "bfloat16")),
    ):
        value = _env_choice(env, allowed)
        if value:
            kwargs[key] = value
    opq = _env_choice("CLAUDE_SEARCH_PQ_OPQ", ("0", "1"))
    if opq:
        kwargs["pq_opq"] = opq == "1"
    for env, key, kind, what in (
        ("CLAUDE_SEARCH_REFINE_FACTOR", "refine_factor", int, "an integer"),
        ("CLAUDE_SEARCH_NPROBE", "nprobe", int, "an integer"),
        ("CLAUDE_SEARCH_AUTOTUNE_RECALL", "ivf_autotune_recall", float,
         "a float"),
    ):
        value = _env_number(env, kind, what)
        if value is not None:
            kwargs[key] = value
    shards = os.environ.get("CLAUDE_SEARCH_SHARD_DEVICES")
    if shards:
        try:
            kwargs["shard_devices"] = int(shards)
        except ValueError:
            raise ValueError(
                "CLAUDE_SEARCH_SHARD_DEVICES must be an integer "
                f"(0 = auto), got {shards!r}"
            ) from None
    return kwargs


class SearchEngine:
    """Index + search over the PyTorch components."""

    def __init__(
        self,
        data_dir: str = DEFAULT_DATA_DIR,
        use_gpu: bool = False,
        model_name: Optional[str] = None,
        save_interval_s: float = 30.0,
        use_warm_server: bool = True,
        *,
        device: Optional[str] = None,
    ) -> None:
        """The JAX engine's parameters, in its order, then ``device``
        (keyword only: ``cuda`` or ``cpu``, else ``CLAUDE_SEARCH_DEVICE``,
        else ``cuda``).  ``use_gpu`` is kept as an attribute;
        ``use_warm_server`` routes searches and stats through a listening
        warm server first (False inside the daemon, which is that
        server)."""
        if model_name is None:
            model_name = os.environ.get(
                "CLAUDE_SEARCH_MODEL", "all-mpnet-base-v2"
            )
        self.data_dir = Path(data_dir).expanduser()
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.use_gpu = use_gpu
        self.use_warm_server = use_warm_server
        self._timer = PhaseTimer()
        self._chunk_lock = threading.Lock()
        # One warm-server connection per thread (QueryClient is not
        # thread-safe), and the fused programs (CUDA graphs on the card).
        self._warm_clients = threading.local()
        self._fused = FusedPrograms()
        self.parser = JSONLParser()
        self.chunker = ConversationChunker(ChunkingConfig())
        self.embedder = EmbeddingGenerator(
            EmbeddingConfig(
                model_name=model_name,
                batch_size=8,  # raised on CUDA at load time
                cache_dir=str(self.data_dir / "models"),
                device=device,
            )
        )
        storage_kwargs = _storage_env()
        self._default_nprobe = storage_kwargs.pop("nprobe", 0)
        self.storage = HybridStorage(
            StorageConfig(
                data_dir=str(self.data_dir),
                embedding_dim=768,
                auto_save=True,
                save_interval_s=save_interval_s,
                device=device,
                **storage_kwargs,
            )
        )
        self.storage.timer = self._timer
        self._rerankers: Dict[str, Any] = {}
        self._reranker_failed: set = set()
        self._reranker_lock = threading.Lock()

    # -- discovery ----------------------------------------------------------

    def scan_claude_projects(
        self, base_path: str = "~/.claude/projects"
    ) -> List[Path]:
        base = Path(base_path).expanduser()
        if not base.exists():
            print(f"❌ Claude projects directory not found: {base}")
            sys.exit(1)
        files = list(base.rglob("*.jsonl"))
        if not files:
            print("❌ No JSONL files found in Claude projects directory")
            sys.exit(1)
        print(f"📁 Found {len(files)} conversation files")
        return files

    # -- indexing ------------------------------------------------------------

    def _open(self) -> None:
        if not self.embedder.is_model_loaded:
            self.embedder.load_model()
        self._sync_embedding_dim()
        self.storage.initialize()
        self._check_index_dim()

    def index_conversations(
        self,
        files: List[Path],
        force: bool = False,
        progress: Optional[Callable[[str], None]] = None,
    ) -> Dict[str, Any]:
        """Index files incrementally with one retry round for failures."""
        files = [Path(f) for f in files]
        report = progress or (lambda msg: None)
        if not self.embedder.is_model_loaded:
            self.embedder.load_model()
        self._sync_embedding_dim()
        self.storage.initialize()
        # Continue chunk numbering from the stored maximum, so an
        # incremental run never reuses another file's chunk ids.
        self.chunker.chunk_counter = max(
            self.chunker.chunk_counter, self.storage.meta.max_chunk_counter()
        )
        if force:
            self.storage.clear_all_data()
            dim = self.embedder.embedding_dimension
            if dim and self.storage.index is not None and (
                self.storage.index.dim != dim
            ):
                self.storage.rebuild_index(dim)
        self._check_index_dim()

        stats: Dict[str, Any] = {
            "files_processed": 0,
            "files_skipped": 0,
            "files_unchanged": 0,
            "chunks_created": 0,
            "chunks_indexed": 0,
            "chunks_removed": 0,
            "errors": [],
            "start_time": time.time(),
        }
        self._timer = PhaseTimer()
        self.storage.timer = self._timer
        failed: List[Path] = []
        wave: List[Tuple[Path, List[Any]]] = []
        wave_chunks = 0

        def fail(file_path: Path, exc: Exception) -> None:
            message = f"Error processing {file_path}: {exc}"
            stats["errors"].append(message)
            logger.error(message)
            failed.append(file_path)

        def flush_wave() -> None:
            nonlocal wave, wave_chunks
            if not wave:
                return
            batch, wave, wave_chunks = wave, [], 0
            all_chunks = [c for _, cs in batch for c in cs]
            removed_counted = False
            try:
                with self._timer.phase("embed"):
                    # Device-resident embeddings; the hashing encoder runs
                    # on the host and sets chunk.embedding instead.
                    emb = self.embedder.generate_embeddings_device(all_chunks)
                    if emb is None:
                        self.embedder.generate_embeddings(all_chunks)
                with self._timer.phase("store"):
                    removed = self.storage.remove_chunks_for_files(
                        [str(fp) for fp, _ in batch]
                    )
                    removed_counted = True
                    stats["chunks_removed"] += removed
                    self.storage.add_chunks(all_chunks, embeddings=emb)
            except Exception as exc:
                logger.warning(
                    "Wave embed/store failed (%s); retrying file-by-file", exc
                )
                for file_path, _ in batch:
                    try:
                        self._index_one_file(
                            file_path, stats, count_removed=not removed_counted
                        )
                    except Exception as file_exc:
                        fail(file_path, file_exc)
                return
            recorded = []
            try:
                with self._timer.phase("store"):
                    self.storage.update_file_infos(
                        [(str(fp), len(cs)) for fp, cs in batch]
                    )
                recorded = list(batch)
            except Exception as exc:
                logger.warning("Batched file-info update failed (%s)", exc)
                for file_path, chunks in batch:
                    try:
                        self.storage.update_file_info(str(file_path), len(chunks))
                        recorded.append((file_path, chunks))
                    except Exception as file_exc:
                        fail(file_path, file_exc)
            for _, chunks in recorded:
                stats["chunks_created"] += len(chunks)
                stats["chunks_indexed"] += len(chunks)
                stats["files_processed"] += 1

        def consume(file_path: Path, chunks: Optional[List[Any]]) -> None:
            nonlocal wave_chunks
            if not chunks:
                return
            if wave and wave_chunks + len(chunks) > _EMBED_WAVE_CHUNKS:
                flush_wave()
            wave.append((file_path, chunks))
            wave_chunks += len(chunks)
            if wave_chunks >= _EMBED_WAVE_CHUNKS:
                flush_wave()

        def candidates():
            for file_path in files:
                try:
                    if not force and not self.storage.is_file_modified(
                        str(file_path)
                    ):
                        stats["files_unchanged"] += 1
                        continue
                except Exception as exc:
                    fail(file_path, exc)
                    continue
                yield file_path

        if _PREFETCH_FILES > 0:
            # Parse + chunk of upcoming files runs on ONE worker thread
            # (chunk ids stay sequential in file order) while this thread
            # waits on the device in flush_wave.
            executor = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ingest")
            pending: deque = deque()
            source = candidates()
            drained = False
            try:
                while True:
                    while not drained and len(pending) < _PREFETCH_FILES:
                        nxt = next(source, None)
                        if nxt is None:
                            drained = True
                            break
                        pending.append((nxt, executor.submit(
                            self._prepare_one_file, nxt, stats,
                            remove=False)))
                    if not pending:
                        break
                    file_path, fut = pending.popleft()
                    try:
                        report(f"Processing {file_path.name}")
                        consume(file_path, fut.result())
                    except Exception as exc:
                        fail(file_path, exc)
            finally:
                executor.shutdown(wait=True)
        else:  # CLAUDE_SEARCH_PREFETCH_FILES=0: strictly serial ingest
            for file_path in candidates():
                try:
                    report(f"Processing {file_path.name}")
                    consume(file_path, self._prepare_one_file(
                        file_path, stats, remove=False))
                except Exception as exc:
                    fail(file_path, exc)
        flush_wave()

        if failed:
            report(f"Retrying {len(failed)} failed files")
            for file_path in list(failed):
                try:
                    self._index_one_file(file_path, stats)
                    stats["errors"] = [
                        e for e in stats["errors"] if file_path.name not in e
                    ]
                except Exception as exc:
                    logger.error("Retry failed for %s: %s", file_path, exc)

        if self.storage.config.auto_save:
            self.storage.save_index()
        stats["end_time"] = time.time()
        stats["duration"] = stats["end_time"] - stats["start_time"]
        stats["phases"] = self._timer.report()
        return stats

    def _sync_embedding_dim(self) -> None:
        dim = self.embedder.embedding_dimension
        if dim and not self.storage._initialized:
            self.storage.config.embedding_dim = dim
            self.storage.embedding_dim = dim

    def _check_index_dim(self) -> None:
        dim = self.embedder.embedding_dimension
        if dim and self.storage.index is not None and (
            self.storage.index.dim != dim
        ):
            raise RuntimeError(
                f"Encoder dim {dim} != existing index dim "
                f"{self.storage.index.dim}. Reindex with --force after "
                f"switching models."
            )

    def _prepare_one_file(
        self,
        file_path: Path,
        stats: Dict[str, Any],
        remove: bool = True,
        count_removed: bool = True,
    ) -> Optional[List[Any]]:
        """Parse + chunk one file; provenance-filled chunks or None."""
        if remove:
            removed = self.storage.remove_chunks_for_file(str(file_path))
            if removed and count_removed:
                stats["chunks_removed"] += removed
        with self._timer.phase("parse"):
            conversation = self.parser.parse_file(str(file_path))
        if conversation is None:
            stats["files_skipped"] += 1
            return None
        with self._timer.phase("chunk"), self._chunk_lock:
            chunks = self.chunker.chunk_conversation(conversation)
        if not chunks:
            stats["files_skipped"] += 1
            return None
        for chunk in chunks:
            chunk.metadata.setdefault("session_id", conversation.session_id)
            chunk.metadata.setdefault("project_name", conversation.project_name)
            chunk.metadata.setdefault("file_path", conversation.file_path)
        return chunks

    def _index_one_file(
        self, file_path: Path, stats: Dict[str, Any],
        count_removed: bool = True,
    ) -> None:
        chunks = self._prepare_one_file(
            file_path, stats, count_removed=count_removed
        )
        if chunks is None:
            return
        with self._timer.phase("embed"):
            self.embedder.generate_embeddings(chunks)
        with self._timer.phase("store"):
            self.storage.add_chunks(chunks)
            self.storage.update_file_info(str(file_path), len(chunks))
        stats["chunks_created"] += len(chunks)
        stats["chunks_indexed"] += len(chunks)
        stats["files_processed"] += 1

    # -- search --------------------------------------------------------------

    def search_conversations(
        self,
        query: str,
        filters: Optional[Dict[str, Any]] = None,
        top_k: int = 10,
        rerank: Optional[bool] = None,
        rerank_model: Optional[str] = None,
        rerank_factor: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Embed the query and run the filter-masked top-k scan: through
        the warm server when one listens, else the fused path, else the
        classic one; with ``rerank`` (``None`` defers to
        ``CLAUDE_SEARCH_RERANK``) reorder the top ``top_k * rerank_factor``
        with the cross-encoder."""
        spec = self._rerank_spec(rerank, rerank_model, rerank_factor)
        if self.use_warm_server:
            payload: Dict[str, Any] = {
                "op": "search", "query": query, "filters": filters,
                "top_k": top_k,
            }
            if spec:
                payload["rerank"] = spec
            response = self._warm_request(payload)
            if response is not None and response.get("ok"):
                return response["results"]
        self._open()
        fetch_k = rerank_fetch_k(top_k, spec) if spec else top_k
        cfg = SearchConfig(top_k=fetch_k, include_metadata=True,
                           include_text=True, nprobe=self._default_nprobe)
        results = self._fused_search(query, filters, cfg)
        if results is None:
            query_embedding = self.embedder.generate_single_embedding(query)
            results = self.storage.search(query_embedding, cfg, filters)
        formatted = [format_search_result(r) for r in results]
        if spec:
            formatted = self.rerank_results(query, formatted, top_k,
                                            model=spec["model"])
        return formatted

    # -- the fused query path ------------------------------------------------

    def _fused_search(
        self, query: str, filters: Optional[Dict[str, Any]],
        cfg: SearchConfig,
    ) -> Optional[List[Any]]:
        """One query through :meth:`_fused_search_many`."""
        many = self._fused_search_many([query], filters, cfg)
        return None if many is None else many[0]

    def _fused_search_many(
        self, queries: List[str], filters: Optional[Dict[str, Any]],
        cfg: SearchConfig,
    ) -> Optional[List[List[Any]]]:
        """Dispatch and collect in one call (the warm server splits them:
        :meth:`_fused_dispatch_many` on its worker thread,
        :meth:`_fused_collect` on its finisher pool)."""
        pending = self._fused_dispatch_many(queries, filters, cfg)
        if pending is None or isinstance(pending, list):
            return pending
        return self._fused_collect(pending, cfg)

    def _fused_window(
        self, queries: List[str], filters: Optional[Dict[str, Any]],
        cfg: SearchConfig,
    ):
        """The window :meth:`_fused_dispatch_many` runs (``api.fused.
        Window``), or its structural answer: None where the fused path
        does not apply (the hashing encoder, an empty or untrained index,
        more than 32 queries, ids past 2^24, which f32 packing would
        round), ``[[] ...]`` when the filter matches nothing or ``k`` is
        0.  A sharded index (flat or IVF) fuses: with every shard on the
        encoder's device as one program (the encode, each shard's scan, the
        merge, an IVF refine tier's rescore); with shards on several cards
        of this process, or on a mesh that gathers across processes, as one
        graph a card and stage (the window's ``plan``), the ranks'
        collectives run between the graphs.

        Across processes every rank calls :meth:`search_conversations`
        with the same queries, filters and ``top_k``, after the same
        writes (the SPMD contract of ``HybridStorage._index_mesh``).  The
        early returns above must then agree across the ranks, or one rank
        leaves the window while the others wait in its collective, so each
        depends on replicated state alone: the query count and ``top_k``
        (the same calls), the encoder (the same model), the index's global
        count, capacity, training and nprobe (the same writes on every
        rank), and the filter's emptiness, which depends on each rank's
        own SQLite and is therefore taken over every rank
        (``HybridStorage.matches_nothing``)."""
        q = len(queries)
        if q == 0:
            return []
        if q > 32:
            return None
        index = self.storage.index
        if index is None or index.ntotal == 0:
            return None
        sharded_ivf = isinstance(index, ShardedIVFIndex)
        is_ivf = sharded_ivf or isinstance(index, IVFIndex)
        is_sharded = sharded_ivf or isinstance(index, ShardedFlatIndex)
        if not (is_ivf or is_sharded or isinstance(index, FlatIndex)):
            return None
        if is_ivf and index.centroids is None:
            return None
        # capacity: S x the local capacity for a sharded index.
        if (index.ntotal if is_ivf else index.capacity) >= (1 << 24):
            return None
        parts = self.embedder.fused_parts()
        if parts is None:
            return None
        model, device, normalize, int8_ffn = parts
        plan = None
        if is_sharded and not index.colocated(device):
            plan = sharded_ivf_plan if sharded_ivf else sharded_flat_plan

        fmask = self.storage.filter_mask(filters)
        if self.storage.matches_nothing(fmask):
            return [[] for _ in range(q)]
        if sharded_ivf:
            nprobe = resolve_nprobe(cfg.nprobe, index)
            k_eff = min(cfg.top_k,
                        min(nprobe, index.nlist) * index._local_capacity)
            scan, (scan_key, buffers) = (sharded_ivf_scan,
                                         index.make_scan_fn(nprobe))
        elif is_ivf:
            nprobe = resolve_nprobe(cfg.nprobe, index)
            k_eff = min(cfg.top_k,
                        min(nprobe, index.nlist) * index._cluster_capacity)
            scan, (scan_key, buffers) = ivf_scan, index.make_scan_fn(nprobe)
        elif is_sharded:
            k_eff = min(cfg.top_k, index._local_capacity)
            scan, (scan_key, buffers) = sharded_scan, index.make_scan_fn()
        else:
            k_eff = min(cfg.top_k, index.capacity)
            scan, (scan_key, buffers) = flat_scan, index.make_scan_fn()
        if k_eff <= 0:
            return [[] for _ in range(q)]
        ids, mask = self.embedder.pack_batch(queries)
        return Window(
            model=model, ids=ids, mask=mask, q_pad=8 if q <= 8 else 32,
            staged=index.scan_staged(fmask),
            normalize=normalize, int8_ffn=int8_ffn,
            store_normalize=self.storage.config.normalize_embeddings,
            scan=scan, scan_key=scan_key, buffers=buffers, k=k_eff,
            device=device, plan=plan)

    def _fused_dispatch_many(
        self, queries: List[str], filters: Optional[Dict[str, Any]],
        cfg: SearchConfig,
    ):
        """The one-dispatch query path for up to 32 queries sharing a
        filter: token ids go to the device, encode -> normalize -> pad to
        ``q_pad`` -> masked scan -> top-k run as one program
        (``api/fused.py``; a CUDA graph replay on the card), and one packed
        ``[q_pad, 2k]`` array comes back.  Returns
        :meth:`_fused_window`'s structural answers (None, ``[[] ...]``),
        else a :class:`_FusedPending` for :meth:`_fused_collect`.  Any
        other failure raises."""
        window = self._fused_window(queries, filters, cfg)
        if not isinstance(window, Window):
            return window
        packed, event = self._fused.dispatch(window)
        return _FusedPending(packed=packed, k_eff=window.k, q=len(queries),
                             event=event)

    @staticmethod
    def _fused_fetch(pending) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatch's packed output: ``(scores [q, k],
        ids [q, k] int64)``, id ``-1`` where the score is not finite."""
        if pending.event is not None:
            pending.event.synchronize()
        packed = pending.packed.numpy()
        k_eff, q = pending.k_eff, pending.q
        scores = packed[:q, :k_eff]
        out_ids = np.rint(packed[:q, k_eff:]).astype(np.int64)
        out_ids[~np.isfinite(scores)] = -1
        return scores, out_ids

    def _fused_collect(self, pending, cfg: SearchConfig):
        """Fetch and hydrate a :meth:`_fused_dispatch_many` result."""
        return self.storage.hydrate_results(*self._fused_fetch(pending), cfg)

    def _fused_collect_wire(self, pending, cfg: SearchConfig):
        """Fetch and hydrate straight into pre-serialized result fragments
        (``HybridStorage.hydrate_wire``), the warm server's fast path."""
        return self.storage.hydrate_wire(*self._fused_fetch(pending), cfg)

    # -- cross-encoder reranking ---------------------------------------------

    def _rerank_spec(
        self,
        rerank: Optional[bool],
        model: Optional[str],
        factor: Optional[int],
    ) -> Optional[Dict[str, Any]]:
        """Resolve a rerank request (explicit arguments > environment) into
        ``{"factor", "model"}``, or None."""
        if rerank is None:
            rerank = os.environ.get("CLAUDE_SEARCH_RERANK", "") == "1"
        if not rerank:
            return None
        if factor is None:
            try:
                factor = int(os.environ.get("CLAUDE_SEARCH_RERANK_FACTOR",
                                            "5"))
            except ValueError:
                factor = 5
        return {"factor": max(1, factor),
                "model": resolve_reranker_name(model)}

    def _get_reranker(self, model_name: Optional[str] = None):
        """The cached cross-encoder, loaded on first use.  A checkpoint
        that is missing (``FileNotFoundError``) or has no classification
        head (``ValueError``) is remembered and degrades to bi-encoder
        order with one warning; any other error (the device, a kernel)
        propagates."""
        name = resolve_reranker_name(model_name)
        with self._reranker_lock:
            if name in self._rerankers:
                return self._rerankers[name]
            if name in self._reranker_failed:
                return None
            # resolved outside the try: a device error is not a missing
            # checkpoint
            device = resolve_device(self.embedder.config.device)
            encoder = CrossEncoder(CrossEncoderConfig(
                model_name=name,
                cache_dir=str(self.data_dir / "models"),
                device=str(device),
            ))
            try:
                encoder.load_model()
            except (FileNotFoundError, ValueError) as exc:
                logger.warning(
                    "Reranker %r unavailable (%s); results keep the "
                    "bi-encoder order.", name, exc,
                )
                self._reranker_failed.add(name)
                return None
            self._rerankers[name] = encoder
            return encoder

    def rerank_results(
        self,
        query: str,
        results: List[Dict[str, Any]],
        top_k: int,
        model: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """Reorder formatted results by cross-encoder relevance (stable on
        ``(-score, i)``) and cut to ``top_k``; each kept result gains
        ``rerank_score`` beside its bi-encoder ``similarity``."""
        reranker = self._get_reranker(model)
        if reranker is None or not results:
            return results[:top_k]
        pairs = [(query, result.get("text") or "") for result in results]
        scores = reranker.predict(pairs)
        order = sorted(range(len(results)), key=lambda i: (-scores[i], i))
        reranked = []
        for i in order[:top_k]:
            result = dict(results[i])
            result["rerank_score"] = float(scores[i])
            reranked.append(result)
        return reranked

    # -- maintenance ---------------------------------------------------------

    def optimize(self) -> None:
        """Storage maintenance: vacuum, compact, rebalance, tune nprobe."""
        self.storage.initialize()
        self.storage.optimize()

    # -- stats ---------------------------------------------------------------

    def get_index_stats(self) -> Dict[str, Any]:
        """Index statistics, from the warm server when one listens (its
        engine is already open)."""
        if self.use_warm_server:
            response = self._warm_request({"op": "stats"})
            if response is not None and response.get("ok"):
                return response["stats"]
        self.storage.initialize()
        return self.storage.get_stats()

    def _warm_request(
        self, payload: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Send one request to the warm server down this thread's
        persistent connection; None when no server is listening (the
        caller then serves locally)."""
        from ..interfaces.query_server import QueryClient, socket_path_for

        client = getattr(self._warm_clients, "client", None)
        if client is None or client._path != str(
            socket_path_for(str(self.data_dir))
        ):
            client = QueryClient(str(self.data_dir))
            self._warm_clients.client = client
        try:
            return client.request(payload)
        except (OSError, ValueError):
            return None


# Reference-compatible name.
SemanticSearchCLI = SearchEngine
