"""Batched embedding generation (the ``EmbeddingGenerator`` of the port).

Counterpart of ``tpu_search/models/encoder.py``: host tokenization feeds
the encoder module (MPNet, BERT or XLM-R, with the checkpoint's pooling) in
shape buckets.

- The tokenizer follows the assets the model directory ships: byte-level
  BPE (``vocab.json`` + ``merges.txt`` or a BPE ``tokenizer.json``) first,
  then sentencepiece unigram for ``arch="xlmr"`` or sentencepiece assets,
  else WordPiece ``vocab.txt``.
- A model directory without ``model.tpu.npz`` but with HF weights is
  converted once (``convert.convert_pretrained_dir``).
- ``hash-<dim>`` selects the weight-free hashing encoder on the host
  (``models/hashing.py``), for tests and offline use.

- Sequence and batch sizes pad up to ``SEQ_BUCKETS`` / ``BATCH_BUCKETS``;
  texts are encoded longest-first so each bucket is dense.  Pad rows of a
  batch carry one live token, so the masked mean never divides by zero.
- bf16 compute by default; pooling and the L2 normalize run in f32.
- The device is explicit (``EmbeddingConfig.device``, else
  ``CLAUDE_SEARCH_DEVICE``, else ``cuda``); asking for CUDA without one
  raises.
- On CUDA in bf16 the W8A8 FFN kernel is on by default behind a load-time
  gate: 16 synthetic sequences through the bf16 and the int8 FFN must
  agree to a minimum embedding cosine of 0.999.  The verdict is cached as
  ``int8_ffn_check.cuda.json`` next to the checkpoint (the JAX package's
  ``int8_ffn_check.json`` judges a different kernel); an unreadable
  marker is measured again and rewritten.  An exception in the gate's
  forward propagates; only a measured cosine below the threshold selects
  the bf16 FFN, and that choice is logged.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices.capability import (
    assess_device_capability,
    calculate_optimal_batch_size,
    resolve_device,
)
from ..ingest.chunker import Chunk
from ..utils.shapes import ADD_ROW_BUCKETS, bucket_size
from .bpe_tokenizer import ByteLevelBPETokenizer, has_bpe_assets
from .convert import convert_pretrained_dir, load_checkpoint, model_from_params
from .hashing import HashingEncoder
from .mpnet import MPNetConfig, MPNetModel
from .sp_tokenizer import UnigramTokenizer, has_sp_assets
from .tokenizer import WordPieceTokenizer

logger = logging.getLogger(__name__)

__all__ = ["EmbeddingConfig", "EmbeddingGenerator", "EmbeddingStats"]

SEQ_BUCKETS = (64, 128, 256, 384)
BATCH_BUCKETS = (1, 8, 32, 128, 512)

INT8_GATE_FILE = "int8_ffn_check.cuda.json"
INT8_GATE_THRESHOLD = 0.999

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class EmbeddingConfig:
    model_name: str = "all-mpnet-base-v2"
    batch_size: int = 16
    max_seq_length: int = 384
    device: Optional[str] = None  # None -> $CLAUDE_SEARCH_DEVICE -> "cuda"
    auto_batch_size: bool = True
    normalize_embeddings: bool = True
    show_progress: bool = True
    cache_dir: Optional[str] = None
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    # None = on behind the load-time gate (CUDA + bf16); True/False force
    # it; CLAUDE_SEARCH_INT8_FFN=1/0 overrides both.
    quantize_ffn: Optional[bool] = None
    apply_prompts: bool = True


@dataclass
class EmbeddingStats:
    """What :meth:`EmbeddingGenerator.get_embedding_stats` reports (the
    JAX package's fields)."""

    total_chunks: int = 0
    total_tokens: int = 0
    generation_time: float = 0.0
    average_chunk_length: float = 0.0
    throughput_chunks_per_second: float = 0.0
    model_info: Dict[str, Any] = field(default_factory=dict)


class EmbeddingGenerator:
    """Text chunks -> dense vectors through ``MPNetModel``."""

    def __init__(self, config: Optional[EmbeddingConfig] = None) -> None:
        self.config = config or EmbeddingConfig()
        self.logger = logger
        self._model: Optional[MPNetModel] = None
        self._model_config: Optional[MPNetConfig] = None
        self._tokenizer = None  # WordPiece, byte-level BPE or unigram
        self._hash_encoder: Optional[HashingEncoder] = None
        self._prompts: Dict[str, str] = {}
        self._default_prompt_name: Optional[str] = None
        self._embedding_dim: Optional[int] = None
        self._device: Optional[torch.device] = None
        self._int8_ffn = False
        self.int8_gate: Dict[str, Any] = {}
        # The native WordPiece handle encodes into one shared buffer, so
        # one thread tokenizes at a time (the warm server's dispatch
        # thread and an in-process search may both tokenize).
        self._tokenize_lock = threading.Lock()

    # -- model loading -------------------------------------------------------

    @property
    def is_model_loaded(self) -> bool:
        return self._model is not None or self._hash_encoder is not None

    @property
    def embedding_dimension(self) -> Optional[int]:
        return self._embedding_dim

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def load_model(self) -> None:
        name = self.config.model_name
        if name.startswith("hash"):
            dim = int(name.split("-")[1]) if "-" in name else 768
            self._hash_encoder = HashingEncoder(dim=dim)
            self._embedding_dim = dim
            self.logger.info("Loaded deterministic hashing encoder (%dd)", dim)
            return
        cache_dir = Path(
            self.config.cache_dir or "~/.claude-semantic-search/data/models"
        ).expanduser()
        model_dir = cache_dir / name
        params, model_config = load_model_dir(model_dir, name)
        dtype = _DTYPES[self.config.compute_dtype]
        device = resolve_device(self.config.device)
        model = model_from_params(params, model_config)
        del params
        model.layers.to(dtype)
        self._model = model.to(device)
        self._model_config = model_config
        self._device = device
        self._tokenizer = load_tokenizer(model_dir, model_config)
        self._load_prompts(model_dir)
        self._embedding_dim = model_config.hidden_size

        can_int8 = dtype == torch.bfloat16 and device.type == "cuda"
        pref = self.config.quantize_ffn
        env = os.environ.get("CLAUDE_SEARCH_INT8_FFN", "")
        if env in ("0", "1"):
            pref = env == "1"
        if pref is None and can_int8:
            self._int8_ffn = self._int8_ffn_gate(model_dir)
        else:
            self._int8_ffn = bool(pref) and can_int8
        if self._int8_ffn:
            self._model.quantize_ffn()

        if self.config.auto_batch_size and device.type == "cuda":
            cap = assess_device_capability(device)
            self.config.batch_size = min(
                128,
                calculate_optimal_batch_size(cap.memory_free / 1024**3),
            )
            self.logger.info("Auto-adjusted batch size: %d",
                             self.config.batch_size)
        self.logger.info(
            "Model loaded on %s (%s, int8 FFN %s). Embedding dimension: %d",
            device, self.config.compute_dtype,
            "on" if self._int8_ffn else "off", self._embedding_dim,
        )

    def _int8_ffn_gate(
        self, model_dir: Path, threshold: float = INT8_GATE_THRESHOLD
    ) -> bool:
        marker = Path(model_dir) / INT8_GATE_FILE
        try:
            cached = json.loads(marker.read_text()) if marker.exists() else {}
        except (OSError, ValueError):
            cached = {}  # unreadable: measure again and rewrite it
        if isinstance(cached, dict) and cached.get("threshold") == threshold:
            self.int8_gate = cached
            return bool(cached.get("ok"))
        cfg = self._model_config
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(
            rng.integers(4, max(8, cfg.vocab_size), size=(16, 64))
        ).to(self._device)
        mask = torch.ones((16, 64), dtype=torch.int32, device=self._device)
        self._model.quantize_ffn()
        with torch.inference_mode():
            base = self._model(ids, mask, int8_ffn=False)
            quant = self._model(ids, mask, int8_ffn=True)
        min_cos = float((base * quant).sum(dim=1).min())
        result = {"ok": min_cos >= threshold, "threshold": threshold,
                  "min_cosine": min_cos}
        if result["ok"]:
            self.logger.info(
                "int8-FFN gate passed (min cosine %.5f >= %.3f)",
                min_cos, threshold,
            )
        else:
            self.logger.warning(
                "int8-FFN gate: min cosine %.5f < %.3f; using the bf16 FFN",
                min_cos, threshold,
            )
        try:
            marker.write_text(json.dumps(result))
        except OSError:
            pass
        self.int8_gate = result
        return result["ok"]

    def _load_prompts(self, model_dir: Path) -> None:
        self._prompts = {}
        self._default_prompt_name = None
        if not self.config.apply_prompts:
            return
        spec_path = model_dir / "config_sentence_transformers.json"
        if not spec_path.exists():
            return
        try:
            spec = json.loads(spec_path.read_text())
        except (ValueError, OSError):
            return
        prompts = spec.get("prompts")
        if isinstance(prompts, dict):
            self._prompts = {
                k: v for k, v in prompts.items() if isinstance(v, str) and v
            }
        name = spec.get("default_prompt_name")
        if isinstance(name, str) and name in self._prompts:
            self._default_prompt_name = name

    def _prompt_for(self, kind: str) -> str:
        if not self._prompts:
            return ""
        keys = ("query",) if kind == "query" else ("passage", "document")
        for key in keys:
            if key in self._prompts:
                return self._prompts[key]
        if self._default_prompt_name:
            return self._prompts[self._default_prompt_name]
        return ""

    # -- embedding -----------------------------------------------------------

    def _validated(self, texts: Sequence[Any], prefix: str = "") -> List[str]:
        out = []
        for i, text in enumerate(texts):
            if text is None:
                self.logger.warning("Chunk %d: text is None", i)
                text = ""
            elif not isinstance(text, str):
                self.logger.warning(
                    "Chunk %d: text is not a string (%s)", i, type(text)
                )
                text = str(text) if text else ""
            elif not text.strip():
                self.logger.warning("Chunk %d: text is empty", i)
                text = "empty"
            out.append(prefix + text if prefix else text)
        return out

    def generate_embeddings(self, chunks: List[Chunk]) -> List[np.ndarray]:
        """Embed chunks on the host side (sets ``chunk.embedding``)."""
        if not self.is_model_loaded:
            self.load_model()
        if not chunks:
            return []
        start = time.time()
        texts = self._validated([c.text for c in chunks],
                                self._prompt_for("document"))
        embeddings = self._encode_texts(texts)
        for chunk, embedding in zip(chunks, embeddings):
            chunk.embedding = embedding.tolist()
        if self.config.show_progress:
            elapsed = time.time() - start
            self.logger.info("Generated %d embeddings in %.2fs",
                             len(chunks), elapsed)
        return list(embeddings)

    def generate_embeddings_device(self, chunks: List[Chunk]) -> torch.Tensor:
        """``[Npad, dim]`` f32 embeddings on the model's device, in chunk
        order, rows past ``len(chunks)`` zero (``ADD_ROW_BUCKETS``);
        ``chunk.embedding`` stays unset.  The index appends it with no
        host round trip.  None with the hashing encoder (it runs on the
        host: the caller takes :meth:`generate_embeddings`)."""
        if not self.is_model_loaded:
            self.load_model()
        if self._hash_encoder is not None:
            return None
        texts = self._validated([c.text for c in chunks],
                                self._prompt_for("document"))
        return self.encode_texts_to_device(texts)

    def generate_single_embedding(self, text: str) -> np.ndarray:
        """Embed one search query (the query-side prompt applies)."""
        if not self.is_model_loaded:
            self.load_model()
        prompt = self._prompt_for("query")
        return self._encode_texts([prompt + text if prompt else text])[0]

    def pack_batch(
        self, texts: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize queries (the query-side prompt applies) into
        ``(ids int64, mask int32)`` host arrays, the sequence padded to its
        ``SEQ_BUCKETS`` bucket and the rows to their ``BATCH_BUCKETS``
        bucket; pad rows carry one live token, so the masked mean never
        divides by zero.  The fused query path ships these, not
        embeddings, to the device."""
        prompt = self._prompt_for("query")
        if prompt:
            texts = [prompt + t for t in texts]
        encoded = self._tokenize(texts)
        seq_pad = bucket_size(max(len(s) for s in encoded), SEQ_BUCKETS)
        batch_pad = bucket_size(len(encoded), BATCH_BUCKETS)
        ids = np.full((batch_pad, seq_pad), self._tokenizer.pad_id,
                      dtype=np.int64)
        mask = np.zeros((batch_pad, seq_pad), dtype=np.int32)
        for row, seq in enumerate(encoded):
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        mask[len(encoded):, 0] = 1
        return ids, mask

    def _tokenize(self, texts: Sequence[str]) -> List[List[int]]:
        with self._tokenize_lock:
            return [self._tokenizer.encode(t, self.config.max_seq_length)
                    for t in texts]

    def fused_parts(self) -> Optional[tuple]:
        """``(model, device, normalize, int8_ffn)`` for composing the
        encoder into a larger program (the fused query path), the int8 FFN
        as the load-time gate resolved it.  None for the hashing encoder:
        it runs on the host, so there is nothing to fuse."""
        if self._hash_encoder is not None or self._model is None:
            return None
        return (self._model, self._device,
                self.config.normalize_embeddings, self._int8_ffn)

    def _encode_batches(self, texts: Sequence[str]):
        """Tokenize, order longest-first, encode each bucketed batch.
        Returns ``[(batch_idx, n_live, [Bpad, dim] f32 device tensor)]``."""
        encoded = self._tokenize(texts)
        order = sorted(
            range(len(encoded)), key=lambda i: len(encoded[i]), reverse=True
        )
        pending = []
        cap = max(1, self.config.batch_size)
        for start in range(0, len(order), cap):
            batch_idx = order[start: start + cap]
            seqs = [encoded[i] for i in batch_idx]
            seq_pad = bucket_size(max(len(s) for s in seqs), SEQ_BUCKETS)
            batch_pad = bucket_size(len(seqs), BATCH_BUCKETS)
            ids = np.full((batch_pad, seq_pad), self._tokenizer.pad_id,
                          dtype=np.int64)
            mask = np.zeros((batch_pad, seq_pad), dtype=np.int32)
            for row, seq in enumerate(seqs):
                ids[row, : len(seq)] = seq
                mask[row, : len(seq)] = 1
            mask[len(seqs):, 0] = 1  # pad rows need one live token (mean)
            with torch.inference_mode():
                vecs = self._model(
                    torch.from_numpy(ids).to(self._device),
                    torch.from_numpy(mask).to(self._device),
                    normalize=self.config.normalize_embeddings,
                    int8_ffn=self._int8_ffn,
                )
            pending.append((batch_idx, len(seqs), vecs))
        return pending

    def _encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        if self._hash_encoder is not None:
            return self._hash_encoder.encode(
                texts, normalize=self.config.normalize_embeddings)
        out = np.zeros((len(texts), self._embedding_dim), dtype=np.float32)
        for batch_idx, n_live, vecs in self._encode_batches(texts):
            out[batch_idx] = vecs[:n_live].float().cpu().numpy()
        return out

    def encode_texts_to_device(self, texts: Sequence[str]) -> torch.Tensor:
        n = len(texts)
        npad = bucket_size(max(n, 1), ADD_ROW_BUCKETS)
        out = torch.zeros((npad, self._embedding_dim), dtype=torch.float32,
                          device=self._device)
        for batch_idx, n_live, vecs in self._encode_batches(texts):
            rows = torch.as_tensor(batch_idx, dtype=torch.long,
                                   device=self._device)
            out.index_copy_(0, rows, vecs[:n_live].float())
        return out

    # -- similarity utilities (the JAX package's, on the host) ---------------

    def compute_similarity(self, a: np.ndarray, b: np.ndarray) -> float:
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))

    def compute_similarity_matrix(
        self, embeddings: List[np.ndarray]
    ) -> np.ndarray:
        mat = np.asarray(embeddings, dtype=np.float32)
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        unit = mat / np.clip(norms, 1e-12, None)
        return unit @ unit.T

    def find_similar_chunks(
        self,
        query_embedding: np.ndarray,
        chunk_embeddings: List[np.ndarray],
        top_k: int = 5,
    ) -> List[Tuple[int, float]]:
        sims = [(i, self.compute_similarity(query_embedding, e))
                for i, e in enumerate(chunk_embeddings)]
        sims.sort(key=lambda pair: pair[1], reverse=True)
        return sims[:top_k]

    # -- stats and persistence (the JAX package's npz layout) ----------------

    def get_embedding_stats(self, chunks: List[Chunk]) -> EmbeddingStats:
        if not chunks:
            return EmbeddingStats()
        return EmbeddingStats(
            total_chunks=len(chunks),
            total_tokens=sum(len(c.text.split()) for c in chunks),
            average_chunk_length=float(np.mean([len(c.text) for c in chunks])),
            model_info=self.get_model_info(),
        )

    def save_embeddings(self, chunks: List[Chunk], file_path: str) -> None:
        """The chunks that carry an embedding, as one object array
        ``embeddings`` of ``{chunk_id, embedding, text, metadata}``."""
        rows = [{"chunk_id": c.id, "embedding": c.embedding, "text": c.text,
                 "metadata": c.metadata} for c in chunks if c.embedding]
        np.savez_compressed(file_path,
                            embeddings=np.asarray(rows, dtype=object))
        self.logger.info("Saved %d embeddings to %s", len(rows), file_path)

    def load_embeddings(self, file_path: str) -> List[Chunk]:
        data = np.load(file_path, allow_pickle=True)
        chunks = [Chunk(id=item["chunk_id"], text=item["text"],
                        metadata=item["metadata"],
                        embedding=item["embedding"])
                  for item in data["embeddings"]]
        self.logger.info("Loaded %d embeddings from %s", len(chunks),
                         file_path)
        return chunks

    def validate_embeddings(self, chunks: List[Chunk]) -> Dict[str, Any]:
        results: Dict[str, Any] = {
            "total_chunks": len(chunks),
            "chunks_with_embeddings": 0,
            "embedding_dimension": None,
            "embedding_stats": {},
            "issues": [],
        }
        embeddings = []
        for chunk in chunks:
            if not chunk.embedding:
                results["issues"].append(
                    f"Missing embedding for chunk {chunk.id}")
                continue
            results["chunks_with_embeddings"] += 1
            embeddings.append(np.asarray(chunk.embedding))
            if results["embedding_dimension"] is None:
                results["embedding_dimension"] = len(chunk.embedding)
            elif results["embedding_dimension"] != len(chunk.embedding):
                results["issues"].append(
                    f"Inconsistent embedding dimension for chunk {chunk.id}")
        if not embeddings:
            return results
        if len({len(e) for e in embeddings}) == 1:
            arr = np.asarray(embeddings)
            norms = np.linalg.norm(arr, axis=1)
            results["embedding_stats"] = {
                "mean": np.mean(arr, axis=0).tolist(),
                "std": np.std(arr, axis=0).tolist(),
                "min": np.min(arr, axis=0).tolist(),
                "max": np.max(arr, axis=0).tolist(),
                "norm_mean": float(np.mean(norms)),
                "norm_std": float(np.std(norms)),
            }
        else:
            norms = [np.linalg.norm(e) for e in embeddings]
            results["embedding_stats"] = {
                "norm_mean": float(np.mean(norms)),
                "norm_std": float(np.std(norms)),
                "note": "Embeddings have different dimensions",
            }
        return results

    # -- device facts and timing ---------------------------------------------

    def benchmark_model(
        self, test_texts: List[str], warmup_runs: int = 3
    ) -> Dict[str, Any]:
        """Encode ``test_texts`` at each batch size up to their count, on
        the encoder's device, timed between device synchronizations."""
        if not self.is_model_loaded:
            self.load_model()

        def sync() -> None:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)

        for _ in range(warmup_runs):
            self._encode_texts(test_texts[: min(5, len(test_texts))])
        results = {}
        saved = self.config.batch_size
        try:
            for batch_size in (1, 4, 8, 16, 32, 128):
                if batch_size > len(test_texts):
                    continue
                self.config.batch_size = batch_size
                sync()
                start = time.perf_counter()
                self._encode_texts(test_texts)
                sync()
                total = time.perf_counter() - start
                results[f"batch_size_{batch_size}"] = {
                    "total_time": total,
                    "throughput": len(test_texts) / total,
                    "avg_time_per_text": total / len(test_texts),
                }
        finally:
            self.config.batch_size = saved
        return {
            "model_name": self.config.model_name,
            "device": str(self._device),
            "embedding_dimension": self._embedding_dim,
            "test_texts_count": len(test_texts),
            "performance": results,
            "memory_info": self._memory_info(),
        }

    def _memory_info(self) -> Dict[str, Any]:
        """The CUDA device's name and memory (bytes); empty off CUDA."""
        if self._device is None or self._device.type != "cuda":
            return {}
        free, total = torch.cuda.mem_get_info(self._device)
        return {
            "device_name": torch.cuda.get_device_name(self._device),
            "bytes_in_use": torch.cuda.memory_allocated(self._device),
            "bytes_limit": int(total),
            "bytes_free": int(free),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(
                self._device),
        }

    def get_model_info(self) -> Dict[str, Any]:
        if not self.is_model_loaded:
            return {}
        info: Dict[str, Any] = {
            "model_name": self.config.model_name,
            "embedding_dimension": self._embedding_dim,
            "max_seq_length": self.config.max_seq_length,
            "device": str(self._device),
            "batch_size": self.config.batch_size,
            "use_gpu": self.is_using_gpu,
            "compute_dtype": self.config.compute_dtype,
            "gpu_available": torch.cuda.is_available(),
        }
        if self._prompts:
            info["prompts"] = dict(self._prompts)
            info["default_prompt_name"] = self._default_prompt_name
        return info

    @property
    def is_using_gpu(self) -> bool:
        return self._device is not None and self._device.type == "cuda"


def load_model_dir(model_dir: Path, name: str) -> Tuple[Dict[str, Any],
                                                       MPNetConfig]:
    """``(numpy parameter tree, config)`` of a model directory: its
    ``model.tpu.npz``, else its HF weights converted once into one."""
    ckpt = model_dir / "model.tpu.npz"
    if ckpt.exists():
        return load_checkpoint(str(ckpt))
    if model_dir.exists():
        logger.info("Converting torch checkpoint in %s to native format",
                    model_dir)
        return convert_pretrained_dir(str(model_dir), str(ckpt))
    raise FileNotFoundError(
        f"Model '{name}' not found under {model_dir.parent}: put its "
        f"model.tpu.npz (or HF weights) and tokenizer there, or use model "
        f"name 'hash-768' for the weight-free fallback encoder."
    )


def load_tokenizer(model_dir: Path, config: MPNetConfig):
    """The tokenizer the directory's assets select: byte-level BPE (the
    RoBERTa family) first, then sentencepiece unigram (``arch="xlmr"`` or
    sentencepiece assets), else WordPiece, as ``tpu_search`` dispatches."""
    if has_bpe_assets(model_dir):
        return ByteLevelBPETokenizer.from_pretrained_dir(str(model_dir))
    if config.arch == "xlmr" or has_sp_assets(model_dir):
        return UnigramTokenizer.from_pretrained_dir(str(model_dir))
    return WordPieceTokenizer.from_pretrained_dir(str(model_dir))
