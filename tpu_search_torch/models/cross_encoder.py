"""Cross-encoder reranker: joint (query, passage) relevance scoring.

Counterpart of ``tpu_search/models/cross_encoder.py`` (sentence-transformers
``CrossEncoder`` semantics, cross-encoder/ms-marco-MiniLM-L-6-v2 and
friends): one ``BertForSequenceClassification`` forward reads the query and
a candidate together (``MPNetModel.classify``), so the second stage can
reorder the bi-encoder's top ``k * factor``.

- Pairs are WordPiece-encoded as ``[CLS] a [SEP] b [SEP]`` with token types
  (longest-first truncation to the model's position table), sorted longest
  first into ``SEQ_BUCKETS`` x ``BATCH_BUCKETS`` padded batches; pad rows
  carry one live token.
- Compute is bf16 on CUDA and f32 on the CPU; the head runs in f32.  The
  attention kernels run for every bucket (the JAX package's "Pallas only at
  S >= 512" rule is a TPU measurement).
- ``num_labels == 1`` scores are the sigmoid of the logit; more labels give
  the largest logit.
- ``hash-<dim>`` names select the lexical fallback: the cosine of
  :class:`HashingEncoder` vectors, no weights.

The device is explicit (``CrossEncoderConfig.device``, else
``CLAUDE_SEARCH_DEVICE``, else ``cuda``); asking for CUDA without one
raises.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..utils.shapes import bucket_size
from .convert import model_from_params
from .encoder import load_model_dir
from .hashing import HashingEncoder
from .mpnet import MPNetConfig, MPNetModel
from .tokenizer import WordPieceTokenizer

logger = logging.getLogger(__name__)

__all__ = [
    "BATCH_BUCKETS",
    "CrossEncoder",
    "CrossEncoderConfig",
    "DEFAULT_RERANK_MODEL",
    "SEQ_BUCKETS",
    "resolve_reranker_name",
]

DEFAULT_RERANK_MODEL = "ms-marco-MiniLM-L-6-v2"

SEQ_BUCKETS = (64, 128, 256, 384, 512)
BATCH_BUCKETS = (1, 8, 32, 128)


@dataclass
class CrossEncoderConfig:
    """Reranker knobs (sentence-transformers ``CrossEncoder`` parity)."""

    model_name: str = DEFAULT_RERANK_MODEL
    batch_size: int = 128
    device: Optional[str] = None  # None -> $CLAUDE_SEARCH_DEVICE -> "cuda"
    cache_dir: Optional[str] = None


class CrossEncoder:
    """(query, passage) pairs -> relevance scores through ``classify``."""

    def __init__(self, config: Optional[CrossEncoderConfig] = None) -> None:
        self.config = config or CrossEncoderConfig()
        self._model: Optional[MPNetModel] = None
        self._model_config: Optional[MPNetConfig] = None
        self._tokenizer: Optional[WordPieceTokenizer] = None
        self._hash_encoder: Optional[HashingEncoder] = None
        self._device: Optional[torch.device] = None

    @property
    def is_model_loaded(self) -> bool:
        return self._model is not None or self._hash_encoder is not None

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def load_model(self) -> None:
        """Load the classifier (``FileNotFoundError`` when it is missing,
        ``ValueError`` when the checkpoint has no classification head)."""
        name = self.config.model_name
        if name.startswith("hash"):
            dim = int(name.split("-")[1]) if "-" in name else 768
            self._hash_encoder = HashingEncoder(dim=dim)
            logger.info("Loaded lexical fallback reranker (%dd hash)", dim)
            return
        cache_dir = Path(
            self.config.cache_dir or "~/.claude-semantic-search/data/models"
        ).expanduser()
        model_dir = cache_dir / name
        device = resolve_device(self.config.device)
        params, model_config = load_model_dir(model_dir, name)
        if model_config.num_labels < 1:
            raise ValueError(
                f"Model '{name}' has no classification head — it is an "
                f"embedding model, not a cross-encoder."
            )
        bf16 = device.type == "cuda"
        model = model_from_params(params, model_config)
        del params
        model.layers.to(torch.bfloat16 if bf16 else torch.float32)
        self._model = model.to(device)
        self._model_config = model_config
        self._device = device
        self._tokenizer = WordPieceTokenizer.from_pretrained_dir(str(model_dir))
        logger.info("Reranker '%s' loaded on %s (%d layers, %s)", name,
                    device, model_config.num_layers,
                    "bf16" if bf16 else "f32")

    @property
    def max_length(self) -> int:
        """Pair length: the position table, at most the largest bucket."""
        return min(SEQ_BUCKETS[-1], self._model_config.max_position)

    # -- scoring -------------------------------------------------------------

    def predict(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Score pairs -> float32 ``[N]`` (sigmoid for num_labels == 1,
        matching sentence-transformers' default activation)."""
        if not self.is_model_loaded:
            self.load_model()
        if len(pairs) == 0:
            return np.zeros((0,), dtype=np.float32)
        if self._hash_encoder is not None:
            vecs_a = self._hash_encoder.encode([a for a, _ in pairs])
            vecs_b = self._hash_encoder.encode([b for _, b in pairs])
            return np.sum(vecs_a * vecs_b, axis=1).astype(np.float32)

        tok = self._tokenizer
        max_len = self.max_length
        encoded = [tok.encode_pair(a, b, max_len) for a, b in pairs]
        order = sorted(range(len(encoded)), key=lambda i: len(encoded[i][0]),
                       reverse=True)
        pending = []
        cap = max(1, self.config.batch_size)
        for start in range(0, len(order), cap):
            batch_idx = order[start: start + cap]
            seqs = [encoded[i] for i in batch_idx]
            seq_pad = bucket_size(max(len(ids) for ids, _ in seqs), SEQ_BUCKETS)
            batch_pad = bucket_size(len(seqs), BATCH_BUCKETS)
            ids = np.full((batch_pad, seq_pad), tok.pad_id, dtype=np.int64)
            types = np.zeros((batch_pad, seq_pad), dtype=np.int64)
            mask = np.zeros((batch_pad, seq_pad), dtype=np.int32)
            for row, (seq, tt) in enumerate(seqs):
                ids[row, : len(seq)] = seq
                types[row, : len(tt)] = tt
                mask[row, : len(seq)] = 1
            mask[len(seqs):, 0] = 1  # pad rows: one live token
            with torch.inference_mode():
                logits = self._model.classify(
                    torch.from_numpy(ids).to(self._device),
                    torch.from_numpy(mask).to(self._device),
                    torch.from_numpy(types).to(self._device),
                )
            pending.append((batch_idx, len(seqs), logits))

        out = np.zeros((len(pairs),), dtype=np.float32)
        for batch_idx, n_live, logits in pending:
            arr = logits[:n_live].float().cpu().numpy()
            if arr.shape[1] == 1:
                scores = 1.0 / (1.0 + np.exp(-arr[:, 0]))  # ST sigmoid
            else:
                # Multi-class checkpoint: the best-class logit (the JAX
                # package's deliberate deviation from sentence-transformers,
                # which returns all logits).
                scores = arr.max(axis=1)
            out[batch_idx] = scores
        return out

    def rank(
        self,
        query: str,
        documents: Sequence[str],
        top_k: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Order documents by joint relevance (ST ``CrossEncoder.rank``)."""
        scores = self.predict([(query, doc) for doc in documents])
        order = np.argsort(-scores, kind="stable")
        if top_k is not None:
            order = order[:top_k]
        return [
            {"corpus_id": int(i), "score": float(scores[i]),
             "text": documents[int(i)]}
            for i in order
        ]


def resolve_reranker_name(explicit: Optional[str] = None) -> str:
    """Reranker model resolution: arg > $CLAUDE_SEARCH_RERANK_MODEL >
    default (mirrors the embedding model's env contract)."""
    return explicit or os.environ.get(
        "CLAUDE_SEARCH_RERANK_MODEL", DEFAULT_RERANK_MODEL
    )
