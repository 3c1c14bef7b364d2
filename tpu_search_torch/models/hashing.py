"""Deterministic weight-free text encoder (test/CI fallback).

Feature-hashed bag of character n-grams + words, L2-normalized.  Not a
semantic model — it exists so the full pipeline (index, storage, CLI, MCP,
watcher, sharding tests) runs end-to-end in environments where the mpnet
weights are not downloadable (no-egress CI), selected explicitly via model
name ``hash-<dim>``.  Similar texts (sharing vocabulary) land near each
other, which is enough for relevance-sanity tests.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

__all__ = ["HashingEncoder"]


class HashingEncoder:
    def __init__(self, dim: int = 768, ngram: int = 3) -> None:
        self.dim = dim
        self.ngram = ngram

    def _features(self, text: str):
        text = text.lower()
        words = text.split()
        for word in words:
            yield "w:" + word
        joined = " ".join(words)
        n = self.ngram
        for i in range(max(0, len(joined) - n + 1)):
            yield "g:" + joined[i : i + n]

    def encode(
        self, texts: Sequence[str], normalize: bool = True
    ) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for row, text in enumerate(texts):
            for feat in self._features(text or ""):
                digest = hashlib.blake2b(
                    feat.encode("utf-8"), digest_size=8
                ).digest()
                value = int.from_bytes(digest, "little")
                slot = value % self.dim
                sign = 1.0 if (value >> 63) & 1 else -1.0
                out[row, slot] += sign
        if normalize:
            norms = np.linalg.norm(out, axis=1, keepdims=True)
            out = out / np.clip(norms, 1e-12, None)
        return out
