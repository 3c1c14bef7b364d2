"""Encoder models, the cross-encoder, checkpoint I/O and tokenizers.

Of the JAX package's names, ``EmbeddingStats`` is not ported yet, and the
functional ``encode``, ``forward_hidden`` and ``classify`` are the
``MPNetModel`` methods ``forward``, ``forward_hidden`` and ``classify``.
"""

from .cross_encoder import CrossEncoder, CrossEncoderConfig
from .encoder import EmbeddingConfig, EmbeddingGenerator
from .hashing import HashingEncoder
from .mpnet import MPNetConfig, MPNetModel, init_params
from .sp_tokenizer import UnigramTokenizer
from .tokenizer import WordPieceTokenizer

__all__ = [
    "CrossEncoder",
    "CrossEncoderConfig",
    "EmbeddingConfig",
    "EmbeddingGenerator",
    "HashingEncoder",
    "MPNetConfig",
    "MPNetModel",
    "UnigramTokenizer",
    "WordPieceTokenizer",
    "init_params",
]
