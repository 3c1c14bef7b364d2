"""Encoder models, the cross-encoder, checkpoint I/O and tokenizers."""

from .cross_encoder import CrossEncoder, CrossEncoderConfig
from .encoder import EmbeddingConfig, EmbeddingGenerator
from .mpnet import MPNetConfig, MPNetModel, init_params
from .tokenizer import WordPieceTokenizer

__all__ = [
    "CrossEncoder",
    "CrossEncoderConfig",
    "EmbeddingConfig",
    "EmbeddingGenerator",
    "MPNetConfig",
    "MPNetModel",
    "WordPieceTokenizer",
    "init_params",
]
