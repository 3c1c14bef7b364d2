"""tpu_search_torch — the PyTorch/CUDA port of tpu_search.

Semantic search over Claude Code conversation history on one NVIDIA GPU:
parse ``~/.claude/projects`` JSONL, chunk, embed with all-mpnet-base-v2 or
another MPNet / BERT / XLM-R encoder (bf16, hand-written CUDA kernels for
the attention and the W8A8 FFN), store in a device-resident flat or IVF
index (hand-written scan kernels) next to SQLite metadata, search with
metadata filters, and optionally rerank with a cross-encoder.  The JAX
package ``tpu_search`` is the reference; each module here names its
counterpart.
"""

__version__ = "0.1.0"

from .api.engine import SearchEngine, SemanticSearchCLI
from .index.flat import FlatIndex
from .index.ivf import IVFIndex
from .ingest.chunker import Chunk, ChunkingConfig, ConversationChunker
from .ingest.parser import Conversation, JSONLParser, Message
from .models.encoder import EmbeddingConfig, EmbeddingGenerator, EmbeddingStats
from .models.mpnet import MPNetConfig
from .storage.hybrid import (
    HybridStorage,
    SearchConfig,
    SearchResult,
    StorageConfig,
)

__all__ = [
    "Chunk",
    "ChunkingConfig",
    "Conversation",
    "ConversationChunker",
    "EmbeddingConfig",
    "EmbeddingGenerator",
    "EmbeddingStats",
    "FlatIndex",
    "HybridStorage",
    "IVFIndex",
    "JSONLParser",
    "MPNetConfig",
    "Message",
    "SearchConfig",
    "SearchEngine",
    "SearchResult",
    "SemanticSearchCLI",
    "StorageConfig",
]
