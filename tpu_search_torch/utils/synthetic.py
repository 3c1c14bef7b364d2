"""Seeded synthetic inputs for the GPU smoke run and the device profile:
full-width checkpoints with random weights (all-mpnet-base-v2, and the
BERT-family embedder and cross-encoders of ``BERT_CONFIGS``) and
Claude-Code-shaped JSONL transcripts."""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

from ..models.mpnet import MPNetConfig

__all__ = ["BERT_CONFIGS", "N_CONVERSATIONS", "write_bert_model",
           "write_conversations", "write_model"]

# The count of the ``benchmarks/index_e2e.py`` recipe: 1,000 conversations,
# the first indexed as a warm-up.
N_CONVERSATIONS = 1000


def write_conversations(root: Path, n_conv: int, vocab_n: int) -> List[Path]:
    """Synthetic transcripts under ``root/claude-projects/-root-bench``,
    the recipe of ``benchmarks/index_e2e.py``: 8-15 alternating turns of
    50-199 random vocabulary words, a code block on every other assistant
    turn, one hook-noise line per file and a malformed line in every 50th
    file."""
    rng = np.random.default_rng(7)
    proj = root / "claude-projects" / "-root-bench"
    proj.mkdir(parents=True, exist_ok=True)
    files = []

    def words(k):
        return " ".join(f"tok{i}" for i in rng.integers(0, vocab_n, size=k))

    for c in range(n_conv):
        lines = []
        for m in range(int(rng.integers(8, 16))):
            role = "user" if m % 2 == 0 else "assistant"
            content = [{"type": "text",
                        "text": words(int(rng.integers(50, 200)))}]
            if role == "assistant" and m % 4 == 1:
                code = "\n".join(f"def f{j}(): return {j}" for j in range(6))
                content.append(
                    {"type": "code", "language": "python", "text": code})
            lines.append(json.dumps({
                "uuid": f"u{c}-{m}",
                "sessionId": f"s{c}",
                "timestamp": f"2025-07-{(c % 28) + 1:02d}T{m % 24:02d}:00:00Z",
                "message": {"role": role, "content": content},
            }))
            if m == 2:
                lines.append("PreToolUse hook fired")
        if c % 50 == 17:
            lines.append('{"broken json')
        path = proj / f"s{c}.jsonl"
        path.write_text("\n".join(lines) + "\n")
        files.append(path)
    return files


def write_model(model_dir: Path):
    """A full-width all-mpnet-base-v2 checkpoint with random weights (std
    0.02, numpy-seeded) and a ``vocab.txt`` of ``<s> <pad> </s> [UNK]
    <mask>`` then ``tok{i}``."""
    from ..models.convert import save_checkpoint
    from ..models.mpnet import MPNetConfig, init_params

    config = MPNetConfig()
    model_dir.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(model_dir / "model.tpu.npz"),
                    init_params(config, 5), config)
    specials = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"]
    vocab = specials + [f"tok{i}" for i in range(config.vocab_size - 5)]
    (model_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return config


def _bert(**fields) -> MPNetConfig:
    """A BERT config with the fields every published one below shares:
    the uncased WordPiece vocabulary (30,522), 512 positions, LayerNorm eps
    1e-12, [PAD] = 0."""
    base = dict(vocab_size=30522, max_position=512, layer_norm_eps=1e-12,
                pad_token_id=0, arch="bert")
    return MPNetConfig(**{**base, **fields})


_MINILM = dict(hidden_size=384, num_layers=6, num_heads=12,
               intermediate_size=1536)

# Full-width BERT-family configurations, by the published model's name
# (each from its HF config.json).
BERT_CONFIGS = {
    # sentence-transformers/all-MiniLM-L6-v2: mean pooling
    "all-MiniLM-L6-v2": _bert(**_MINILM),
    # cross-encoder/ms-marco-MiniLM-L-6-v2, the default reranker
    "ms-marco-MiniLM-L-6-v2": _bert(**_MINILM, num_labels=1),
    # cross-encoder/ms-marco-TinyBERT-L-4 (TinyBERT 4L-312)
    "ms-marco-TinyBERT-L-4": _bert(hidden_size=312, num_layers=4,
                                   num_heads=12, intermediate_size=1200,
                                   num_labels=1),
    # huawei-noah/TinyBERT_General_4L_312D as an embedder (mean pooling):
    # an FFN width (H 312, I 1,200) off the 128-column grid
    "TinyBERT_General_4L_312D": _bert(hidden_size=312, num_layers=4,
                                      num_heads=12, intermediate_size=1200),
}


def write_bert_model(model_dir: Path, name: str, seed: int):
    """The ``BERT_CONFIGS[name]`` checkpoint with random weights (std 0.02,
    numpy-seeded) and a BERT ``vocab.txt``: ``[PAD] [UNK] [CLS] [SEP]
    [MASK]`` then ``tok{i}``."""
    from ..models.convert import save_checkpoint
    from ..models.mpnet import init_params

    config = BERT_CONFIGS[name]
    model_dir.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(model_dir / "model.tpu.npz"),
                    init_params(config, seed), config)
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = specials + [f"tok{i}" for i in range(config.vocab_size - 5)]
    (model_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
