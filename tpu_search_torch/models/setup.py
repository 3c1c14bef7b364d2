#!/usr/bin/env python3
"""Model setup: fetch or copy a sentence-transformers model, convert it to
the native checkpoint, and check it encodes.

Counterpart of ``tpu_search/models/setup.py``, with the same flags, cache
directory and ``model.tpu.npz`` output, so a model set up by either
package serves both::

    python -m tpu_search_torch.models.setup --from-dir DIR [--model NAME]
    python -m tpu_search_torch.models.setup --model all-MiniLM-L6-v2

``--from-dir`` copies an already-downloaded HF / sentence-transformers
directory into ``$CLAUDE_SEARCH_DATA_DIR/models/<name>`` and needs no
network; without it the HF snapshot is downloaded (``huggingface_hub``,
imported only then).  ``verify`` encodes three probe sentences on
``--device`` (or ``CLAUDE_SEARCH_DEVICE``, default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path
from typing import List, Optional

MODEL_NAME = "all-mpnet-base-v2"
HF_REPO = "sentence-transformers/all-mpnet-base-v2"

# The JAX package's known sentence-transformers models (mpnet, bert /
# MiniLM, distilbert, roberta / distilroberta, xlm-roberta) and
# cross-encoder rerankers; any other HF repo of those architectures works
# through --model org/name.
KNOWN_MODELS = {
    "all-mpnet-base-v2": "sentence-transformers/all-mpnet-base-v2",
    "all-distilroberta-v1": "sentence-transformers/all-distilroberta-v1",
    "all-MiniLM-L6-v2": "sentence-transformers/all-MiniLM-L6-v2",
    "all-MiniLM-L12-v2": "sentence-transformers/all-MiniLM-L12-v2",
    "multi-qa-mpnet-base-dot-v1": "sentence-transformers/multi-qa-mpnet-base-dot-v1",
    "multi-qa-MiniLM-L6-cos-v1": "sentence-transformers/multi-qa-MiniLM-L6-cos-v1",
    "multi-qa-distilbert-cos-v1": "sentence-transformers/multi-qa-distilbert-cos-v1",
    "msmarco-distilbert-base-tas-b": "sentence-transformers/msmarco-distilbert-base-tas-b",
    "paraphrase-MiniLM-L6-v2": "sentence-transformers/paraphrase-MiniLM-L6-v2",
    "paraphrase-multilingual-mpnet-base-v2": (
        "sentence-transformers/paraphrase-multilingual-mpnet-base-v2"
    ),
    "paraphrase-multilingual-MiniLM-L12-v2": (
        "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2"
    ),
    "e5-base-v2": "intfloat/e5-base-v2",
    "e5-small-v2": "intfloat/e5-small-v2",
    "bge-base-en-v1.5": "BAAI/bge-base-en-v1.5",
    "bge-small-en-v1.5": "BAAI/bge-small-en-v1.5",
    "ms-marco-MiniLM-L-6-v2": "cross-encoder/ms-marco-MiniLM-L-6-v2",
    "ms-marco-MiniLM-L-12-v2": "cross-encoder/ms-marco-MiniLM-L-12-v2",
    "ms-marco-TinyBERT-L-2-v2": "cross-encoder/ms-marco-TinyBERT-L-2-v2",
}

PROBE_SENTENCES = (
    "How do I profile a JAX program?",
    "The watcher daemon reindexes conversations.",
    "Completely unrelated sentence about cooking pasta.",
)


def get_model_cache_dir() -> Path:
    data_dir = os.environ.get(
        "CLAUDE_SEARCH_DATA_DIR", "~/.claude-semantic-search/data"
    )
    cache = Path(data_dir).expanduser() / "models"
    cache.mkdir(parents=True, exist_ok=True)
    return cache


def download_model(force: bool = False, model_name: str = MODEL_NAME) -> Path:
    """Fetch the HF snapshot (needs the network) into the cache dir."""
    cache = get_model_cache_dir()
    local_name = model_name.split("/")[-1]
    repo = KNOWN_MODELS.get(model_name, model_name)
    if "/" not in repo:
        repo = f"sentence-transformers/{repo}"
    target = cache / local_name
    if (target / "model.tpu.npz").exists() and not force:
        print(f"Model {local_name} already set up at {target}")
        return target
    print(f"Downloading {repo}...")
    from huggingface_hub import snapshot_download

    snapshot = snapshot_download(
        repo,
        allow_patterns=[
            "*.json", "*.txt", "*.model",  # *.model = sentencepiece (xlm-r)
            "pytorch_model.bin", "model.safetensors",
        ],
    )
    target.mkdir(parents=True, exist_ok=True)
    for name in os.listdir(snapshot):
        src = Path(snapshot) / name
        if src.is_file():
            shutil.copy2(src, target / name)
    return target


def convert(model_dir: Path) -> Path:
    from .convert import convert_pretrained_dir

    out = model_dir / "model.tpu.npz"
    print(f"Converting torch checkpoint -> {out}")
    convert_pretrained_dir(str(model_dir), str(out))
    return out


def verify(model_dir: Path, device: Optional[str] = None) -> bool:
    """Sanity-check the converted encoder on ``device``: unit-norm f32
    embeddings of its width for three probe sentences."""
    import numpy as np

    from .encoder import EmbeddingConfig, EmbeddingGenerator

    gen = EmbeddingGenerator(EmbeddingConfig(
        model_name=model_dir.name, cache_dir=str(model_dir.parent),
        device=device,
    ))
    gen.load_model()
    vecs = np.stack([gen.generate_single_embedding(s)
                     for s in PROBE_SENTENCES])
    dim = gen.embedding_dimension
    ok = (
        vecs.shape == (3, dim)
        and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3)
        and vecs.dtype == np.float32
    )
    print(
        f"Verification on {gen.device}: shape={vecs.shape} norms ok={ok} "
        f"sim(related)={float(vecs[0] @ vecs[1]):.3f} "
        f"sim(unrelated)={float(vecs[0] @ vecs[2]):.3f}"
    )
    return bool(ok)


def get_system_info() -> dict:
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "backend": "cuda" if count else "cpu",
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--force", action="store_true", help="re-download")
    parser.add_argument(
        "--model",
        default=MODEL_NAME,
        help="model to set up (known short names: %s; or any HF repo with an "
        "mpnet/bert architecture)" % ", ".join(KNOWN_MODELS),
    )
    parser.add_argument(
        "--from-dir",
        help="convert an already-downloaded HF/sentence-transformers dir "
        "instead of downloading",
    )
    parser.add_argument(
        "--skip-verify", action="store_true", help="skip the encode check"
    )
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="device of the encode check (env: "
                        "CLAUDE_SEARCH_DEVICE; default cuda)")
    args = parser.parse_args(argv)

    print("System:", get_system_info())
    try:
        model_local = args.model.split("/")[-1]
        if args.from_dir:
            source = Path(args.from_dir).expanduser()
            target = get_model_cache_dir() / model_local
            if source.resolve() != target.resolve():
                target.mkdir(parents=True, exist_ok=True)
                for item in source.iterdir():
                    if item.is_file():
                        shutil.copy2(item, target / item.name)
            model_dir = target
        else:
            model_dir = download_model(force=args.force, model_name=args.model)
        if not (model_dir / "model.tpu.npz").exists() or args.force:
            convert(model_dir)
        if not args.skip_verify and not verify(model_dir, args.device):
            sys.exit(1)
        print(f"✅ Model ready at {model_dir}")
    except Exception as exc:
        print(f"❌ Model setup failed: {exc}")
        print(
            "Offline? Use --from-dir with a pre-downloaded model, or set "
            "CLAUDE_SEARCH_MODEL=hash-768 for the weight-free fallback."
        )
        sys.exit(1)


if __name__ == "__main__":
    main()
