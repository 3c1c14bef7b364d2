"""Indexing throughput end to end: the "index 1k conversations" row.

    python -m tpu_search_torch.benchmarks.index_e2e [--device cpu]
        [--conversations 1000] [--width full|tiny] [--out PATH]

The port of ``benchmarks/index_e2e.py``: the whole product pipeline,
``SearchEngine.index_conversations`` (parse, chunk, tokenize, encode on
the card, SQLite metadata and the vector index), over the synthetic
Claude-Code-shaped transcripts of ``utils.synthetic`` (the JAX script's
recipe) with a full-width all-mpnet-base-v2 checkpoint of numpy-seeded
random weights (``--width tiny``: a 2-layer, 64-wide MPNet, for a quick
run on the CPU).  The first file is indexed as a warm-up, then the rest,
timed.  It reports the JAX script's keys: seconds per 1k conversations,
chunks/s, the reference's rows (README.md:347, 425, 426) and the ratios
to them, the process's peak resident set (``VmHWM``) and the bytes of the
saved store (SQLite and the TPUSIDX2 index, the model and the transcripts
left out) per 1k conversations, and the engine's phases.  Everything is
written under a temporary directory, removed at the end; the headline
JSON line comes last, and ``--out`` writes it to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

from .common import bench_device, card, emit, sync

__all__ = ["run"]

REF_CPU_S = 300.0  # reference README.md:347, 1k conversations on the CPU
REF_CUDA_S = 30.0  # the same row, NVIDIA CUDA
MODEL = "bench-mpnet"


def _peak_rss_gb() -> Optional[float]:
    """This process's peak resident set (VmHWM, else ``ru_maxrss`` where
    the kernel's status file has no VmHWM line), in GiB."""
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1024 ** 2
    except OSError:
        pass
    import resource

    kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return kib / 1024 ** 2 if kib else None


def _dir_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def _write_tiny_model(model_dir: Path):
    """A 2-layer, 64-wide MPNet with random weights and the ``tok{i}``
    vocabulary of ``utils.synthetic.write_model``."""
    from ..models.convert import save_checkpoint
    from ..models.mpnet import MPNetConfig, init_params

    config = MPNetConfig(vocab_size=2005, hidden_size=64, num_layers=2,
                         num_heads=2, intermediate_size=128)
    model_dir.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(model_dir / "model.tpu.npz"),
                    init_params(config, 5), config)
    specials = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"]
    vocab = specials + [f"tok{i}" for i in range(config.vocab_size - 5)]
    (model_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return config


def run(device: str = "cuda", conversations: int = 1000,
        width: str = "full") -> dict:
    from ..api.engine import SearchEngine
    from ..utils.synthetic import write_conversations, write_model

    dev = bench_device(device)
    root = Path(tempfile.mkdtemp(prefix="index_e2e_"))
    try:
        data = root / "data"
        model_dir = data / "models" / MODEL
        config = (write_model(model_dir) if width == "full"
                  else _write_tiny_model(model_dir))
        files = write_conversations(root, conversations,
                                    config.vocab_size - 5)
        engine = SearchEngine(str(data), model_name=MODEL,
                              use_warm_server=False, device=dev.type)
        engine.storage.config.auto_save = False
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # parser warnings
            engine.index_conversations(files[:1])
        warm_s = time.perf_counter() - t0
        timed = files[1:]
        sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = engine.index_conversations(timed)
        sync(dev)
        wall_s = time.perf_counter() - t0
        engine.storage.save_index()
        store_bytes = (_dir_bytes(data) - _dir_bytes(data / "models"))
        n_conv = len(timed)
        chunks = stats.get("chunks_indexed", 0)
        per_1k_s = wall_s * 1000.0 / n_conv
        return {
            "device": str(dev),
            "card": card() if dev.type == "cuda" else None,
            "width": width,
            "conversations": n_conv,
            "files_processed": stats.get("files_processed"),
            "chunks_indexed": chunks,
            "wall_s": wall_s,
            "warmup_first_file_s": warm_s,
            "s_per_1k_conversations": per_1k_s,
            "chunks_per_s": chunks / wall_s if wall_s else None,
            "vs_ref_cpu": REF_CPU_S / per_1k_s,
            "vs_ref_cuda": REF_CUDA_S / per_1k_s,
            "ref_rows": "README.md:347 — 1k conversations: ~300s CPU, "
                        "~30s CUDA",
            "peak_host_rss_gb": _peak_rss_gb(),
            "ref_indexing_memory": "README.md:425 — < 2 GB during "
                                   "indexing (CPU)",
            "store_gb_per_1k_conv": store_bytes / 1024 ** 3 * 1000.0
            / n_conv,
            "ref_storage": "README.md:426 — ~1 GB per 1,000 conversations",
            "errors": len(stats.get("errors", [])),
            "phases": stats.get("phases"),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--conversations", type=int, default=1000)
    parser.add_argument("--width", default="full", choices=("full", "tiny"))
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    emit(run(args.device, args.conversations, args.width), args.out)


if __name__ == "__main__":
    main()
