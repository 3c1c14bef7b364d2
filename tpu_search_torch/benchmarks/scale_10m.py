"""A 10M x 768 int8 exact-scan index on one card.

    python -m tpu_search_torch.benchmarks.scale_10m [--device cpu]
        [--n 10027008] [--chunk 65536] [--queries 32] [--k 10]
        [--against-rows] [--out PATH]

The port of ``benchmarks/scale_10m.py``, the JAX package's single-chip
capacity run.  N = 153 x 65,536 = 10,027,008 unit rows of D 768 by
default (``--n`` to override; N must be a multiple of ``--chunk`` and of
the bulk build's capacity alignment, so that the index adopts the corpus
as it is).  The corpus is made on the device ``--chunk`` rows at a time,
each chunk from its own seeded ``torch.Generator``, quantized by the
index's int8 quantizer and packed straight into the ``ops.int8_pack``
``[N/4, D]`` int32 word layout: no float copy of the corpus ever exists.
``FlatIndex.from_device_vectors(packed=True)`` adopts the words with no
copy, and its scan reads them in that layout (``flat_topk_int8.cu``'s
word entry).  The truth is an f32 top-k streamed over the same chunks,
made again (a ``torch.matmul`` a chunk and a running top-k merge: no
kernel of the port), so a 30 GB f32 corpus never exists either.

It prints the JAX script's keys (``gen_s``, ``adopt_s``,
``recall_at_10_vs_f32``, ``device_scan_ms_q8``, ``qps_b128_host_synced``,
``index_hbm_gb``, ``effective_gbps``; ``index_hbm_gb`` is N x D / 2^30 and
``effective_gbps`` those bytes in GB over the scan's time, as there) and
``bound_ms`` (the bytes the scan must read, corpus, scales and penalty,
with the queries and the output, over 3.35 TB/s), the share of it the scan
reaches, the adoption's peak device memory over the corpus
(``adopt_peak_over_corpus_gb``: the words are adopted, so about 0),
``peak_device_gb`` and ``card`` (``nvidia-smi``'s name and power limit).
``device_scan_ms_q8`` is CUDA events around 20 calls of the index's scan
(``make_scan_fn``) at Q 8, not the JAX script's two-point slope of a chain
of fetches; ``qps_b128`` times ``search`` of 128 queries, each call
fetched to the host.  ``--against-rows`` also unpacks the words into
``[N, D]`` int8 rows (N x D more bytes on the device) and holds the word
scan against the row scan at Q 8 and Q 32: ids and scores must be equal
(``words_equal_rows``), and times the row scan beside it.  With
``--device cpu`` every number is the host's.  The headline JSON line comes
last; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Tuple

import numpy as np
import torch

from ..index.flat import FlatIndex, adoption_capacity, flat_scan
from ..index.flat import quantize_rows_int8
from ..ops import _build
from ..ops.flat_topk_int8 import flat_topk_int8_scan
from ..ops.int8_pack import pack_int8_rows, unpack_int8_rows
from .common import (HBM_BYTES_PER_S, bench_device, card, emit, recall_at,
                     sync, timed_ms, unit_rows)

__all__ = ["run", "N", "DIM"]

# 153 x 65,536 = 10,027,008 rows: 65,536-aligned (adopted as they are)
# and a whole number of chunks.
N = 153 * 65536
DIM = 768
CHUNK = 65536
QUERY_SEED = 777


def chunk_rows(c: int, chunk: int, dim: int, seed: int,
               device: torch.device) -> torch.Tensor:
    """Chunk ``c`` of the corpus: ``chunk`` unit rows from a generator
    seeded ``seed + c``."""
    gen = torch.Generator(device=device).manual_seed(seed + c)
    return unit_rows(gen, chunk, dim, device)


def truth_topk(queries: torch.Tensor, n_chunks: int, chunk: int, k: int,
               seed: int) -> torch.Tensor:
    """The exact f32 top-k ids of ``queries`` over the corpus, the chunks
    made again one at a time and merged into a running top-k."""
    q = queries.shape[0]
    best_s = torch.full((q, k), float("-inf"), device=queries.device)
    best_i = torch.full((q, k), -1, dtype=torch.long, device=queries.device)
    for c in range(n_chunks):
        rows = chunk_rows(c, chunk, queries.shape[1], seed, queries.device)
        s, i = torch.topk(queries @ rows.T, k, dim=1)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, i + c * chunk], dim=1)
        best_s, order = torch.topk(cat_s, k, dim=1)
        best_i = cat_i.gather(1, order)
    return best_i


def rows_against_words(index: FlatIndex, queries: torch.Tensor, k: int,
                       reps: int) -> dict:
    """The word scan against the row scan on the same corpus (the words
    unpacked into rows), at Q 8 and Q 32: equal ids and scores, and each
    one's ms at Q 8."""
    words, scales = index._vectors, index._scales
    penalty = index.scan_staged(None)[0]
    rows = torch.empty((words.shape[0] * 4, words.shape[1]),
                       dtype=torch.int8, device=words.device)
    for w in range(0, words.shape[0], 1 << 16):
        part = unpack_int8_rows(words[w: w + (1 << 16)])
        rows[4 * w: 4 * w + part.shape[0]] = part
    equal = True
    for q in (8, 32):
        ws, wi = flat_topk_int8_scan(words, scales, penalty, queries[:q], k,
                                     words=True)
        rs, ri = flat_topk_int8_scan(rows, scales, penalty, queries[:q], k)
        equal &= bool(torch.equal(wi, ri)) and bool(torch.equal(ws, rs))
    q8 = queries[:8]
    rows_ms = timed_ms(
        lambda: flat_topk_int8_scan(rows, scales, penalty, q8, k), reps,
        words.device)
    del rows
    return {"words_equal_rows": equal, "rows_scan_ms_q8": rows_ms}


def run(device: str = "cuda", n: int = N, dim: int = DIM, chunk: int = CHUNK,
        queries: int = 32, k: int = 10, seed: int = 0,
        against_rows: bool = False,
        reps: int = 20) -> Tuple[dict, FlatIndex, torch.Tensor]:
    """The run: its numbers as a dict, the index and the Q 8 block (for a
    caller that looks further into the scan).  ``launches`` counts each
    kernel's launches up to the timings (not the comparison of
    ``against_rows``)."""
    dev = bench_device(device)
    start = dict(_build.LAUNCHES)
    if n % chunk or chunk % 4 or adoption_capacity(n) != n:
        raise ValueError(
            f"N={n} must be a multiple of the chunk ({chunk}, itself of 4) "
            f"and fill its capacity ({adoption_capacity(n)})")
    n_chunks = n // chunk
    print(f"[10m] building {n}x{dim} int8 words on {dev} ({n_chunks} "
          f"chunks)...", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    words = torch.empty((n // 4, dim), dtype=torch.int32, device=dev)
    scales = torch.empty((n,), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        codes, s = quantize_rows_int8(chunk_rows(c, chunk, dim, seed, dev))
        words[c * chunk // 4: (c + 1) * chunk // 4] = pack_int8_rows(codes)
        scales[c * chunk: (c + 1) * chunk] = s
    sync(dev)
    gen_s = time.perf_counter() - t0

    corpus_bytes = words.numel() * 4 + scales.numel() * 4
    if dev.type == "cuda":
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = FlatIndex.from_device_vectors(words, metric="ip", dtype="int8",
                                          scales=scales, packed=True)
    adopt_peak = None
    if dev.type == "cuda":  # the adoption's own peak, before any search
        sync(dev)
        adopt_peak = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    index.search(np.zeros((1, dim), np.float32), k=1)  # warm, and forced
    adopt_s = time.perf_counter() - t0
    zero_copy = index._vectors.data_ptr() == words.data_ptr()
    print(f"[10m] gen {gen_s:.1f}s, adopt+warm {adopt_s:.1f}s, adopted "
          f"{'as it is' if zero_copy else 'by a copy'}", file=sys.stderr,
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(QUERY_SEED)
    qrows = unit_rows(gen, 256, dim, dev)
    truth = truth_topk(qrows[:queries], n_chunks, chunk, k, seed)
    print("[10m] ground truth ready", file=sys.stderr, flush=True)
    _, got = index.search(qrows[:queries].cpu().numpy(), k=k)
    recall = recall_at(got, truth.cpu().numpy(), k)

    key, buffers = index.make_scan_fn()
    staged = index.scan_staged(None)
    q8 = qrows[:1].repeat(8, 1)
    scan_ms = timed_ms(lambda: flat_scan(key, buffers, staged, q8, k), reps,
                       dev)

    host_q = qrows[:128].cpu().numpy()
    index.search(host_q, k=k)
    t0 = time.perf_counter()
    calls = 5
    for _ in range(calls):
        index.search(host_q, k=k)
    qps_b128 = 128 * calls / (time.perf_counter() - t0)

    scan_bytes = corpus_bytes + n * 4 + 8 * dim * 4 + 8 * k * 8
    bound_ms = scan_bytes / HBM_BYTES_PER_S * 1e3
    hbm_gb = n * dim / 2**30  # the JAX script's int8 bytes, in GiB
    out = {
        "what": "gpu_exact_int8_10m" if dev.type == "cuda"
        else "cpu_exact_int8_10m",
        "n": n,
        "dim": dim,
        "gen_s": gen_s,
        "adopt_s": adopt_s,
        "recall_at_10_vs_f32": recall,
        "device_scan_ms_q8": scan_ms,
        "qps_b128_host_synced": qps_b128,
        "index_hbm_gb": hbm_gb,
        "effective_gbps": hbm_gb * 1.024 ** 3 / (scan_ms / 1e3),
        "bound_ms": bound_ms,
        "bound_share": bound_ms / scan_ms,
        "zero_copy": bool(zero_copy),
        "adopt_peak_over_corpus_gb": adopt_peak,
        "peak_device_gb": None,
        "card": card() if dev.type == "cuda" else None,
        "device": str(dev),
        "launches": {name: count - start[name]
                     for name, count in _build.LAUNCHES.items()
                     if count > start[name]},
    }
    if against_rows:
        out.update(rows_against_words(index, qrows, k, reps))
    if dev.type == "cuda":
        out["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out, index, q8


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--dim", type=int, default=DIM)
    parser.add_argument("--chunk", type=int, default=CHUNK)
    parser.add_argument("--queries", type=int, default=32)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--against-rows", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    out, _, _ = run(args.device, args.n, args.dim, args.chunk, args.queries,
                    args.k, against_rows=args.against_rows)
    emit(out, args.out)


if __name__ == "__main__":
    main()
