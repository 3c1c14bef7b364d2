"""int8 IVF with raw rows against residual rows: recall@10 and queries/s.

    python -m tpu_search_torch.benchmarks.int8_residual_ab [--device cpu]
        [--n 1000000] [--out PATH]

The port of ``benchmarks/int8_residual_ab.py``: at the JAX bench's IVF
operating point (a clustered 1M x 768 corpus of 256 blobs with relative
noise 0.4, nlist 1024, nprobe 16; below 200,000 rows nlist
``max(16, sqrt(N) / 4)`` and 16 blobs), an int8 ``IVFIndex`` with
``by_residual=False`` (rows stored as they are) and one with ``True``
(rows stored as ``v - centroid[cluster]``, a finer int8 step).  Each
trains (40 iterations) on a seeded sample of at most 500,000 rows and
adopts the device corpus through ``add``; recall@10 over 64 queries is
against the exact f32 top-k (``torch.matmul`` of the queries and the
corpus on the device: no kernel of the port), queries/s is 5 searches of
128 queries, each fetched to the host.  The corpus comes from
``common.clustered_corpus`` (the JAX recipe, a torch generator: not the
JAX script's rows).  The headline JSON line comes last; ``--out`` writes it
to a file (the JAX script writes under ``benchmarks/results/``; this one
writes nothing unless asked).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..index.ivf import IVFIndex
from .common import bench_device, card, clustered_corpus, emit, recall_at

__all__ = ["run"]

DIM = 768
K = 10
RECALL_SAMPLE = 64
QUERIES = 128
SEED = 21  # the JAX script's generator key


def run(device: str = "cuda", n: int = 1_000_000) -> dict:
    dev = bench_device(device)
    nlist = 1024 if n >= 200_000 else max(16, int(n ** 0.5) // 4)
    nprobe = 16
    clusters = 256 if n >= 200_000 else 16
    print(f"generating clustered {n}x{DIM} corpus on {dev}...",
          file=sys.stderr, flush=True)
    corpus, qdev = clustered_corpus(n, DIM, clusters, 0.4, QUERIES, SEED, dev)
    queries = qdev.cpu().numpy()
    ref_ids = torch.topk(qdev[:RECALL_SAMPLE] @ corpus.T, K,
                         dim=1).indices.cpu().numpy()
    rng = np.random.default_rng(SEED + 1)
    pick = torch.from_numpy(
        rng.choice(n, min(n, 500_000), replace=False)).to(dev)
    train_rows = corpus[pick]
    out = {"n": n, "dim": DIM, "nlist": nlist, "nprobe": nprobe, "k": K,
           "recall_sample": RECALL_SAMPLE, "device": str(dev),
           "card": card() if dev.type == "cuda" else None}
    for by_residual in (False, True):
        tag = "residual" if by_residual else "raw"
        index = IVFIndex(dim=DIM, dtype="int8", nlist=nlist, device=dev,
                         train_iters=40, by_residual=by_residual)
        index.train(train_rows)
        index.add(corpus)
        _, got = index.search(queries[:RECALL_SAMPLE], k=K, nprobe=nprobe)
        recall = recall_at(got, ref_ids, K)
        index.search(queries, k=K, nprobe=nprobe)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            index.search(queries, k=K, nprobe=nprobe)
        qps = QUERIES * reps / (time.perf_counter() - t0)
        out[f"recall_{tag}"] = recall
        out[f"qps_b128_{tag}"] = qps
        print(f"{tag}: recall@10 {recall:.3f}  qps_b128 {qps:.0f}",
              file=sys.stderr, flush=True)
        del index
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    emit(run(args.device, args.n), args.out)


if __name__ == "__main__":
    main()
