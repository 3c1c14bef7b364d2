"""IVF nlist / nprobe sweep: recall@10 against the flat scan, and queries/s.

    python -m tpu_search_torch.benchmarks.ivf_sweep [--device cpu]
        [--n 1000000] [--dim 768] [--queries 64] [--k 10] [--clusters 256]
        [--noise 0.4] [--dtype bfloat16] [--nlists 256,1024,4096]
        [--nprobes 1,4,8,16,32,64] [--train-sample 500000]
        [--qbatches 1,8,64] [--out PATH]

The port of ``benchmarks/ivf_sweep.py``.  The blob corpus is made on the
device (``common.clustered_corpus``: the JAX script's recipe, from a
``torch.Generator`` seeded 0, so its rows are not the JAX script's) and
both indexes adopt the device tensor with no host round trip: the flat
truth through ``FlatIndex.from_device_vectors`` (``--dtype``, as there),
each IVF index through ``IVFIndex.add`` after ``train`` on a seeded
sample (40 iterations of the port's balanced k-means).  For each nlist
(skipped where 4 x nlist > N) and nprobe (<= nlist): recall@10 against
the flat ids, queries/s of the whole batch, and the ms a search at each
query batch beside the flat scan's.  Times are the host's clock around
``search`` (each call fetches its answer), as in the JAX script.  Each row
is a JSON line; the last line is ``{"meta": ..., "sweep": [...]}``, what
the JAX script writes to its results file; ``--out`` writes it to a file
(nothing is written otherwise).  Not ported: the JAX script's persistent
compile cache (the port compiles nothing at run time).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..index.flat import FlatIndex
from ..index.ivf import IVFIndex
from .common import bench_device, clustered_corpus, emit, recall_at, sync

__all__ = ["run"]


def _per_search_s(index, queries, k, reps, **kw) -> float:
    index.search(queries, k=k, **kw)  # this batch's shape, warm
    t0 = time.perf_counter()
    for _ in range(reps):
        index.search(queries, k=k, **kw)
    return (time.perf_counter() - t0) / reps


def run(device: str = "cuda", n: int = 1_000_000, dim: int = 768,
        queries: int = 64, k: int = 10, clusters: int = 256,
        noise: float = 0.4, dtype: str = "bfloat16",
        nlists=(256, 1024, 4096), nprobes=(1, 4, 8, 16, 32, 64),
        train_sample: int = 500_000, qbatches=(1, 8, 64)) -> dict:
    dev = bench_device(device)
    t0 = time.perf_counter()
    corpus, qdev = clustered_corpus(n, dim, clusters, noise, queries, 0, dev)
    sync(dev)
    gen_s = time.perf_counter() - t0
    q = qdev.cpu().numpy()
    print(f"corpus gen (device): {gen_s:.1f}s ({n} x {dim})",
          file=sys.stderr, flush=True)

    qbatches = [b for b in qbatches if b <= queries]
    flat = FlatIndex.from_device_vectors(corpus, dtype=dtype)
    flat.search(q, k=k)
    t0 = time.perf_counter()
    _, ref_ids = flat.search(q, k=k)
    flat_time = time.perf_counter() - t0
    flat_by_q = {b: _per_search_s(flat, q[:b], k, max(1, 16 // b))
                 for b in qbatches}
    del flat  # frees the flat corpus before the IVF blocks allocate
    print(f"flat scan ({dtype}): {queries / flat_time:.1f} qps batched",
          file=sys.stderr, flush=True)

    meta = {"n": n, "dim": dim, "dtype": dtype, "platform": dev.type,
            "queries": queries, "k": k, "noise": noise,
            "flat_qps_batched": queries / flat_time}
    results = []
    rng = np.random.default_rng(0)
    for nlist in nlists:
        if nlist * 4 > n:
            continue
        ivf = IVFIndex(dim=dim, dtype=dtype, nlist=nlist, device=dev,
                       train_iters=40)
        n_train = min(n, max(50 * nlist, train_sample))
        pick = torch.from_numpy(rng.choice(n, n_train, replace=False)).to(dev)
        t0 = time.perf_counter()
        ivf.train(corpus[pick])
        sync(dev)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ivf.add(corpus)  # the device tensor, adopted
        sync(dev)
        add_s = time.perf_counter() - t0
        pad = ivf.padding_stats()
        print(f"nlist={nlist}: train {train_s:.1f}s (n={n_train}), add "
              f"{add_s:.1f}s, fill_fraction {pad['fill_fraction']:.2f}",
              file=sys.stderr, flush=True)
        for nprobe in nprobes:
            if nprobe > nlist:
                continue
            ivf.search(q, k=k, nprobe=nprobe)
            t0 = time.perf_counter()
            _, got = ivf.search(q, k=k, nprobe=nprobe)
            elapsed = time.perf_counter() - t0
            by_q = {}
            for b in qbatches:
                s = _per_search_s(ivf, q[:b], k, max(1, 16 // b),
                                  nprobe=nprobe)
                by_q[f"ms_q{b}"] = s * 1e3
                by_q[f"speedup_vs_flat_q{b}"] = flat_by_q[b] / s
            row = {"nlist": nlist, "nprobe": nprobe,
                   "recall_at_10": recall_at(got, ref_ids, k),
                   "qps": queries / elapsed,
                   "speedup_vs_flat": flat_time / elapsed, **by_q}
            results.append(row)
            print(f"nlist={nlist} nprobe={nprobe}: recall "
                  f"{row['recall_at_10']:.4f}", file=sys.stderr, flush=True)
        meta[f"train_s_nlist{nlist}"] = train_s
        meta[f"add_s_nlist{nlist}"] = add_s
        meta[f"fill_fraction_nlist{nlist}"] = pad["fill_fraction"]
        ivf.clear()
    passing = [r for r in results if r["recall_at_10"] >= 0.95]
    if passing:
        meta["best_at_recall95"] = max(passing, key=lambda r: r["qps"])
    return {"meta": meta, "sweep": results}


def _ints(text: str):
    return tuple(int(x) for x in text.split(","))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--dim", type=int, default=768)
    parser.add_argument("--queries", type=int, default=64)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--clusters", type=int, default=256)
    parser.add_argument("--noise", type=float, default=0.4)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--nlists", default="256,1024,4096")
    parser.add_argument("--nprobes", default="1,4,8,16,32,64")
    parser.add_argument("--train-sample", type=int, default=500_000)
    parser.add_argument("--qbatches", default="1,8,64")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    out = run(args.device, args.n, args.dim, args.queries, args.k,
              args.clusters, args.noise, args.dtype, _ints(args.nlists),
              _ints(args.nprobes), args.train_sample, _ints(args.qbatches))
    emit(out, args.out, lines=out["sweep"])


if __name__ == "__main__":
    main()
