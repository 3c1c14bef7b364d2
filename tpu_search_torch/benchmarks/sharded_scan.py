"""The sharded exact scan against one device's.

    python -m tpu_search_torch.benchmarks.sharded_scan [--device cpu]
        [--devices 8] [--n 262144] [--dim 768] [--queries 8] [--k 10]

The port of ``benchmarks/sharded_scan.py``: a float32
``ShardedFlatIndex`` over a ``--devices``-shard mesh against one
``FlatIndex`` on the same rows, which exits 1 unless the ids are equal.
Rows and queries are the JAX script's recipe (numpy seed 0, unit rows);
both indexes adopt the corpus from the device (``from_device_vectors``,
the bulk build) where the JAX script adds it from the host.  The mesh
takes the cards in order and repeats the first where there are fewer
cards than shards (``build_mesh`` takes a repeated device), as it repeats
the host with ``--device cpu``; the JAX script's ``--platform`` (a
virtual CPU mesh or real chips) is the ``--device`` here.
``first_call_ms`` is the first search (the port compiles nothing then),
``steady_ms`` the mean of 5 more, each fetched to the host.  The headline
JSON line comes last.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..devices.capability import platform_devices
from ..index.flat import FlatIndex
from ..parallel import ShardedFlatIndex, build_mesh
from .common import bench_device, card, emit

__all__ = ["run"]


def run(device: str = "cuda", devices: int = 8, n: int = 262_144,
        dim: int = 768, queries: int = 8, k: int = 10) -> dict:
    dev = bench_device(device)
    have = platform_devices(dev.type) if dev.type == "cuda" else [dev]
    shard_devices = [have[i] if i < len(have) else have[0]
                     for i in range(devices)]
    mesh = build_mesh(n_data=devices, devices=shard_devices)
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, dim)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.standard_normal((queries, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = torch.from_numpy(corpus).to(shard_devices[0])

    sharded = ShardedFlatIndex.from_device_vectors(rows, mesh=mesh,
                                                   dtype="float32")
    t0 = time.perf_counter()
    _, s_ids = sharded.search(q, k=k)
    first = time.perf_counter() - t0
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        sharded.search(q, k=k)
    per_call = (time.perf_counter() - t0) / reps

    single = FlatIndex.from_device_vectors(rows, dtype="float32")
    _, ref_ids = single.search(q, k=k)
    exact = bool(np.array_equal(s_ids, ref_ids))
    return {"n": n, "shards": devices,
            "cards": len({str(d) for d in shard_devices}),
            "first_call_ms": first * 1e3,
            "steady_ms": per_call * 1e3,
            "exact_match_vs_single_device": exact, "device": str(dev),
            "card": card() if dev.type == "cuda" else None}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--n", type=int, default=262_144)
    parser.add_argument("--dim", type=int, default=768)
    parser.add_argument("--queries", type=int, default=8)
    parser.add_argument("--k", type=int, default=10)
    args = parser.parse_args(argv)
    out = run(args.device, args.devices, args.n, args.dim, args.queries,
              args.k)
    exact = out["exact_match_vs_single_device"]
    print(f"n={out['n']} shards={out['shards']} first_call="
          f"{out['first_call_ms']:.0f}ms steady={out['steady_ms']:.1f}ms/call "
          f"exact_match_vs_single_device={exact}", file=sys.stderr)
    emit(out)
    if not exact:
        sys.exit(1)


if __name__ == "__main__":
    main()
