"""Cross-encoder reranker throughput: sequences/s a sequence bucket.

    python -m tpu_search_torch.benchmarks.cross_encoder_bench [--device cpu]
        [--batch 64] [--seqs 256,512] [--reps 5]

The port of ``benchmarks/cross_encoder_bench.py``: ``classify`` (the
reranker's compute path) at the ms-marco-MiniLM-L-6-v2 shape (H 384, 6
layers, 12 heads, FFN 1,536; numpy-seeded random weights, the FLOPs and
bytes of trained ones), layers in bf16 as the reranker runs them, on
``--batch`` pairs of random ids, the second half of each sequence token
type 1.  Two contenders a bucket, where the JAX script times its dense
XLA attention and its Pallas kernel: ``plain`` (the attention's plain
PyTorch versions in place of the kernels, as ``chip_smoke.py``'s oracle
runs them) and ``kernel`` (the port's attention kernels: the model's
layout rule picks ``mpnet_attention.cu`` or ``mpnet_attention_bhsd.cu``
for the shape; each row names the kernels its timed calls launched).  On
the card the times are CUDA events around ``--reps`` calls after a warm
one; with ``--device cpu`` both contenders run the plain versions and the
times are the host's.  Each row is a JSON line; the headline (every row,
the device and the card) comes last.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from ..models.convert import model_from_params
from ..models.mpnet import init_params
from ..ops import _build
from ..utils.synthetic import BERT_CONFIGS
from .common import bench_device, card, emit, timed_ms

__all__ = ["run"]

MODEL = "ms-marco-MiniLM-L-6-v2"


@contextlib.contextmanager
def plain_attention():
    """The encoder layers' attention through its plain versions while
    inside."""
    import tpu_search_torch.models.mpnet as M
    from ..ops.mpnet_attention import (mpnet_attention_bhsd_plain,
                                       mpnet_attention_plain)

    saved = M.mpnet_attention, M.mpnet_attention_bhsd
    M.mpnet_attention = mpnet_attention_plain
    M.mpnet_attention_bhsd = mpnet_attention_bhsd_plain
    try:
        yield
    finally:
        M.mpnet_attention, M.mpnet_attention_bhsd = saved


def run(device: str = "cuda", batch: int = 64, seqs=(256, 512),
        reps: int = 5) -> dict:
    dev = bench_device(device)
    config = BERT_CONFIGS[MODEL]
    model = model_from_params(init_params(config, 0), config)
    model.layers.to(torch.bfloat16)
    model = model.to(dev)
    rng = np.random.default_rng(0)
    rows = []
    for seq in seqs:
        ids = torch.from_numpy(rng.integers(4, 30000, size=(batch, seq))
                               .astype(np.int64)).to(dev)
        types = torch.zeros((batch, seq), dtype=torch.int64, device=dev)
        types[:, seq // 2:] = 1
        mask = torch.ones((batch, seq), dtype=torch.int64, device=dev)
        for impl in ("plain", "kernel"):
            scope = plain_attention() if impl == "plain" else (
                contextlib.nullcontext())
            with scope, torch.inference_mode():
                before = dict(_build.LAUNCHES)
                ms = timed_ms(lambda: model.classify(ids, mask, types), reps,
                              dev)
                logit = float(model.classify(ids, mask, types)[0, 0])
                launched = sorted(k for k, v in _build.LAUNCHES.items()
                                  if v > before[k])
            rows.append({"seq": seq, "impl": impl, "ms_per_batch": ms,
                         "pairs_per_s": batch / ms * 1e3, "logit": logit,
                         "kernels": launched})
            print(f"seq={seq} impl={impl}: {ms:.2f} ms/batch({batch}) -> "
                  f"{batch / ms * 1e3:.0f} pairs/s  logit={logit:.5f}",
                  file=sys.stderr, flush=True)
    return {"model": MODEL, "batch": batch, "device": str(dev),
            "card": card() if dev.type == "cuda" else None, "rows": rows}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seqs", default="256,512")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    out = run(args.device, args.batch,
              tuple(int(s) for s in args.seqs.split(",")), args.reps)
    emit(out, lines=out["rows"])


if __name__ == "__main__":
    main()
