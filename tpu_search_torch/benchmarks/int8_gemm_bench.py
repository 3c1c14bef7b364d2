"""The int8 GEMM family at all-mpnet-base-v2's FFN shapes.

    python -m tpu_search_torch.benchmarks.int8_gemm_bench [--device cpu]
        [--m 49152] [--h 768] [--i 3072] [--reps 24] [--seed 0]

The port of ``benchmarks/int8_gemm_bench.py``: the FFN of one encoder
layer, ``x [M, H] -> gelu(x W1 + b1) W2 + b2 + res``, with M = 128 x 384
rows (an indexing wave's batch at the 384 bucket), through each contender:

- ``bf16_ffn``: two bf16 ``torch.matmul`` and the tanh-gelu;
- ``int8_pair``: ``quantize_rows`` + ``int8_ffn_in`` + ``int8_ffn_out``;
- ``int8_fused``: ``quantize_rows`` + ``int8_ffn_fused`` (one row: the JAX
  bench's ``splits`` schedules the TPU kernel only);
- ``int8_torch_ffn``: ``torch._int_mm`` with a PyTorch epilogue, the
  counterpart of the JAX bench's ``int8_xla_ffn``; a library yardstick that
  no path of the port runs;
- ``int8_gemm_in`` / ``int8_gemm_out``: ``int8_gemm`` alone at ffn_in's
  shape with gelu and at ffn_out's without.

The FFN contenders run ``reps`` dependent steps, each output renormalized
(``y * rsqrt(mean(y^2) + 1e-6)``, as the JAX bench does) into the next
step's input, timed as one chain; ``renorm`` is the chain of that
renormalization alone.  The ``int8_gemm`` rows run ``reps`` calls on fixed
inputs.  On the card the times are CUDA events around the chain; with
``--device cpu`` they are the host's clock, a CPU number.  Effective TOP/s
counts 2 M H I operations per GEMM.  Inputs come from a numpy seed; the
weights quantize per output column as the encoder's do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..ops.int8_ffn import quantize_weight_columns
from ..ops.int8_gemm import (
    int8_ffn_fused,
    int8_ffn_in,
    int8_ffn_out,
    int8_gemm,
    quantize_rows,
)

__all__ = ["make_inputs", "run"]


def make_inputs(m: int, h: int, i: int, seed: int, device) -> dict:
    """The JAX bench's inputs from a numpy seed: x and res 0.5 N(0, 1),
    weights 0.02 N(0, 1), biases 0.01 N(0, 1); the bf16 copies, and the
    int8 weights in the port's ``[out, in]`` layout with their column
    scales."""
    rng = np.random.default_rng(seed)

    def normal(scale, *shape):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    x, w1, w2 = normal(0.5, m, h), normal(0.02, h, i), normal(0.02, i, h)
    b1, b2, res = normal(0.01, i), normal(0.01, h), normal(0.5, m, h)
    w1q, s1 = quantize_weight_columns(w1)  # [H, I], the JAX layout
    w2q, s2 = quantize_weight_columns(w2)
    bf = torch.bfloat16
    return {
        "xb": x.to(bf), "resb": res.to(bf), "b1": b1, "b2": b2,
        "w1b": w1.to(bf), "w2b": w2.to(bf), "b1b": b1.to(bf), "b2b": b2.to(bf),
        "s1": s1, "s2": s2,
        "w1t": w1q.T.contiguous(), "w2t": w2q.T.contiguous(),
    }


def _gelu(y):
    return torch.nn.functional.gelu(y, approximate="tanh")


def contenders(t: dict) -> dict:
    """The FFN steps ``x [M, H] bf16 -> [M, H] bf16`` by name."""

    def bf16_ffn(v):
        hid = _gelu(v @ t["w1b"] + t["b1b"])
        return hid @ t["w2b"] + t["b2b"] + t["resb"]

    def int8_pair(v):
        xq, sx = quantize_rows(v)
        hid, amax = int8_ffn_in(xq, t["w1t"], sx, t["s1"], t["b1"])
        return int8_ffn_out(hid, amax, t["w2t"], t["s2"], t["b2"], t["resb"])

    def int8_fused(v):
        xq, sx = quantize_rows(v)
        return int8_ffn_fused(xq, sx, t["w1t"], t["s1"], t["b1"], t["w2t"],
                              t["s2"], t["b2"], t["resb"])

    def int8_torch_ffn(v):
        xq, sx = quantize_rows(v)
        acc = torch._int_mm(xq, t["w1t"].t())
        hid = _gelu(acc.float() * sx[:, None] * t["s1"] + t["b1"]).to(v.dtype)
        hq, sh = quantize_rows(hid)
        acc2 = torch._int_mm(hq, t["w2t"].t())
        y = acc2.float() * sh[:, None] * t["s2"] + t["b2"]
        return (y + t["resb"].float()).to(v.dtype)

    return {"bf16_ffn": bf16_ffn, "int8_pair": int8_pair,
            "int8_fused": int8_fused, "int8_torch_ffn": int8_torch_ffn}


def _renorm(y, dtype):
    yf = y.float()
    return (yf * torch.rsqrt((yf * yf).mean() + 1e-6)).to(dtype)


def _timed_ms(fn, reps: int, device) -> float:
    """Mean ms of one of ``reps`` calls of ``fn`` after a warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run(device="cuda", m: int = 49152, h: int = 768, i: int = 3072,
        reps: int = 24, seed: int = 0) -> dict:
    """Time every contender on ``device`` and return ``{"device", "shape",
    "reps", "results": {name: {"ms", "tops"}}, "cos_int8_pair_vs_bf16"}``;
    the cosine is over the first 512 rows of one step from ``x``."""
    dev = resolve_device(str(device))
    t = make_inputs(m, h, i, seed, dev)
    x0 = t["xb"]
    steps = contenders(t)
    ffn_ops = 2 * 2 * m * h * i
    results = {}

    def chain(step):
        def go():
            v = x0
            for _ in range(reps):
                v = _renorm(step(v), x0.dtype)
            return v
        return go

    with torch.inference_mode():
        for name, step in steps.items():
            ms = _timed_ms(chain(step), reps, dev)
            results[name] = {"ms": ms, "tops": ffn_ops / (ms * 1e-3) / 1e12}
        results["renorm"] = {"ms": _timed_ms(chain(lambda v: v), reps, dev),
                             "tops": None}

        xq, sx = quantize_rows(x0)
        hid, _ = int8_ffn_in(xq, t["w1t"], sx, t["s1"], t["b1"])
        hq, sh = quantize_rows(hid)
        gemms = {
            "int8_gemm_in": lambda: int8_gemm(xq, t["w1t"], sx, t["s1"],
                                              t["b1"], fuse_gelu=True),
            "int8_gemm_out": lambda: int8_gemm(hq, t["w2t"], sh, t["s2"],
                                               t["b2"]),
        }
        for name, call in gemms.items():
            def calls(call=call):
                for _ in range(reps):
                    call()
            ms = _timed_ms(calls, reps, dev)
            results[name] = {"ms": ms, "tops": ffn_ops / 2 / (ms * 1e-3) / 1e12}

        rows = min(512, m)
        sub = {k: (v[:rows] if k in ("xb", "resb") else v) for k, v in t.items()}
        part = contenders(sub)
        ref = part["bf16_ffn"](sub["xb"]).float()
        got = part["int8_pair"](sub["xb"]).float()
        cos = float((ref * got).sum() / (ref.norm() * got.norm()))

    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "shape": {"m": m, "h": h, "i": i}, "reps": reps,
            "results": results, "cos_int8_pair_vs_bf16": cos}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--m", type=int, default=49152)
    parser.add_argument("--h", type=int, default=768)
    parser.add_argument("--i", type=int, default=3072)
    parser.add_argument("--reps", type=int, default=24)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    out = run(args.device, args.m, args.h, args.i, args.reps, args.seed)
    for name, r in out["results"].items():
        tops = "" if r["tops"] is None else f"  ({r['tops']:.1f} T/s eff)"
        print(f"{name:<16}: {r['ms']:.4f} ms{tops}", file=sys.stderr)
    print(f"cosine(int8 pair, bf16 ffn) = {out['cos_int8_pair_vs_bf16']:.6f}",
          file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
