"""Time this tree's ring-fed scan wrappers against another tree's on the
card, in turns (other, this, this, other), and check they agree.

    git archive <commit> tpu_search_torch | tar -x -C <dir>
    python -m tpu_search_torch.benchmarks.compare_scans --other <dir>
        [--out FILE]

Run from the repository's root: it reuses ``chip_smoke.py``'s corpora and
timers.

``<dir>`` holds another tree's ``tpu_search_torch`` (a parent commit, or a
copy with one constant changed); it is copied under
``build/compare/`` as the package ``tpu_search_torch_other`` and builds
its own kernels there.  Cases, at ``chip_smoke.py``'s shapes (1M x 768,
nlist 1024, its IVF corpus and indexes; the flat int4 corpus of its
quantized phase): ``ivf_topk`` (bf16 at nprobe 8 and 32, f32 at 32) and
the IVF int8 / int4 scans at ``chip_smoke.IVF_CASES``; ``flat_topk_int4``
and ``flat_topk_int8`` (rows and words) at Q 1 to 128 and k 10, 128 and
200.  Each case prints one JSON line: both trees' CUDA-event ms a call
(two turns each), device busy ms and launches a call (torch.profiler),
and whether the outputs agree (the float scan within ``chip_smoke.TOL``,
ids equal outside near-ties; the digit scans exactly).  The card's name
and power limit come first.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_other(src: Path):
    """The other tree's package as ``tpu_search_torch_other``."""
    import importlib

    dest = ROOT / "build" / "compare" / "other"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src / "tpu_search_torch", dest / "tpu_search_torch_other",
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, str(dest))
    return importlib.import_module("tpu_search_torch_other")


def agree(got, want, exact: bool) -> bool:
    import torch

    (ks, ki), (ps, pi) = got, want
    if exact:
        return bool(torch.equal(ks, ps)) and bool(torch.equal(ki, pi))
    fin = torch.isfinite(ps)
    if not torch.equal(torch.isfinite(ks), fin):
        return False
    tol = 1e-4
    return bool(((ki == pi) | ((ks - ps).abs() <= tol)).all())


def compare(tag: str, this, other, exact: bool, emit) -> None:
    import torch

    import chip_smoke as cs

    ok = agree(this(), other(), exact)
    torch.cuda.synchronize()
    o1, t1 = cs.cuda_ms(other, 10), cs.cuda_ms(this, 10)
    t2, o2 = cs.cuda_ms(this, 10), cs.cuda_ms(other, 10)
    ob, ol = cs.device_breakdown(f"other {tag}", other, 10)
    tb, tl = cs.device_breakdown(f"this {tag}", this, 10)
    emit({"case": tag, "agree": ok, "other_ms": [o1, o2], "this_ms": [t1, t2],
          "other_busy_ms": ob, "this_busy_ms": tb, "other_launches": ol,
          "this_launches": tl})


def run_ivf(other_pkg, emit) -> None:
    import importlib

    import numpy as np
    import torch

    import chip_smoke as cs
    from ..index.ivf import probe_clusters
    from ..ops import ivf_scan

    oscan = importlib.import_module(other_pkg.__name__ + ".ops.ivf_scan")
    dev = torch.device("cuda")
    rows = cs.ivf_corpus(dev)
    dead = np.random.default_rng(22).choice(cs.IVF_N, cs.IVF_N // 10,
                                            replace=False)
    indexes = cs.build_ivf_indexes(rows, dead)
    qrng = np.random.default_rng(23)
    plan = [("bfloat16", 8), ("bfloat16", 32), ("float32", 32), ("int8", 32),
            ("int4", 32)]
    for dtype, nprobe in plan:
        index = indexes[dtype]
        blocks = index._dblocks
        pen, fills = index._penalty(None), index._device_fills()
        for q, k in cs.IVF_CASES:
            queries = rows[torch.from_numpy(
                qrng.choice(cs.IVF_N, q, replace=False)).to(dev)]
            scores, probe = probe_clusters(queries, index._dcent, "ip",
                                           nprobe)
            if dtype in ("bfloat16", "float32"):
                args = (blocks, pen, fills, probe, queries, k)
                name = "ivf_topk_scan"
            else:
                cbias = torch.gather(scores, 1, probe.long())
                args = (blocks, index._dscale, pen, fills, probe, queries, k,
                        cbias)
                name = f"ivf_topk_{dtype}_scan"
            tag = f"{name} {dtype} nprobe={nprobe} Q={q} k={k}"
            compare(tag, lambda: getattr(ivf_scan, name)(*args),
                    lambda: getattr(oscan, name)(*args),
                    dtype in ("int8", "int4"), emit)


def run_flat_int4(other_pkg, emit) -> None:
    import importlib

    import torch

    from ..ops.flat_topk_int4 import flat_topk_int4_scan
    from ..ops.int4_pack import (
        nibble_rows_to_bytes,
        quantize_rows_int4,
    )

    other = importlib.import_module(
        other_pkg.__name__ + ".ops.flat_topk_int4").flat_topk_int4_scan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    n, d = 1_000_000, 768
    v = torch.randn((n, d), generator=gen, device=dev)
    v = v / v.norm(dim=1, keepdim=True)
    u, scales = quantize_rows_int4(v)
    nib = nibble_rows_to_bytes(u)
    del v, u
    live = torch.rand((n,), generator=gen, device=dev) >= 0.10
    pen = torch.where(live, 0.0, float("-inf"))
    for q in (1, 8, 32, 128):
        queries = torch.randn((q, d), generator=gen, device=dev)
        queries = queries / queries.norm(dim=1, keepdim=True)
        for k in (10, 128, 200):
            if k > 128 and q > 8:
                continue
            compare(f"flat_topk_int4_scan N={n} Q={q} k={k}",
                    lambda: flat_topk_int4_scan(nib, scales, pen, queries, k),
                    lambda: other(nib, scales, pen, queries, k), True, emit)


def run_flat_int8(other_pkg, emit) -> None:
    import importlib

    import torch

    from ..index.flat import quantize_rows_int8
    from ..ops.flat_topk_int8 import flat_topk_int8_scan
    from ..ops.int8_pack import pack_int8_rows

    other = importlib.import_module(
        other_pkg.__name__ + ".ops.flat_topk_int8").flat_topk_int8_scan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    n, d = 1_000_000, 768
    v = torch.randn((n, d), generator=gen, device=dev)
    v = v / v.norm(dim=1, keepdim=True)
    rows, scales = quantize_rows_int8(v)
    words = pack_int8_rows(rows)
    del v
    live = torch.rand((n,), generator=gen, device=dev) >= 0.10
    pen = torch.where(live, 0.0, float("-inf"))
    for q in (1, 8, 16, 32, 128):
        queries = torch.randn((q, d), generator=gen, device=dev)
        queries = queries / queries.norm(dim=1, keepdim=True)
        for k in (10, 128, 200):
            if k > 128 and q > 8:
                continue
            for layout, corpus in (("rows", rows), ("words", words)):
                is_words = layout == "words"
                compare(f"flat_topk_int8_scan {layout} N={n} Q={q} k={k}",
                        lambda: flat_topk_int8_scan(corpus, scales, pen,
                                                    queries, k, is_words),
                        lambda: other(corpus, scales, pen, queries, k,
                                      is_words), True, emit)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, type=Path)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_scans needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    out = args.out.open("a") if args.out else None

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    other_pkg = load_other(args.other)
    run_ivf(other_pkg, emit)
    run_flat_int4(other_pkg, emit)
    run_flat_int8(other_pkg, emit)


if __name__ == "__main__":
    main()
