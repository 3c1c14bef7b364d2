"""Time this tree's kernel wrappers against other trees' on the card, in
turns, and check they agree.

    git archive <commit> tpu_search_torch | tar -x -C <dir>
    python -m tpu_search_torch.benchmarks.compare_trees --other NAME=<dir>
        [--other NAME=<dir> ...] [--family FAMILY ...] [--case NAME ...]
        [--no-bench] [--out FILE]
        (families: flat, scans, int8, attention, flash)

Run from the repository's root: it reuses ``chip_smoke.py``'s corpora,
operands and timers.  Each ``<dir>`` holds another tree's
``tpu_search_torch`` (a parent commit, or a copy with one change); it is
copied under ``build/compare/<NAME>`` as the package
``tpu_search_torch_<NAME>`` and builds its own kernels there, every tree's
side by side.

Families (``--family``, all by default):

- ``flat``: ``flat_topk_scan`` over bf16 and f32 rows (ip): at the fused
  path's shape (the smoke index's capacity of 32,768 slots x 768, its
  17,024 live rows and the +inf tail, Q 8 and 32, k 10) and at 1M x 768,
  10 % masked, Q 1, 8 and 128, k 10, 128 and 200; within 1e-4, ids equal
  outside near-ties.
- ``scans``, at ``chip_smoke.py``'s shapes (1M x 768, nlist 1024, its IVF
  corpus and indexes; the flat int4 corpus of its quantized phase):
  ``ivf_topk`` (bf16 at nprobe 8 and 32, f32 at 32) and the IVF int8 /
  int4 scans at ``chip_smoke.IVF_CASES``; ``flat_topk_int4`` and
  ``flat_topk_int8`` (rows and words) at Q 1 to 128 and k 10, 128 and 200.
  The float scan agrees within 1e-4 with ids equal outside near-ties, the
  digit scans exactly.
- ``int8``, at the int8 bench's shape (all-mpnet-base-v2's FFN over
  M = 128 x 384 rows, H 768, I 3,072; ``chip_smoke.int8_family_inputs``,
  bf16 h, residual and outputs): ``int8_ffn_in``, ``int8_ffn_out`` (fed
  the plain ``int8_ffn_in``'s h and row maxima), one ``int8_pair`` step
  (``quantize_rows``, ``int8_ffn_in``, ``int8_ffn_out``),
  ``int8_ffn_fused``, ``int8_gemm`` at ffn_in's shape with gelu, and
  ``int8_ffn_ln`` (the encoder's layer half), each bit for bit; then,
  unless ``--no-bench``, each tree's int8 bench
  (``int8_gemm_bench.run``), one JSON line each.

- ``attention``, at ``chip_smoke.py``'s shapes and inputs
  (``attention_inputs``: a trained-scale bias, random key lengths, a
  fully padded row): ``mpnet_attention_bwd`` at ``GRAD_SHAPES`` in bf16
  and f32, and the f32 forward (``mpnet_attention`` /
  ``mpnet_attention_bhsd`` on f32 q, k, v) at ``F32_SHAPES``.  Every
  tree's output is held to its ``[attention_grad]`` / ``[attention_f32]``
  gate against this tree's plain twin, not bit for bit: the trees' kernels
  sum in other orders.
- ``flash``, the stock flash mode at ``chip_smoke.FLASH_SHAPES`` and
  ``FLASH_WIDE_SHAPES`` and inputs (``flash_inputs``): the forward
  (``flash_attention``) and the backward (``flash_attention_bwd``, from
  this tree's forward's output and residuals, the bias needing a gradient)
  in bf16 and f32; a tree whose kernels refuse a head size (``ValueError``)
  sits that shape out.  Every
  tree's output is held to ``[flash_attention]``'s / ``[flash_attention_f32]``'s
  / ``[flash_attention_bwd]``'s gate against this tree's plain version.

``--case`` keeps the cases whose names start with one of its values.  Each
case prints one JSON line: each tree's CUDA-event ms a call in turns (this,
the others, the others backwards, this), its device busy ms and launches a
call and the device ms a call of its three largest kernels
(torch.profiler), and whether each other tree's output agrees with this
tree's.  The card's name and power limit come first.  Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
M, H, I = 128 * 384, 768, 3072


def load_other(src: Path, name: str):
    """The other tree's package as ``tpu_search_torch_<name>``, copied under
    ``build/compare/<name>``, where it builds its own kernels."""
    dest = ROOT / "build" / "compare" / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src / "tpu_search_torch",
                    dest / f"tpu_search_torch_{name}",
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, str(dest))
    return importlib.import_module(f"tpu_search_torch_{name}")


def modules(pkgs: dict, name: str) -> dict:
    """``{tree: <tree's package>.<name>}``."""
    return {tree: importlib.import_module(f"{pkg.__name__}.{name}")
            for tree, pkg in pkgs.items()}


def equal(got, want) -> bool:
    import torch

    def flat(out):
        return out if isinstance(out, tuple) else (out,)

    return all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


def near(got, want) -> bool:
    """A float scan's ``(scores, ids)``: the same finite entries, and ids
    equal wherever the scores differ by more than 1e-4."""
    import torch

    (ks, ki), (ps, pi) = got, want
    fin = torch.isfinite(ps)
    if not torch.equal(torch.isfinite(ks), fin):
        return False
    return bool(((ki == pi) | ((ks - ps).abs() <= 1e-4)).all())


def profile(tag: str, fn) -> dict:
    """Device busy ms and launches a call, and the device ms a call of the
    three largest kernels (``chip_smoke.device_breakdown``'s window)."""
    import contextlib
    import io

    import chip_smoke as cs

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        busy, launches = cs.device_breakdown(tag, fn, 10)
    kernels = dict(part.split("=") for part in
                   text.getvalue().split("kernel_ms:")[-1].split())
    return {"busy_ms": busy, "launches": launches,
            "kernel_ms": {k: float(v) for k, v in kernels.items()}}


class Runner:
    """Runs a case over every tree (``calls``: ``{tree: call}``, this
    tree's under ``"this"`` and first) unless ``--case`` leaves it out."""

    def __init__(self, emit, wanted):
        self.emit, self.wanted = emit, wanted

    def keep(self, tag: str) -> bool:
        return not self.wanted or any(tag.startswith(w) for w in self.wanted)

    def __call__(self, tag: str, calls: dict, agree=equal) -> None:
        import torch

        import chip_smoke as cs

        if not self.keep(tag):
            return
        outs = {tree: call() for tree, call in calls.items()}
        torch.cuda.synchronize()
        agreed = {tree: agree(out, outs["this"])
                  for tree, out in outs.items() if tree != "this"}
        del outs
        order = list(calls)
        ms = {tree: [] for tree in order}
        for tree in order + order[::-1]:
            ms[tree].append(cs.cuda_ms(calls[tree], 10))
        self.emit({"case": tag, "ms": ms, "agree": agreed,
                   "profile": {tree: profile(f"{tree} {tag}", call)
                               for tree, call in calls.items()}})


def run_ivf(pkgs: dict, run: Runner) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from ..index.ivf import probe_clusters

    scans = modules(pkgs, "ops.ivf_scan")
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
            run(f"{name} {dtype} nprobe={nprobe} Q={q} k={k}",
                {tree: (lambda s=s, name=name, args=args:
                        getattr(s, name)(*args)) for tree, s in scans.items()},
                equal if dtype in ("int8", "int4") else near)


def unit_corpus(n: int, d: int, gen):
    import torch

    v = torch.randn((n, d), generator=gen, device=gen.device)
    return v / v.norm(dim=1, keepdim=True)


def run_flat(pkgs: dict, run: Runner) -> None:
    import torch

    scans = modules(pkgs, "ops.flat_topk")
    gen = torch.Generator(device="cuda").manual_seed(15)
    d = 768
    cap, live = 32_768, 17_024
    fused = unit_corpus(cap, d, gen)
    fused_pen = torch.full((cap,), float("inf"), device="cuda")
    fused_pen[:live] = 0.0
    n = 1_000_000
    big = unit_corpus(n, d, gen)
    pen = torch.where(torch.rand((n,), generator=gen, device="cuda") >= 0.10,
                      0.0, float("inf"))
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases = [(fused.to(dtype), fused_pen, cap, q, 10) for q in (8, 32)]
        rows = big.to(dtype)
        cases += [(rows, pen, n, q, k) for q in (1, 8, 128)
                  for k in (10, 128, 200)]
        for vecs, penalty, rows_n, q, k in cases:
            queries = unit_corpus(q, d, gen)
            live_tag = f" live={live}" if rows_n == cap else ""
            run(f"flat_topk_scan {tag} N={rows_n}{live_tag} Q={q} k={k}",
                {tree: (lambda s=s, vecs=vecs, penalty=penalty,
                        queries=queries, k=k:
                        s.flat_topk_scan(vecs, penalty, queries, k))
                 for tree, s in scans.items()}, near)
        del rows, cases


def run_flat_int4(pkgs: dict, run: Runner) -> None:
    import torch

    from ..ops.int4_pack import nibble_rows_to_bytes, quantize_rows_int4

    scans = modules(pkgs, "ops.flat_topk_int4")
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, d = 1_000_000, 768
    u, scales = quantize_rows_int4(unit_corpus(n, d, gen))
    nib = nibble_rows_to_bytes(u)
    del u
    live = torch.rand((n,), generator=gen, device="cuda") >= 0.10
    pen = torch.where(live, 0.0, float("-inf"))
    for q in (1, 8, 32, 128):
        queries = unit_corpus(q, d, gen)
        for k in (10, 128, 200):
            if k > 128 and q > 8:
                continue
            run(f"flat_topk_int4_scan N={n} Q={q} k={k}",
                {tree: (lambda s=s, queries=queries, k=k:
                        s.flat_topk_int4_scan(nib, scales, pen, queries, k))
                 for tree, s in scans.items()})


def run_flat_int8(pkgs: dict, run: Runner) -> None:
    import torch

    from ..index.flat import quantize_rows_int8
    from ..ops.int8_pack import pack_int8_rows

    scans = modules(pkgs, "ops.flat_topk_int8")
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, d = 1_000_000, 768
    rows, scales = quantize_rows_int8(unit_corpus(n, d, gen))
    words = pack_int8_rows(rows)
    live = torch.rand((n,), generator=gen, device="cuda") >= 0.10
    pen = torch.where(live, 0.0, float("-inf"))
    for q in (1, 8, 16, 32, 128):
        queries = unit_corpus(q, d, gen)
        for k in (10, 128, 200):
            if k > 128 and q > 8:
                continue
            for layout, corpus in (("rows", rows), ("words", words)):
                run(f"flat_topk_int8_scan {layout} N={n} Q={q} k={k}",
                    {tree: (lambda s=s, corpus=corpus, queries=queries, k=k,
                            w=layout == "words":
                            s.flat_topk_int8_scan(corpus, scales, pen,
                                                  queries, k, w))
                     for tree, s in scans.items()})


def run_int8(pkgs: dict, run: Runner) -> None:
    import torch

    import chip_smoke as cs

    mods = modules(pkgs, "ops.int8_gemm")
    dev = torch.device("cuda")
    t = cs.int8_family_inputs(torch.Generator(device=dev).manual_seed(16), M,
                              H, I, dev)
    gemm_in = (t["x_q"], t["w1"], t["sx"], t["s1"], t["b1"])
    h, amax = mods["this"].int8_ffn_in_plain(*gemm_in)
    out = (h, amax, t["w2"], t["s2"], t["b2"], t["res"])
    fused = (t["x_q"], t["sx"], t["w1"], t["s1"], t["b1"], t["w2"], t["s2"],
             t["b2"], t["res"])
    x = t["res"]  # an [M, H] bf16 activation

    def pair(g):
        xq, sx = g.quantize_rows(x)
        hid, am = g.int8_ffn_in(xq, t["w1"], sx, t["s1"], t["b1"])
        return g.int8_ffn_out(hid, am, t["w2"], t["s2"], t["b2"], t["res"])

    cases = {
        "int8_ffn_in": lambda g: g.int8_ffn_in(*gemm_in),
        "int8_ffn_out": lambda g: g.int8_ffn_out(*out),
        "int8_pair step": pair,
        "int8_ffn_fused": lambda g: g.int8_ffn_fused(*fused),
        "int8_gemm gelu": lambda g: g.int8_gemm(*gemm_in, fuse_gelu=True),
    }
    for name, case in cases.items():
        run(f"{name} M={M} H={H} I={I} bf16",
            {tree: (lambda g=g, case=case: case(g))
             for tree, g in mods.items()})
    gen = torch.Generator(device=dev).manual_seed(13)
    ln = [1.0 + 0.1 * torch.randn((H,), generator=gen, device=dev)
          if i % 2 == 0 else 0.1 * torch.randn((H,), generator=gen, device=dev)
          for i in range(4)]
    args = (x, t["w1"], t["s1"], t["b1"], t["w2"], t["s2"], t["b2"], *ln)
    run(f"int8_ffn_ln M={M} H={H} I={I}",
        {tree: (lambda f=f: f.int8_ffn_ln(*args))
         for tree, f in modules(pkgs, "ops.int8_ffn").items()})


def grad_ok(got, want, dtype: str) -> bool:
    """``(dq, dk, dv, dbias)`` inside ``[attention_grad]``'s gate against
    the plain twin's."""
    import chip_smoke as cs

    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if not cs.grad_gate(cs.rel_errors(g, w),
                            "float32" if name == "dbias" else dtype,
                            auto=False):
            return False
        if (dtype == "bfloat16" and name != "dbias"
                and cs.bf16_ulp_share(g, w) > cs.ATTN_GRAD_ULP_SHARE):
            return False
    return True


def run_attention(pkgs: dict, run: Runner) -> None:
    import math

    import torch

    import chip_smoke as cs

    mods = modules(pkgs, "ops.mpnet_attention")
    this = mods["this"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    for layout, b, s, h, nh in cs.GRAD_SHAPES:
        hd = h // nh
        shape = (b, s, h) if layout == "bsh" else (b, nh, s, hd)
        heads = nh if layout == "bsh" else None
        scale = 1.0 / math.sqrt(hd)
        for dtype in ("bfloat16", "float32"):
            q, k, v, bias, mask = cs.attention_inputs(gen, shape, nh, s, dev)
            q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
            grad = torch.randn(shape, generator=gen, device=dev).to(q.dtype)
            args = (q, k, v, grad, bias, mask, scale, heads)
            want = this.mpnet_attention_bwd_plain(*args)

            def agree(got, mine, want=want, dtype=dtype):
                return grad_ok(got, want, dtype) and grad_ok(mine, want, dtype)

            run(f"mpnet_attention_bwd {layout} B={b} S={s} H={h} heads={nh} "
                f"{dtype}",
                {tree: (lambda m=m, args=args: m.mpnet_attention_bwd(*args))
                 for tree, m in mods.items()}, agree)
            del q, k, v, grad, want
    gen = torch.Generator(device=dev).manual_seed(21)
    for layout, b, s, h, nh in cs.F32_SHAPES:
        hd = h // nh
        shape = (b, s, h) if layout == "bsh" else (b, nh, s, hd)
        q, k, v, bias, mask = cs.attention_inputs(gen, shape, nh, s, dev)
        q, k, v = (t.float() for t in (q, k, v))
        scale = 1.0 / math.sqrt(hd)
        if layout == "bsh":
            args = (q, k, v, bias, mask, nh, scale)
            want = this.mpnet_attention_plain(*args)
            fn = "mpnet_attention"
        else:
            args = (q, k, v, bias, mask, scale)
            want = this.mpnet_attention_bhsd_plain(*args)
            fn = "mpnet_attention_bhsd"

        def agree(got, mine, want=want):
            return all(float((x - want).abs().max()) <= cs.ATTN_F32_TOL
                       for x in (got, mine))

        run(f"mpnet_attention_f32 {layout} B={b} S={s} H={h} heads={nh}",
            {tree: (lambda m=m, args=args, fn=fn: getattr(m, fn)(*args))
             for tree, m in mods.items()}, agree)
        del q, k, v, want


def takes(mod, fwd) -> bool:
    """Whether a tree's flash forward takes these operands (an earlier
    tree's card kernels may refuse a head size with ``ValueError``)."""
    try:
        mod.flash_attention(*fwd)
    except ValueError:
        return False
    return True


def run_flash(pkgs: dict, run: Runner) -> None:
    import math

    import torch

    import chip_smoke as cs

    everyone = modules(pkgs, "ops.flash_attention")
    this = everyone["this"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    for b, s, h, nh in cs.FLASH_SHAPES + cs.FLASH_WIDE_SHAPES:
        hd = h // nh
        scale = 1.0 / math.sqrt(hd)
        for dtype in ("bfloat16", "float32"):
            q, k, v, ab, seg = cs.flash_inputs(gen, b, s, h, nh, dev)
            q, k, v, ab = (t.to(getattr(torch, dtype)) for t in (q, k, v, ab))
            grad = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
            tag = f"B={b} S={s} H={h} heads={nh} {dtype}"
            fwd = (q, k, v, ab, seg, seg, scale)
            # a tree whose card kernels refuse the head size sits it out
            mods = {tree: m for tree, m in everyone.items()
                    if tree == "this" or takes(m, fwd)}
            want = this.flash_attention_plain(*fwd)

            def fwd_ok(out, want=want, dtype=dtype):
                if dtype == "float32":
                    return float((out - want).abs().max()) <= cs.ATTN_F32_TOL
                return cs.attention_ok(cs.bf16_errors(out, want),
                                       "flash_attention")

            run(f"flash_fwd {tag}",
                {tree: (lambda m=m: m.flash_attention(*fwd))
                 for tree, m in mods.items()},
                lambda got, mine, ok=fwd_ok: ok(got) and ok(mine))
            del want
            out, m_, l_ = this.flash_attention_fwd(*fwd)
            bwd = (q, k, v, ab, seg, seg, out, grad, m_, l_, scale)
            want = this.flash_attention_bwd_plain(*bwd)

            def bwd_ok(got, want=want, dtype=dtype):
                return all(cs.flash_bwd_ok(cs.flash_bwd_errors(g, w, dtype),
                                           dtype)
                           for g, w in zip(got, want))

            run(f"flash_bwd {tag}",
                {tree: (lambda m=m: m.flash_attention_bwd(*bwd))
                 for tree, m in mods.items()},
                lambda got, mine, ok=bwd_ok: ok(got) and ok(mine))
            del q, k, v, ab, seg, grad, out, m_, l_, want
            torch.cuda.empty_cache()


def run_int8_bench(pkgs: dict, emit) -> None:
    for tree, bench in modules(pkgs, "benchmarks.int8_gemm_bench").items():
        result = bench.run("cuda")
        emit({"bench": tree, "ms": {k: r["ms"] for k, r in
                                    result["results"].items()},
              "cos_int8_pair_vs_bf16": result["cos_int8_pair_vs_bf16"]})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", action="append", required=True,
                        metavar="NAME=DIR")
    parser.add_argument("--family", action="append",
                        choices=("flat", "scans", "int8", "attention",
                                 "flash"))
    parser.add_argument("--case", action="append", default=[])
    parser.add_argument("--no-bench", action="store_true")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    others = [spec.partition("=") for spec in args.other]
    if any(not sep or not name or name == "this" for name, sep, _ in others):
        parser.error("--other takes NAME=DIR, NAME not 'this'")
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_trees needs a CUDA device")
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

    pkgs = {"this": importlib.import_module("tpu_search_torch")}
    for name, _, src in others:
        pkgs[name] = load_other(Path(src), name)
    with ThreadPoolExecutor() as pool:  # every tree's kernels, side by side
        list(pool.map(lambda build: build.build_all(),
                      modules(pkgs, "ops._build").values()))
    run = Runner(emit, args.case)
    families = args.family or ["flat", "scans", "int8", "attention",
                               "flash"]
    if "flat" in families:
        run_flat(pkgs, run)
    if "scans" in families:
        run_ivf(pkgs, run)
        run_flat_int4(pkgs, run)
        run_flat_int8(pkgs, run)
    if "int8" in families:
        run_int8(pkgs, run)
        if not args.no_bench:
            run_int8_bench(pkgs, emit)
    if "attention" in families:
        run_attention(pkgs, run)
    if "flash" in families:
        run_flash(pkgs, run)


if __name__ == "__main__":
    main()
