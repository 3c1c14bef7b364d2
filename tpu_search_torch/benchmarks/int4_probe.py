"""Where the int4 flat scan spends its time at 1M x 768.

    python -m tpu_search_torch.benchmarks.int4_probe [--device cpu]
        [--n N] [--reps 20] [--seed 0]

The port of ``benchmarks/int4_probe.py``: the int4 flat scan (Q 8, k 10,
nibble-pair rows of random bytes, scales 1e-2, nothing masked), cut into
stripped variants, each a mode of ``csrc/int4_probe.cu`` built from the
scan pieces of ``csrc/digit_scan.cuh``, beside the production scan:

- ``dma``: the byte stream only, folded (an XOR of every word);
- ``mm_only``: the int8 MMA on the raw bytes, no nibble split (the max of
  each query's digit-1 dot);
- ``unpack``: both nibble planes split into shared memory, no MMA (an XOR
  of the split words);
- ``nomerge``: everything but the top-k (the max of each query's scores);
- ``full``: the production scan of ``flat_topk_int4_scan`` (the ring of
  ``csrc/ivf_digit_scan.cuh`` and the tree merge), on the prepared digits;
  the stripped variants above keep the staging of the scan it replaced
  (``csrc/digit_scan.cuh``'s ``NibbleStage``);
- ``concat1mm``: the tile staged in plane order (its low nibbles, then its
  high nibbles) in one MMA loop, ids mapped back as the TPU probe maps
  them;
- ``prod``: the production wrapper ``flat_topk_int4_scan``.

Every variant runs at each row range per CTA in ``ROWS`` (keys
``{variant}_t{rows}``, the TPU probe's keys).  The TPU probe sweeps its
VMEM tile, the rows one pipeline step of its single sequential scan
brings; the port's scan has no such tile (a CTA stages 128 rows at a
time), and its sequential unit is a CTA's row range, whose length also
sets how many CTAs fill the card: at 1M rows, 2048 rows give 512 CTAs
(3.9 a multiprocessor), 8192 rows 128.

Times are CUDA events around ``reps`` launches on fixed inputs (``ms``,
the device's time a launch) and the host's clock around the same loop
(``wall_ms``), not the TPU probe's two-point chain slope; a CUDA launch
returns at once, so no fetch has to be cancelled.  ``gbps`` is the bytes
a variant must read over ``ms``, ``bound_ms`` those bytes at 3.35 TB/s.
With ``--device cpu`` every variant is its plain version and the times
are the host's, not a device's.  Every variant has a plain PyTorch
version of what it returns (:func:`plain`); :func:`check` holds each to
it.  Results go to stdout as one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..ops import _build
from ..ops.flat_topk import c_entry, check_scan_args
from ..ops.flat_topk_int4 import flat_topk_int4_scan
from ..ops.int4_pack import bytes_to_nibble_rows
from ..ops.ring_scan import MERGE_BATCH
from ..ops.topk_scan import (
    digit_scores,
    flat_topk_int4_plain,
    quantize_queries,
    query_nibble_offsets,
)
from ..utils.shapes import cdiv, round_up

__all__ = ["MODES", "ROWS", "check", "make_inputs", "plain", "probe", "run",
           "timed"]

D, K, Q = 768, 10, 8
ROWS = (2048, 4096, 8192)
CPU_ROWS = 4096  # the corpus ``--device cpu`` scans by default
MODES = {"dma": 0, "mm_only": 1, "unpack": 2, "nomerge": 3, "concat1mm": 4,
         "full": 5}
_XOR = ("dma", "unpack")
_MAX = ("mm_only", "nomerge")
HBM_BYTES_PER_S = 3.35e12
_NIBBLE_LO = 0x0F0F0F0F

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P] * 9


def make_inputs(n: int, seed: int, device) -> Tuple[tuple, tuple]:
    """The TPU probe's inputs from a numpy seed: ``n`` int4 rows of random
    nibble bytes ``[n/2, D]``, scales 1e-2, penalty 0 (nothing masked), Q
    unit queries; returns ``(corpus, prep)`` with the query digits, rho,
    the query scale and the nibble offsets prepared once."""
    rng = np.random.default_rng(seed)
    nibbles = torch.from_numpy(
        rng.integers(0, 256, size=(n // 2, D), dtype=np.uint8)).to(device)
    scales = torch.full((n,), 1e-2, dtype=torch.float32, device=device)
    penalty = torch.zeros((n,), dtype=torch.float32, device=device)
    qf = rng.standard_normal((Q, D)).astype(np.float32)
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    queries = torch.from_numpy(qf).to(device)
    q_i8, rho, qs1 = quantize_queries(queries)
    qoff = query_nibble_offsets(q_i8)
    return (nibbles, scales, penalty), (queries, q_i8, rho, qs1, qoff)


def _xor_all(words: torch.Tensor) -> int:
    return int(np.bitwise_xor.reduce(
        words.reshape(-1).cpu().numpy().astype(np.uint32)))


def plain(mode: str, corpus: tuple, prep: tuple, k: int = K):
    """What each variant returns, in plain PyTorch: ``dma`` / ``unpack``
    the XOR of the corpus words (split words); ``mm_only`` the max over
    the byte rows of each query's digit-1 dot with the raw bytes (int8);
    ``nomerge`` the max of each query's int4 scores (before the query
    scale); ``full``, ``concat1mm`` and ``prod`` the flat int4 top-k."""
    nibbles, scales, penalty = corpus
    queries, q_i8, rho, qs1, qoff = prep
    if mode in _XOR:
        w = nibbles.contiguous().view(torch.int32)
        if mode == "unpack":
            w = (w & _NIBBLE_LO) ^ ((w >> 4) & _NIBBLE_LO)
        return _xor_all(w)
    if mode == "mm_only":
        raw = nibbles.view(torch.int8).double()
        return (q_i8[: qs1.shape[0]].double() @ raw.T).amax(dim=1).float()
    if mode == "nomerge":
        u = bytes_to_nibble_rows(nibbles)[: penalty.shape[0]].double()
        dots = q_i8.double() @ u.T - qoff.double()[:, None]
        return digit_scores(dots, rho, scales, penalty).amax(dim=1)
    return flat_topk_int4_plain(nibbles, scales, penalty, queries, k)


def _launch(mode: str, corpus: tuple, prep: tuple, k: int,
            rows_per_split: int):
    """One launch of ``csrc/int4_probe.cu`` in ``mode``: its raw outputs
    (the per-CTA folds, or the merged top-k before the query scale)."""
    nibbles, scales, penalty = corpus
    _, q_i8, rho, qs1, qoff = prep
    n, q = penalty.shape[0], qs1.shape[0]
    dev = check_scan_args(n, k, nibbles=nibbles, scales=scales,
                          penalty=penalty, queries=q_i8, rho=rho, qoff=qoff)
    n_splits = cdiv(n, rows_per_split)
    kpad = round_up(k, 32)
    part_s = part_i = out_s = out_i = fold = grp_s = grp_i = count = None
    if mode == "full":  # the tree merge's groups and counters
        groups = cdiv(n_splits, MERGE_BATCH)
        grp_s = torch.empty((q, groups, k), dtype=torch.float32, device=dev)
        grp_i = torch.empty((q, groups, k), dtype=torch.int32, device=dev)
        count = torch.empty((q,), dtype=torch.int32, device=dev)
    if mode in _XOR:
        fold = torch.empty((n_splits,), dtype=torch.int32, device=dev)
    elif mode in _MAX:
        fold = torch.empty((q, n_splits), dtype=torch.float32, device=dev)
    else:
        part_s = torch.empty((q, n_splits, kpad), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((q, n_splits, kpad), dtype=torch.int32,
                             device=dev)
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    ptrs = [0 if t is None else t.data_ptr()
            for t in (part_s, part_i, out_s, out_i, fold, grp_s, grp_i, count)]
    code = c_entry("int4_probe", "int4_probe", _ARGTYPES)(
        nibbles.data_ptr(), scales.data_ptr(), penalty.data_ptr(),
        q_i8.data_ptr(), rho.data_ptr(), qoff.data_ptr(), n,
        nibbles.shape[1], q, k, MODES[mode], n_splits, rows_per_split,
        *ptrs, _build.stream_ptr(dev))
    _build.check(code, f"int4_probe {mode}")
    _build.LAUNCHES["int4_probe"] += 1
    return fold if fold is not None else (out_s, out_i)


def probe(mode: str, corpus: tuple, prep: tuple, k: int = K,
          rows_per_split: int = ROWS[0]):
    """The variant ``mode`` (a key of ``MODES``, or ``prod``): on the card
    the kernel, finished as :func:`plain` returns; on the CPU the plain
    version."""
    nibbles, scales, penalty = corpus
    queries, _, _, qs1, _ = prep
    if mode == "prod":
        return flat_topk_int4_scan(nibbles, scales, penalty, queries, k,
                                   rows_per_split)
    if nibbles.device.type == "cpu":
        return plain(mode, corpus, prep, k)
    raw = _launch(mode, corpus, prep, k, rows_per_split)
    if mode in _XOR:
        return _xor_all(raw)
    if mode in _MAX:
        return raw.amax(dim=1)
    out_s, out_i = raw
    return out_s * qs1[:, None], out_i


def _error(got, want) -> float:
    """Max absolute difference; ``inf`` where ids or XOR folds differ."""
    if isinstance(want, int):
        return 0.0 if got == want else float("inf")
    if isinstance(want, tuple):
        if not torch.equal(got[1].cpu(), want[1].cpu()):
            return float("inf")
        got, want = got[0], want[0]
    return float((got.cpu() - want.cpu()).abs().max())


def check(device="cuda", n: int = 6500, seed: int = 1) -> Dict[str, float]:
    """Every variant against its plain version at a small ``n`` (several
    CTAs, a ragged last range), at two row ranges; returns ``{key: max
    abs error}``, which must be 0: exact int32 dots, the same written-out
    epilogue, first-index ties."""
    dev = resolve_device(str(device))
    corpus, prep = make_inputs(n, seed, dev)
    out = {}
    for mode in (*MODES, "prod"):
        want = plain(mode, corpus, prep)
        for rows in (256, 2048):
            out[f"{mode}_t{rows}"] = _error(
                probe(mode, corpus, prep, rows_per_split=rows), want)
    return out


def bytes_read(mode: str, n: int) -> int:
    """The bytes a variant must read once: the nibbles, and the scale and
    penalty of each row where it scores."""
    nib = n // 2 * D
    return nib if mode in ("dma", "mm_only", "unpack") else nib + 8 * n


def timed(fn, reps: int, dev) -> Tuple[float, float]:
    """``(device ms, wall ms)`` a call over ``reps`` calls after a warm-up
    call: CUDA events and the host clock around one loop (on the CPU both
    are the host clock)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        return ms, ms
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return start.elapsed_time(end) / reps, wall


def run(device="cuda", n: int = 1 << 20, reps: int = 20, seed: int = 0,
        rows=ROWS) -> dict:
    """Time every variant at every row range; returns ``{"device", "n",
    "q", "k", "reps", "results": {key: {"ms", "wall_ms", "gbps",
    "bound_ms"}}}``."""
    dev = resolve_device(str(device))
    corpus, prep = make_inputs(n, seed, dev)
    results = {}
    with torch.inference_mode():
        for mode in ("prod", *MODES):
            for r in rows:
                if dev.type == "cuda" and mode != "prod":
                    def call(mode=mode, r=r):
                        _launch(mode, corpus, prep, K, r)
                else:
                    def call(mode=mode, r=r):
                        probe(mode, corpus, prep, K, r)
                ms, wall = timed(call, reps, dev)
                nbytes = bytes_read(mode, n)
                results[f"{mode}_t{r}"] = {
                    "ms": ms, "wall_ms": wall, "gbps": nbytes / ms / 1e6,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "n": n, "q": Q, "k": K, "reps": reps, "results": results}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=None,
                        help="rows (default: 2^20 on the card, 4096 on the "
                             "CPU)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    n = args.n or (1 << 20 if args.device != "cpu" else CPU_ROWS)
    out = run(args.device, n, args.reps, args.seed)
    for key, r in out["results"].items():
        print(f"{key:<18}: {r['ms']:.4f} ms ({r['gbps']:.0f} GB/s, bound "
              f"{r['bound_ms']:.4f} ms)", file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
