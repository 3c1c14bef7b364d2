"""Host side of the ring-fed scans: how one is sized and its scratch laid out.

The IVF scans (``ops/ivf_scan.py``: ``csrc/ivf_topk.cu``,
``ivf_topk_int8.cu``, ``ivf_topk_int4.cu``) and the flat digit scans
(``ops/flat_topk_int8.py``, ``ops/flat_topk_int4.py``:
``csrc/flat_topk_int8.cu``, ``csrc/flat_topk_int4.cu``) each run as one C
call of three launches: a prologue, a scan CTA (fed by a ``cp.async`` ring
over contiguous runs of 128-row tiles, or for the flat scans
``digit_partial`` over fixed row ranges) and the tree merge of
``csrc/run_merge.cuh`` over the runs' top-k lists.  Each wrapper asks its
library's ``<kernel>_config`` entry for the scan CTA's shared memory and
CTAs a multiprocessor (:func:`scan_config`), sizes the runs from that and
the card (:func:`scan_runs`), and cuts its scratch from one ``torch.empty``
(:class:`Scratch`, with the merge's parts from :func:`merge_parts`).
:func:`flat_digit_call` makes a flat digit scan's C call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ..utils.shapes import cdiv, round_up
from . import _build
from .flat_topk import MAX_K, c_entry, check_scan_args, split_rows

__all__ = ["MERGE_BATCH", "Scratch", "digit_block", "flat_digit_call",
           "merge_parts", "scan_config", "scan_runs"]

# Runs' lists a merge CTA takes (csrc/run_merge.cuh kMergeBatch).
MERGE_BATCH = 16

_ALIGN = 256
_TILE = 128
_ELEMENT_BYTES = {torch.int8: 1, torch.int32: 4, torch.float32: 4,
                  torch.bfloat16: 2}


class Scratch:
    """A C call's scratch: one ``torch.empty`` byte buffer cut into the
    ``(name, dtype, shape)`` parts, each on a 256-byte boundary; ``ptrs``
    their addresses in order, :meth:`view` a part as a tensor."""

    def __init__(self, parts, dev):
        self.parts, total = {}, 0
        for name, dtype, shape in parts:
            nbytes = math.prod(shape) * _ELEMENT_BYTES[dtype]
            self.parts[name] = (dtype, shape, total, nbytes)
            total += cdiv(nbytes, _ALIGN) * _ALIGN
        self.buf = torch.empty((total,), dtype=torch.uint8, device=dev)
        base = self.buf.data_ptr()
        self.ptrs = [base + off for _, _, off, _ in self.parts.values()]

    def view(self, name: str) -> torch.Tensor:
        dtype, shape, off, nbytes = self.parts[name]
        return self.buf[off: off + nbytes].view(dtype).view(shape)


def merge_parts(q: int, runs: int, kpad: int) -> tuple:
    """The :class:`Scratch` parts of a ring scan's runs' lists (``part_s``,
    ``part_i`` ``[q, runs, kpad]``) and of the tree merge's groups
    (``group_s``, ``group_i`` ``[q, cdiv(runs, MERGE_BATCH), kpad]``), in
    the C entries' order."""
    groups = cdiv(runs, MERGE_BATCH)
    return (("part_s", torch.float32, (q, runs, kpad)),
            ("part_i", torch.int32, (q, runs, kpad)),
            ("group_s", torch.float32, (q, groups, kpad)),
            ("group_i", torch.int32, (q, groups, kpad)))


def digit_block(q: int) -> int:
    """Queries a scan CTA of the digit scans (the kernels' QB) at Q = q:
    32 above 8 (wgmma's 64 rows are 32 queries' two digits), else one
    mma.sync block of 8."""
    return 8 if q <= 8 else 32


_CONFIG: Dict[tuple, Tuple[int, int]] = {}


def scan_config(kernel: str, qb: int, k: int, *head: int) -> Tuple[int, int]:
    """``(shared memory bytes, CTAs a multiprocessor)`` of ``kernel``'s
    scan CTA at query block ``qb`` and ``k`` (any k > 128: the scores-only
    mode), from its C entry ``<kernel>_config(*head, qb, k, out)`` on the
    current CUDA device; cached."""
    kpad = 0 if k > MAX_K else round_up(k, 32)
    key = (kernel, *head, qb, kpad)
    if key not in _CONFIG:
        out = (ctypes.c_int * 2)()
        argtypes = [ctypes.c_int] * (len(head) + 2) + [ctypes.c_void_p]
        fn = c_entry(kernel, f"{kernel}_config", argtypes)
        _build.check(fn(*head, qb, k, ctypes.addressof(out)), kernel)
        _CONFIG[key] = (out[0], out[1])
    return _CONFIG[key]


def scan_runs(ctas: int, q_blocks: int, entries: int, dev) -> int:
    """Runs a query block: the card's multiprocessors x the scan's CTAs a
    multiprocessor over the query blocks, at most one an entry."""
    return max(1, min(_build.multiprocessors(dev) * max(ctas, 1) // q_blocks,
                      entries))


def flat_digit_call(kernel, argtypes, corpus, queries, n, k, parts, ring,
                    extra=(), rows_per_split=None):
    """One C call of a flat digit scan (``csrc/flat_digit_scan.cuh``):
    the prologue, then (``corpus`` = ``(corpus, scales, penalty)``) the
    scan and the merge, or with ``corpus`` None the prologue alone.  The
    C entry takes the corpus, scales, penalty and queries; ``n, d, q, k,
    qb, runs, rows_per_split, prologue_only`` and ``extra``; the scratch
    of ``parts(q, d, runs, kpad)``; ``out_s, out_i, scores`` and the
    stream.  Above Q 8 the scan is the ring (``ring``, runs of tiles
    sized from the card) or ``digit_partial`` over row ranges
    (:func:`split_rows`), as at Q <= 8; ``rows_per_split`` sets the ranges
    (and about them the runs).  Returns ``(work, out_s, out_i, scores)``
    as ``ops/ivf_scan.py``'s calls."""
    queries = queries.float().contiguous()
    q, d = queries.shape
    tensors = {"queries": queries}
    if corpus is not None:
        tensors.update(zip(("corpus", "scales", "penalty"), corpus))
    dev = check_scan_args(n, k, **tensors)
    qb = digit_block(q)
    ring = ring and qb == 32
    if rows_per_split is not None:
        runs = cdiv(n, rows_per_split)
    elif ring:
        runs = scan_runs(scan_config(kernel, qb, k)[1], cdiv(q, qb),
                         cdiv(n, _TILE), dev)
        rows_per_split = 0
    else:
        runs, rows_per_split = split_rows(n, q, qb, dev)
    kpad = 0 if k > MAX_K else round_up(k, 32)
    work = Scratch(parts(q, d, runs, kpad), dev)
    out_s = out_i = scores = None
    if corpus is not None and k > MAX_K:
        scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    elif corpus is not None:
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    ptrs = [None if t is None else t.data_ptr()
            for t in (*(corpus or (None, None, None)), queries)]
    outs = [None if t is None else t.data_ptr()
            for t in (out_s, out_i, scores)]
    code = c_entry(kernel, kernel, argtypes)(
        *ptrs, n, d, q, k, qb, runs, rows_per_split, int(corpus is None),
        *extra, *work.ptrs, *outs, _build.stream_ptr(dev))
    _build.check(code, kernel)
    _build.LAUNCHES[kernel] += 1
    return work, out_s, out_i, scores
