"""The fused query path: token ids in, one packed ``[q_pad, 2k]`` array out.

The port's form of the JAX engine's ``_fused_query_fn``: encode at the
window's batch bucket (1, 8 or 32 rows) and sequence bucket (the
encoder's own pooling and L2 normalize), the storage's normalize, f32, pad
to ``q_pad`` rows (8 or 32, the scans' query blocks), the masked scan of
the index (``FlatIndex.make_scan_fn`` / ``IVFIndex.make_scan_fn``: the
flat, int8, int4 or IVF kernels, with the refine tier) and one packed
output ``[scores | ids as f32]``.  A lone query encodes one row, not
``q_pad``.

- On the card each program is one ``torch.cuda.CUDAGraph``: captured
  once (after one eager run on the capture stream, which builds the
  kernels and fills the lazy caches: the position bias, the scan configs)
  and replayed per window.  Ids and mask reach it through static tensors,
  staged from pinned host memory; the penalty (validity & the filter) and
  the IVF fills are copied into static tensors before each replay, so a
  filter never keys a program.  The packed output is copied into pinned
  host memory right after the replay, and an event marks it done; a lock
  covers staging, replay and that copy, so windows dispatched from
  several threads never share the static tensors.
- On the CPU the same function runs eagerly (the plain versions).

A graph bakes in addresses, so a program is keyed on everything it bakes
in: the encoder (its identity, config and compute dtype), the normalize
steps, the int8 FFN choice, the batch and sequence buckets, ``q_pad``,
``k``, the scan key, the address, shape and dtype of every device tensor
the scan reads in place, and the shape and dtype of the staged ones.  An
index whose buffers moved (growth, compact, rebalance) gets a new
program; the old one ages out of the bound.

A replay launches the kernels its capture recorded, so it adds the launch
counts the capture recorded to ``ops._build.LAUNCHES`` (the capture itself
launches nothing and leaves the counts as they were).  A capture, build or
launch error propagates: no caller falls back to another path.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from ..storage.hybrid import normalize_queries

__all__ = ["FusedPrograms", "MAX_PROGRAMS", "Window", "run_eager"]

# Programs kept per engine.  Each graph holds its own memory pool: at
# all-mpnet-base-v2's full width a lone query's at the 256 bucket reserved
# 24 MB, 32 queries' at the 256 bucket 240 MB (an H100, chip_smoke.py's
# [warm] graph_vs_eager lines), the int8 FFN's scratch growing with the
# rows.  16 cover the three batch buckets at the four sequence buckets
# and a second k (rerank's stage 1, top_k=200) within a few GB.
MAX_PROGRAMS = 16


@dataclass(frozen=True)
class Window:
    """One fused window: the encoder, the packed ``[B, S]`` host ids and
    mask (``B`` the batch bucket), ``q_pad``, the scan (a function of
    ``index.flat`` / ``index.ivf``, its key, the buffers it reads in place
    and the staged tensors that change between calls) and ``k``."""

    model: Any
    ids: np.ndarray
    mask: np.ndarray
    q_pad: int
    staged: tuple
    normalize: bool
    int8_ffn: bool
    store_normalize: bool
    scan: Callable
    scan_key: tuple
    buffers: tuple
    k: int
    device: torch.device

    def key(self) -> tuple:
        """Everything a captured program bakes in."""
        model = self.model
        return (id(model), model.config, model.compute_dtype, self.normalize,
                self.int8_ffn, self.store_normalize, self.ids.shape,
                self.q_pad, self.k, self.scan_key,
                tuple(_signature(t, True) for t in self.buffers),
                tuple(_signature(t, False) for t in self.staged))


def _signature(t: Optional[torch.Tensor], address: bool) -> tuple:
    """A tensor's shape and dtype, and with ``address`` where it lies: the
    buffers a graph reads in place key it by address, the staged tensors
    (copied into the graph's own before each replay) by shape alone."""
    if t is None:
        return ()
    return (t.data_ptr() if address else None, tuple(t.shape), t.dtype)


def _body(w: Window, ids: torch.Tensor, mask: torch.Tensor,
          staged: tuple) -> torch.Tensor:
    """The program: ids and mask on the model's device -> the packed
    ``[q_pad, 2k]`` f32 output."""
    emb = w.model(ids, mask, normalize=w.normalize,
                  int8_ffn=w.int8_ffn).float()
    if w.store_normalize:
        emb = normalize_queries(emb)
    if emb.shape[0] < w.q_pad:
        emb = torch.cat([emb, emb.new_zeros(
            (w.q_pad - emb.shape[0], emb.shape[1]))])
    scores, out_ids = w.scan(w.scan_key, w.buffers, staged, emb, w.k)
    return torch.cat([scores, out_ids.float()], dim=1)


def run_eager(w: Window) -> torch.Tensor:
    """The window run eagerly on its device, with no graph: the CPU path.
    On the card no user path calls it; the smoke run and the card tests
    hold the graph replays against it."""
    with torch.inference_mode():
        return _body(w, torch.from_numpy(w.ids).to(w.device),
                     torch.from_numpy(w.mask).to(w.device), w.staged)


class _Program:
    """One captured window: the graph, its static inputs and output, and
    the kernel launches one replay makes."""

    __slots__ = ("graph", "ids", "mask", "staged", "out", "launches", "model")

    def __init__(self, graph, ids, mask, staged, out, launches,
                 model) -> None:
        self.graph, self.ids, self.mask = graph, ids, mask
        self.staged, self.out, self.launches = staged, out, launches
        self.model = model  # keeps id(model) in the key unique


class FusedPrograms:
    """A bounded cache of fused programs (LRU, :data:`MAX_PROGRAMS`)."""

    def __init__(self) -> None:
        self._programs: "OrderedDict[tuple, _Program]" = OrderedDict()
        self._lock = threading.Lock()
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.last_capture_ms = 0.0

    def __len__(self) -> int:
        return len(self._programs)

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()

    def dispatch(self, w: Window
                 ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Run one window: ``(packed, event)``.  On the card ``packed`` is
        a pinned host tensor that ``event`` marks complete; on the CPU it
        is the finished output and ``event`` None."""
        if w.device.type != "cuda":
            return run_eager(w), None
        key = w.key()
        ids_host = torch.from_numpy(w.ids).pin_memory()
        mask_host = torch.from_numpy(w.mask).pin_memory()
        with self._lock, torch.inference_mode():
            program = self._programs.get(key)
            if program is None:
                program = self._capture(w, ids_host, mask_host)
                self._programs[key] = program
                while len(self._programs) > MAX_PROGRAMS:
                    self._programs.popitem(last=False)
            else:
                self._programs.move_to_end(key)
            program.ids.copy_(ids_host, non_blocking=True)
            program.mask.copy_(mask_host, non_blocking=True)
            for dst, src in zip(program.staged, w.staged):
                dst.copy_(src, non_blocking=True)
            program.graph.replay()
            for name, n in program.launches.items():
                _build.LAUNCHES[name] += n
            packed = torch.empty(program.out.shape, dtype=torch.float32,
                                 pin_memory=True)
            packed.copy_(program.out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return packed, event

    def _capture(self, w: Window, ids_host, mask_host) -> _Program:
        """One eager run on the capture stream (kernel builds, lazy caches,
        cuBLAS workspaces), then the capture, in ``"global"`` error mode:
        a host sync or a pageable copy anywhere fails it loudly."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(w.device)
        stream = self._stream
        t0 = time.perf_counter()
        ids = ids_host.to(w.device)
        mask = mask_host.to(w.device)
        static = tuple(t.clone() for t in w.staged)
        stream.wait_stream(torch.cuda.current_stream(w.device))
        with torch.cuda.stream(stream):
            _body(w, ids, mask, static)
        torch.cuda.current_stream(w.device).wait_stream(stream)
        before = dict(_build.LAUNCHES)
        # capture_begin / capture_end, not the torch.cuda.graph context:
        # that one synchronizes and empties the device and pinned host
        # caches before every capture, which a serving process pays for
        # in new cudaMalloc and cudaHostAlloc calls afterwards.
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="global")
            try:
                out = _body(w, ids, mask, static)
            finally:
                graph.capture_end()
        launches = {name: n - before[name]
                    for name, n in _build.LAUNCHES.items()
                    if n != before[name]}
        _build.LAUNCHES.update(before)  # the capture launched nothing
        self.captures += 1
        self.last_capture_ms = (time.perf_counter() - t0) * 1e3
        return _Program(graph, ids, mask, static, out, launches, w.model)
