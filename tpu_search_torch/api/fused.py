"""The fused query path: token ids in, one packed ``[q_pad, 2k]`` array out.

The port's form of the JAX engine's ``_fused_query_fn``: encode at the
window's batch bucket (1, 8 or 32 rows) and sequence bucket (the
encoder's own pooling and L2 normalize), the storage's normalize, f32, pad
to ``q_pad`` rows (8 or 32, the scans' query blocks), the masked scan of
the index (``FlatIndex.make_scan_fn`` / ``IVFIndex.make_scan_fn``: the
flat, int8, int4 or IVF kernels, with the refine tier; or
``ShardedFlatIndex.make_scan_fn`` / ``ShardedIVFIndex.make_scan_fn``:
each shard's scan, the merge and an IVF refine tier's rescore) and one
packed output ``[scores | ids as f32]``.  A lone query encodes one row,
not ``q_pad``.

- On the card a program with every shard on the encoder's card is one
  ``torch.cuda.CUDAGraph``: captured once (after one eager run on the
  capture stream, which builds the kernels and fills the lazy caches: the
  position bias, the scan configs) and replayed per window.  Ids and mask
  reach it through static tensors, staged from pinned host memory; the
  penalty (validity & the filter) and the IVF fills (every shard's, when
  sharded) are copied into static tensors before each replay, so a filter
  never keys a program.  The packed output is copied into pinned host
  memory right after the replay, and an event marks it done; a lock
  covers staging, replay and that copy, so windows dispatched from
  several threads never share the static tensors.
- Shards on several cards of this process (``Window.plan``, the sharded
  scan's ``CardPlan``) make one graph a card and stage: on the encoder's
  card (the merge device) the encode into a static ``[q_pad, D]`` block;
  for each stage of the plan, on each card a graph over the shards it
  holds, reading a static copy of the stage's inputs (a peer copy from
  the merge device) and writing static outputs, which are copied back to
  static tensors on the merge device for the stage's merge graph; IVF
  with a refine tier has two stages (the probe scans, then the rescore).
  Over a mesh that gathers across processes a stage's merge is two graphs
  with the stage's collective between them (an ``all_gather`` of the
  ranks' top-k lists, an ``all_reduce`` of the rescore): the first graph
  writes this process's part into static tensors, the collective runs
  eagerly on them into static tensors the second reads.  A collective is
  never inside a graph: it runs during each replay, after the copies from
  the card graphs and before the merge graph, on the merge card's current
  stream, and a failed one raises out of ``dispatch``.  The capture's warm
  pass runs the collectives too, so the ranks capture in step, and its
  output is the capturing window's answer: every window, captured or
  replayed, runs each collective once, whichever rank captures it.
  Each graph is captured on its own card's stream, and the graphs of one
  program on one card share one memory pool (they replay one after
  another on that card's stream, in the order they were captured): one
  pool a card and program.  PyTorch's capture registers the pool of the
  capture device alone, so one capture spanning the cards cannot
  allocate on the others.  A copy between cards orders itself after the work on both
  cards' current streams (PyTorch's two-way event barrier), so a replay
  issues the steps in order and the cards run their stage side by side.
- On the CPU the same function runs eagerly (the plain versions; a
  sharded scan chains the same stages).

A graph bakes in addresses, so a program is keyed on everything it bakes
in: the encoder (its identity, config and compute dtype), the normalize
steps, the int8 FFN choice, the batch and sequence buckets, ``q_pad``,
``k``, the scan key, the address, shape and dtype of every device tensor
the scan reads in place (an IVF pq index's codebooks and OPQ rotation
among them), and the shape and dtype of the staged ones.  An
index whose buffers moved (growth, compact, rebalance) gets a new
program; the old one ages out of the bound.

A replay launches the kernels its capture recorded, so it adds the launch
counts the capture recorded to ``ops._build.LAUNCHES`` (the capture itself
launches nothing and leaves the counts as they were).  A capture, build or
launch error propagates: no caller falls back to another path.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from ..storage.hybrid import normalize_queries

__all__ = ["FusedPrograms", "MAX_PROGRAMS", "Window", "run_eager"]

# Programs kept per engine.  Each holds its own memory pool a card: at
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
    and the staged tensors that change between calls) and ``k``.  A
    sharded index whose shards lie on several cards of this process, or
    whose mesh gathers across processes, also gives ``plan``, its scan's
    ``card_plan`` (``parallel.sharded_index`` / ``parallel.sharded_ivf``):
    the card runs it as one graph a card and stage, the ranks'
    collectives between the graphs."""

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
    plan: Optional[Callable] = None

    def key(self) -> tuple:
        """Everything a captured program bakes in."""
        model = self.model
        return (id(model), model.config, model.compute_dtype, self.normalize,
                self.int8_ffn, self.store_normalize, self.ids.shape,
                self.q_pad, self.k, self.scan_key, self.plan is not None,
                tuple(_signature(t, True) for t in self.buffers),
                tuple(_signature(t, False) for t in self.staged))


def _signature(t: Optional[torch.Tensor], address: bool) -> tuple:
    """A tensor's shape and dtype, and with ``address`` where it lies: the
    buffers a graph reads in place key it by address, the staged tensors
    (copied into the graph's own before each replay) by shape alone."""
    if t is None:
        return ()
    return (t.data_ptr() if address else None, tuple(t.shape), t.dtype)


def _encode(w: Window, ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Ids and mask on the model's device -> the ``[q_pad, D]`` f32 query
    block the scan reads."""
    emb = w.model(ids, mask, normalize=w.normalize,
                  int8_ffn=w.int8_ffn).float()
    if w.store_normalize:
        emb = normalize_queries(emb)
    if emb.shape[0] < w.q_pad:
        emb = torch.cat([emb, emb.new_zeros(
            (w.q_pad - emb.shape[0], emb.shape[1]))])
    return emb


def _pack(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.cat([scores, ids.float()], dim=1)


def _body(w: Window, ids: torch.Tensor, mask: torch.Tensor,
          staged: tuple) -> torch.Tensor:
    """The program: ids and mask on the model's device -> the packed
    ``[q_pad, 2k]`` f32 output."""
    return _pack(*w.scan(w.scan_key, w.buffers, staged,
                         _encode(w, ids, mask), w.k))


def run_eager(w: Window) -> torch.Tensor:
    """The window run eagerly on its device, with no graph: the CPU path.
    On the card no user path calls it; the smoke run and the card tests
    hold the graph replays against it."""
    with torch.inference_mode():
        return _body(w, torch.from_numpy(w.ids).to(w.device),
                     torch.from_numpy(w.mask).to(w.device), w.staged)


class _Step(NamedTuple):
    """One step of a program's replay: copy each of ``srcs`` into its
    static tensor in ``dsts``, then replay ``graph`` (if any) and run
    ``collective`` (if any) with ``device`` current."""

    dsts: tuple
    srcs: tuple
    device: torch.device
    graph: Optional[torch.cuda.CUDAGraph]
    collective: Optional[Callable] = None


class _Program:
    """One captured window: its steps (:class:`_Step`), its static inputs
    and output, and the kernel launches one replay makes.  ``first`` is the
    capture's warm output where the program holds a collective: the
    capturing window's answer, which no replay repeats."""

    __slots__ = ("steps", "ids", "mask", "staged", "out", "launches",
                 "model", "first")

    def __init__(self, steps, ids, mask, staged, out, launches,
                 model, first=None) -> None:
        self.steps, self.ids, self.mask = steps, ids, mask
        self.staged, self.out, self.launches = staged, out, launches
        self.model = model  # keeps id(model) in the key unique
        self.first = first

    def replay(self) -> None:
        for step in self.steps:
            for dst, src in zip(step.dsts, step.srcs):
                dst.copy_(src, non_blocking=True)
            if step.graph is not None or step.collective is not None:
                with torch.cuda.device(step.device):
                    if step.graph is not None:
                        step.graph.replay()
                    if step.collective is not None:
                        step.collective()


class FusedPrograms:
    """A bounded cache of fused programs (LRU, :data:`MAX_PROGRAMS`)."""

    def __init__(self) -> None:
        self._programs: "OrderedDict[tuple, _Program]" = OrderedDict()
        self._lock = threading.Lock()
        self._streams: Dict[int, torch.cuda.Stream] = {}
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
        with self._lock, torch.inference_mode(), torch.cuda.device(w.device):
            program = self._programs.get(key)
            if program is None:
                t0 = time.perf_counter()
                capture = (self._capture if w.plan is None
                           else self._capture_cards)
                program = capture(w, ids_host, mask_host)
                self.captures += 1
                self.last_capture_ms = (time.perf_counter() - t0) * 1e3
                self._programs[key] = program
                while len(self._programs) > MAX_PROGRAMS:
                    self._programs.popitem(last=False)
            else:
                self._programs.move_to_end(key)
            out, program.first = program.first, None
            if out is None:
                program.ids.copy_(ids_host, non_blocking=True)
                program.mask.copy_(mask_host, non_blocking=True)
                for dst, src in zip(program.staged, w.staged):
                    dst.copy_(src, non_blocking=True)
                program.replay()
                for name, n in program.launches.items():
                    _build.LAUNCHES[name] += n
                out = program.out
            packed = torch.empty(out.shape, dtype=torch.float32,
                                 pin_memory=True)
            packed.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return packed, event

    def _graph(self, device: torch.device, fn, warm_args: tuple,
               static_args: tuple, launches: Counter,
               pools: Optional[dict] = None):
        """``fn(*warm_args)`` run once eagerly on ``device``'s capture
        stream (kernel builds, lazy caches, cuBLAS workspaces), then
        ``fn(*static_args)`` captured there, in ``"global"`` error mode: a
        host sync or a pageable copy anywhere fails it loudly.  Adds the
        launches the capture recorded to ``launches`` (the capture itself
        launches nothing and leaves ``_build.LAUNCHES`` as it was).
        ``pools`` (card index -> pool handle) shares one memory pool among
        the graphs captured on a card; the first graph on a card adds its
        own.  ``(graph, warm output, captured output)``."""
        with torch.cuda.device(device):
            index = torch.cuda.current_device()
            stream = self._streams.get(index)
            if stream is None:
                stream = self._streams[index] = torch.cuda.Stream(index)
            current = torch.cuda.current_stream(index)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                warm = fn(*warm_args)
            before = dict(_build.LAUNCHES)
            # capture_begin / capture_end, not the torch.cuda.graph
            # context: that one synchronizes and empties the device and
            # pinned host caches before every capture, which a serving
            # process pays for in new cudaMalloc and cudaHostAlloc calls
            # afterwards.
            pool = None if pools is None else pools.get(index)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="global")
                try:
                    out = fn(*static_args)
                finally:
                    graph.capture_end()
            if pools is not None and pool is None:
                pools[index] = graph.pool()
            for name, n in _build.LAUNCHES.items():
                if n != before[name]:
                    launches[name] += n - before[name]
            _build.LAUNCHES.update(before)
            current.wait_stream(stream)
        return graph, warm, out

    def _capture(self, w: Window, ids_host, mask_host) -> _Program:
        """The window as one graph on the encoder's card: the encode, the
        scan (every shard's, when they share the card) and the pack."""
        ids = ids_host.to(w.device)
        mask = mask_host.to(w.device)
        static = tuple(t.clone() for t in w.staged)
        launches: Counter = Counter()
        graph, _, out = self._graph(
            w.device, lambda: _body(w, ids, mask, static), (), (), launches)
        return _Program([_Step((), (), w.device, graph)], ids, mask, static,
                        out, dict(launches), w.model)

    def _capture_cards(self, w: Window, ids_host, mask_host) -> _Program:
        """The window over shards on several cards, or over a mesh that
        gathers across processes: one graph on the encoder's card (encode
        -> normalize -> pad -> a static ``[q_pad, D]`` block), then for
        each stage of the scan's ``CardPlan`` one graph a card, fed by
        copies of the stage's inputs into that card's static tensors, and
        the merge on the encoder's card, fed by copies of every card's
        outputs: one graph, or where the stage has a collective a graph of
        this process's part, the collective (run eagerly, into static
        tensors) and a graph of the merge.  The graphs on a card share one
        memory pool.  A copy between cards orders itself after the work on
        both cards' current streams, so one replay runs the steps in order
        and the cards' stages side by side."""
        merge = w.device
        if merge.index is None:
            merge = torch.device("cuda", torch.cuda.current_device())
        ids = ids_host.to(merge)
        mask = mask_host.to(merge)
        static = tuple(t.clone() for t in w.staged)
        plan = w.plan(w.scan_key, w.buffers, static, w.k, merge_device=merge)
        launches: Counter = Counter()
        pools: dict = {}
        graph, q_warm, q = self._graph(
            merge, lambda: _encode(w, ids, mask), (), (), launches, pools)
        steps = [_Step((), (), merge, graph)]
        warm, inputs = (q_warm,), (q,)
        collective = False
        for n, stage in enumerate(plan.stages):
            merge_in, merge_srcs = [], []
            for j, device in enumerate(plan.cards):
                card_in = tuple(t.to(device, copy=True) for t in warm)
                graph, out_warm, out = self._graph(
                    device, lambda *a, j=j: stage.card(j, a), card_in,
                    card_in, launches, pools)
                steps.append(_Step(card_in, inputs, device, graph))
                held = tuple(t.to(merge, copy=True) for t in out_warm)
                merge_in.append(held)
                merge_srcs.append(out)
            copies = (tuple(t for held in merge_in for t in held),
                      tuple(t for out in merge_srcs for t in out))
            last = n == len(plan.stages) - 1

            def merged(part, ins, merge_fn=stage.merge, last=last):
                result = merge_fn(part, ins)
                return _pack(*result) if last else result

            if stage.collective is None:
                graph, warm, inputs = self._graph(
                    merge, lambda outs, ins, local=stage.local,
                    merged=merged: merged(local(outs, ins), ins),
                    (merge_in, warm), (merge_in, inputs), launches, pools)
                steps.append(_Step(*copies, merge, graph))
                continue
            collective = True
            graph, part_warm, part = self._graph(
                merge, stage.local, (merge_in, warm), (merge_in, inputs),
                launches, pools)
            # The warm pass's collective; its output is the static tensors
            # the merge graph reads and each replay's collective fills.
            gathered = stage.collective(part_warm, None)
            steps.append(_Step(*copies, merge, graph, functools.partial(
                stage.collective, part, gathered)))
            graph, warm, inputs = self._graph(
                merge, merged, (gathered, warm), (gathered, inputs),
                launches, pools)
            steps.append(_Step((), (), merge, graph))
        return _Program(steps, ids, mask, static, inputs, dict(launches),
                        w.model, first=warm if collective else None)
