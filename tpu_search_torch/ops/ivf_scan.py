"""IVF probe scans: the schedule, the plain versions and the kernel wrappers.

Counterpart of ``tpu_search/ops/pallas_ivf_scan.py``.  Kernels:
``csrc/ivf_topk.cu`` (bf16 / f32 blocks, replaces ``pallas_ivf_topk``),
``csrc/ivf_topk_int8.cu`` (``pallas_ivf_topk_int8``) and
``csrc/ivf_topk_int4.cu`` (``pallas_ivf_topk_int4``).

The corpus is the IVF index's dense ``[nlist, cap, D]`` block (int4:
``[nlist, cap/2, D]`` nibble-pair bytes, rows in logical order), viewed as
``nlist * cap`` rows; a row's id is its flat slot ``cluster * cap + slot``.
:func:`build_probe_schedule` (a device pre-pass, as the JAX package's XLA
pre-pass) dedups the probed clusters and lists the ``tile_n``-row tiles
inside each one's fill, ascending; its length ``n_sched`` stays on the
device, so a search makes no device-to-host sync.  Each scan scores the
scheduled tiles, keeps query ``q``'s scores only for clusters on ``q``'s
probe list (``-inf`` elsewhere), and returns the top k with first-index
ties, i.e. the lowest flat slot first.  Scores, the contract of the
Pallas path (``_ivf_search_pallas_impl``):

- bf16 / f32: ``alpha * q.v - penalty``, penalty 0 / ``|v|^2`` / ``+inf``;
- int8 / int4: ``((fma(rho, d2, d1) * scale + penalty) + cbias / qs1)``,
  penalty 0 / ``-inf``, each step one f32 rounding, ``cbias / qs1`` a
  true quotient, and ``* qs1`` after the selection.  (Measured on the CPU
  against ``pallas_ivf_topk_int8`` in interpret mode; the XLA grouped path
  multiplies by ``1 / qs1`` instead, a 1e-4-level difference.)

CPU tensors take the plain versions; a CUDA tensor launches the kernel or
raises.  ``k > MAX_K`` runs each kernel's scores-only mode (the masked
scores of the scheduled rows) and a stable sort, as the JAX package sends
k > 128 to its XLA path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.shapes import cdiv, round_up
from . import _build
from .flat_topk import MAX_K, c_entry, check_scan_args
from .topk_scan import quantize_queries, query_nibble_offsets

__all__ = [
    "IVF_TILE",
    "build_probe_schedule",
    "ivf_topk_int4_plain",
    "ivf_topk_int4_scan",
    "ivf_topk_int8_plain",
    "ivf_topk_int8_scan",
    "ivf_topk_plain",
    "ivf_topk_scan",
    "probe_positions",
]

# Rows per schedule tile: one kernel tile.  Divides every cluster capacity
# (a multiple of 256), and the schedule reads at most 127 padding rows past
# a cluster's fill.
IVF_TILE = 128
# Scheduled rows scored per block of the plain versions (bounds their
# transient float copies).
_PLAIN_ROWS = 65536

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "ivf_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                 _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "ivf_topk_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "ivf_topk_int4": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
}


def build_probe_schedule(
    probe_ids: torch.Tensor,  # [Q, nprobe] int32 cluster ids
    fills: torch.Tensor,  # [nlist] int32 live-prefix length per cluster
    cap: int,
    tile_n: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(tile_idx [max_sched+1], clusters [max_sched+1], n_sched)``:
    entry ``j < n_sched`` covers rows ``[tile_idx[j] * tile_n, +tile_n)``
    of the flat corpus, inside cluster ``clusters[j]``; entries past
    ``n_sched`` (a 0-dim int32 tensor) are never read.  The JAX function
    step for step."""
    q, nprobe = probe_ids.shape
    nlist = fills.shape[0]
    dev = probe_ids.device
    n_steps = min(q * nprobe, nlist)
    max_sched = n_steps * cdiv(cap, tile_n)

    flat = torch.sort(probe_ids.reshape(-1).to(torch.int32)).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       flat[1:] != flat[:-1]])
    uniq = torch.sort(torch.where(first, flat, nlist)).values[:n_steps]
    live = uniq < nlist
    fills_u = torch.where(live, fills[uniq.clamp(max=nlist - 1).long()],
                          0).to(torch.int32)
    tiles_u = (fills_u + (tile_n - 1)) // tile_n
    starts = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(tiles_u, 0, dtype=torch.int32)])
    n_sched = starts[-1]
    j = torch.arange(max_sched + 1, dtype=torch.int32, device=dev)
    step = torch.searchsorted(starts[1:].contiguous(), j, right=True)
    step = step.clamp(0, n_steps - 1)
    within = j - starts[step]
    clusters = uniq[step]
    tile_idx = clusters.clamp(max=nlist - 1) * (cap // tile_n) + within
    return tile_idx.to(torch.int32), clusters.to(torch.int32), n_sched


def probe_positions(probe_ids: torch.Tensor, nlist: int) -> torch.Tensor:
    """``[Q, nlist]`` int32: the position of cluster ``c`` in query ``q``'s
    probe list, ``-1`` where ``q`` does not probe ``c`` (the kernels' and
    plain versions' membership and bias lookup)."""
    q, nprobe = probe_ids.shape
    pos = torch.full((q, nlist), -1, dtype=torch.int32, device=probe_ids.device)
    rank = torch.arange(nprobe, dtype=torch.int32, device=probe_ids.device)
    pos.scatter_(1, probe_ids.long(), rank.expand(q, nprobe).contiguous())
    return pos


def _schedule_rows(tile_idx, n_sched, tile_n):
    """``(rows [S], live [S])``: the flat slot of every schedule position
    (``S = max_sched * tile_n``) and whether its entry is live."""
    max_sched = tile_idx.shape[0] - 1
    dev = tile_idx.device
    live = torch.arange(max_sched, device=dev) < n_sched
    tidx = torch.where(live, tile_idx[:max_sched], 0).long()
    rows = (tidx[:, None] * tile_n
            + torch.arange(tile_n, device=dev)[None, :]).reshape(-1)
    return rows, live.repeat_interleave(tile_n)


def _select(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """Stable top-k over schedule positions -> (scores, flat slot ids)."""
    top, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top, order = top[:, :k], order[:, :k]
    ids = torch.where(torch.isfinite(top), rows[order].to(torch.int32),
                      torch.full_like(order, -1, dtype=torch.int32))
    if top.shape[1] < k:
        pad = k - top.shape[1]
        top = torch.nn.functional.pad(top, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return top.contiguous(), ids.contiguous()


def _scores_plain(score_rows, penalty, fills, probe_ids, cap,
                     tile_n=IVF_TILE, bias=None):
    """Masked ``[Q, max_sched * tile_n]`` f32 scores of the scheduled rows
    and their flat slots.  ``score_rows(rows) -> [Q, len(rows)]`` scores
    corpus rows before the penalty.  Without ``bias`` the penalty is
    subtracted (bf16 / f32); with ``bias`` ``[Q, nprobe]`` (int8 / int4)
    the penalty is added, then the probed cluster's bias."""
    nlist = fills.shape[0]
    tile_idx, clusters, n_sched = build_probe_schedule(
        probe_ids, fills, cap, tile_n)
    rows, live = _schedule_rows(tile_idx, n_sched, tile_n)
    pos = probe_positions(probe_ids, nlist)
    cl = clusters[: tile_idx.shape[0] - 1].long().clamp(max=nlist - 1)
    flat_pen = penalty.reshape(-1)
    out = []
    for r0 in range(0, rows.shape[0], _PLAIN_ROWS):
        r = rows[r0: r0 + _PLAIN_ROWS]
        entry = torch.arange(r0, r0 + r.shape[0], device=r.device) // tile_n
        p = pos[:, cl[entry]]  # [Q, rows]: probe position, -1 if none
        if bias is None:
            s = score_rows(r) - flat_pen[r][None, :]
        else:
            s = score_rows(r) + flat_pen[r][None, :]
            s = s + bias.float().gather(1, p.clamp(min=0).long())
        member = (p >= 0) & live[None, r0: r0 + r.shape[0]]
        out.append(torch.where(member, s, torch.full_like(s, float("-inf"))))
    return torch.cat(out, dim=1), rows


def ivf_topk_plain(blocks, penalty, fills, probe_ids, queries, k, alpha=1.0,
                   tile_n=IVF_TILE):
    """Plain bf16 / f32 probe scan: ``(scores [Q, k], flat slots [Q, k])``."""
    nlist, cap, d = blocks.shape
    flat = blocks.reshape(nlist * cap, d)
    qc = queries.to(blocks.dtype).float()

    def score_rows(r):
        s = qc @ flat[r].float().T
        return s * alpha if alpha != 1.0 else s

    scores, rows = _scores_plain(score_rows, penalty, fills, probe_ids,
                                    cap, tile_n)
    return _select(scores, rows, k)


def _digit_plain(unpack, scales, penalty, fills, probe_ids, queries, k, cap,
                 cbias, qoff, tile_n):
    q_i8, rho, qs1 = quantize_queries(queries)
    qd = q_i8.double()
    off = None if qoff is None else qoff(q_i8).double()[:, None]
    flat_scale = scales.reshape(-1)
    nq = queries.shape[0]

    def score_rows(r):
        dots = qd @ unpack(r).double().T
        if off is not None:
            dots = dots - off
        # fma(rho, d2, d1): exact product, one rounding of the sum.
        combined = (dots[:nq] + rho.double()[:, None] * dots[nq:]).float()
        return combined * flat_scale[r][None, :]

    bias = _bias_pre(cbias, qs1, probe_ids)
    scores, rows = _scores_plain(score_rows, penalty, fills, probe_ids,
                                    cap, tile_n, bias=bias)
    top, ids = _select(scores, rows, k)
    return top * qs1[:, None], ids


def _bias_pre(cbias, qs1, probe_ids):
    """``cbias / qs1`` (a true quotient), zeros without ``cbias``."""
    if cbias is None:
        return torch.zeros(probe_ids.shape, dtype=torch.float32,
                           device=probe_ids.device)
    return (cbias.float() / qs1[:, None]).contiguous()


def ivf_topk_int8_plain(blocks, scales, penalty, fills, probe_ids, queries, k,
                        cbias=None, tile_n=IVF_TILE):
    """Plain int8 probe scan (blocks ``[nlist, cap, D]`` int8)."""
    nlist, cap, d = blocks.shape
    flat = blocks.reshape(nlist * cap, d)
    return _digit_plain(lambda r: flat[r], scales, penalty, fills, probe_ids,
                        queries, k, cap, cbias, None, tile_n)


def ivf_topk_int4_plain(nibbles, scales, penalty, fills, probe_ids, queries,
                        k, cbias=None, tile_n=IVF_TILE):
    """Plain int4 probe scan (``[nlist, cap/2, D]`` nibble-pair bytes)."""
    nlist, half, d = nibbles.shape
    flat = nibbles.reshape(nlist * half, d)

    def unpack(r):
        b = flat[r // 2]
        return torch.where((r % 2 == 1)[:, None], b >> 4, b & 0x0F)

    return _digit_plain(unpack, scales, penalty, fills, probe_ids, queries, k,
                        2 * half, cbias, query_nibble_offsets, tile_n)


# -- the kernels -----------------------------------------------------------


def _split_entries(max_sched: int, q_blocks: int, device) -> Tuple[int, int]:
    """``(entries_per_split, n_splits)``: about four CTAs a streaming
    multiprocessor over all query blocks, each a contiguous run of
    schedule entries (so the merge in split order keeps first-index ties)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = max(1, (4 * sms) // q_blocks)
    eps = max(1, cdiv(max_sched, target))
    return eps, cdiv(max_sched, eps)


def _check_ivf_args(penalty, fills, probe_ids, queries, nlist, cap, d):
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError("queries must be [Q, D] with the blocks' D")
    if penalty.shape != (nlist, cap) or penalty.dtype != torch.float32:
        raise ValueError("penalty must be [nlist, cap] float32")
    if fills.shape != (nlist,):
        raise ValueError("fills must be [nlist]")
    if probe_ids.dim() != 2 or probe_ids.shape[0] != queries.shape[0]:
        raise ValueError("probe_ids must be [Q, nprobe]")
    if cap % IVF_TILE:
        raise ValueError(f"cap ({cap}) must be a multiple of {IVF_TILE}")


class _Launch:
    """The schedule and scratch of one kernel launch."""

    def __init__(self, probe_ids, fills, cap, q, k, qb, dev):
        nlist = fills.shape[0]
        self.tile_idx, self.clusters, self.n_sched = build_probe_schedule(
            probe_ids, fills.to(torch.int32), cap, IVF_TILE)
        self.n_sched = self.n_sched.reshape(1).contiguous()
        self.pos = probe_positions(probe_ids, nlist)
        self.max_sched = self.tile_idx.shape[0] - 1
        self.eps, self.n_splits = _split_entries(
            self.max_sched, cdiv(q, qb), dev)
        self.scores = self.part_s = self.part_i = None
        self.out_s = self.out_i = None
        if k > MAX_K:
            self.scores = torch.full((q, self.max_sched * IVF_TILE),
                                     float("-inf"), dtype=torch.float32,
                                     device=dev)
        else:
            kpad = round_up(k, 32)
            self.part_s = torch.empty((q, self.n_splits, kpad),
                                      dtype=torch.float32, device=dev)
            self.part_i = torch.empty((q, self.n_splits, kpad),
                                      dtype=torch.int32, device=dev)
            self.out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
            self.out_i = torch.empty((q, k), dtype=torch.int32, device=dev)

    def sched_ptrs(self):
        return (self.tile_idx.data_ptr(), self.clusters.data_ptr(),
                self.n_sched.data_ptr(), self.pos.data_ptr())

    def tail(self):
        return (self.max_sched, self.eps, self.n_splits) + tuple(
            None if t is None else t.data_ptr()
            for t in (self.part_s, self.part_i, self.out_s, self.out_i,
                      self.scores))

    def result(self, k):
        if self.scores is None:
            return self.out_s, self.out_i
        rows, _ = _schedule_rows(self.tile_idx, self.n_sched[0], IVF_TILE)
        return _select(self.scores, rows, k)


def _run(kernel, head, launch, k, dev):
    code = c_entry(kernel, kernel, _ARGTYPES[kernel])(
        *head, *launch.tail(), _build.stream_ptr(dev))
    _build.check(code, kernel)
    _build.LAUNCHES[kernel] += 1
    return launch.result(k)


def ivf_topk_scan(
    blocks: torch.Tensor,  # [nlist, cap, D] bf16 / f32
    penalty: torch.Tensor,  # [nlist, cap] f32: 0 / |v|^2 / +inf
    fills: torch.Tensor,  # [nlist] int32
    probe_ids: torch.Tensor,  # [Q, nprobe] int32
    queries: torch.Tensor,  # [Q, D] f32
    k: int,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 / f32 probe scan: ``(scores [Q, k] f32, flat slots [Q, k]
    int32)``, ``-inf`` / ``-1`` past the live candidates."""
    if blocks.device.type == "cpu":
        return ivf_topk_plain(blocks, penalty, fills, probe_ids, queries, k,
                              alpha)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"block dtype {blocks.dtype} not supported")
    nlist, cap, d = blocks.shape
    _check_ivf_args(penalty, fills, probe_ids, queries, nlist, cap, d)
    if d % 8:
        raise ValueError("the CUDA scan needs D % 8 == 0")
    queries = queries.to(blocks.dtype).contiguous()
    probe_ids = probe_ids.to(torch.int32).contiguous()
    q = queries.shape[0]
    dev = check_scan_args(nlist * cap, min(k, nlist * cap), blocks=blocks,
                          penalty=penalty, queries=queries)
    launch = _Launch(probe_ids, fills, cap, q, k, 16 if q <= 16 else 32, dev)
    head = (blocks.data_ptr(), penalty.data_ptr(), queries.data_ptr(),
            *launch.sched_ptrs(), nlist * cap, d, q, k, nlist,
            int(blocks.dtype == torch.bfloat16), float(alpha))
    return _run("ivf_topk", head, launch, k, dev)


def _digit_scan(kernel, blocks, scales, penalty, fills, probe_ids, queries,
                k, cbias, cap, n_rows, int4):
    nlist, _, d = blocks.shape
    _check_ivf_args(penalty, fills, probe_ids, queries, nlist, cap, d)
    if d % 16:
        raise ValueError("the int8 / int4 CUDA scans need D % 16 == 0")
    if scales.shape != (nlist, cap) or scales.dtype != torch.float32:
        raise ValueError("scales must be [nlist, cap] float32")
    probe_ids = probe_ids.to(torch.int32).contiguous()
    q = queries.shape[0]
    if cbias is not None and cbias.shape != probe_ids.shape:
        raise ValueError("cbias must be [Q, nprobe], as probe_ids")
    q_i8, rho, qs1 = quantize_queries(queries)
    bias = _bias_pre(cbias, qs1, probe_ids)
    extra = {"qoff": query_nibble_offsets(q_i8)} if int4 else {}
    dev = check_scan_args(n_rows, min(k, n_rows), blocks=blocks,
                          scales=scales, penalty=penalty, digits=q_i8,
                          rho=rho, bias=bias, **extra)
    launch = _Launch(probe_ids, fills, cap, q, k, 8 if q <= 8 else 32, dev)
    head = (blocks.data_ptr(), scales.data_ptr(), penalty.data_ptr(),
            q_i8.data_ptr(), rho.data_ptr(),
            *[t.data_ptr() for t in extra.values()],
            *launch.sched_ptrs(), bias.data_ptr(), n_rows, d, q, k, nlist,
            probe_ids.shape[1])
    scores, ids = _run(kernel, head, launch, k, dev)
    return scores * qs1[:, None], ids


def ivf_topk_int8_scan(
    blocks: torch.Tensor,  # [nlist, cap, D] int8
    scales: torch.Tensor,  # [nlist, cap] f32
    penalty: torch.Tensor,  # [nlist, cap] f32: 0 / -inf
    fills: torch.Tensor,
    probe_ids: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    cbias: Optional[torch.Tensor] = None,  # [Q, nprobe] f32 (q . centroid)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 probe scan; ``cbias`` is the residual indexes' per-probe
    ``q . centroid`` in final score units."""
    if blocks.device.type == "cpu":
        return ivf_topk_int8_plain(blocks, scales, penalty, fills, probe_ids,
                                   queries, k, cbias)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.dtype != torch.int8:
        raise TypeError(f"block dtype {blocks.dtype}, expected int8")
    nlist, cap, _ = blocks.shape
    return _digit_scan("ivf_topk_int8", blocks, scales, penalty, fills,
                       probe_ids, queries, k, cbias, cap, nlist * cap, False)


def ivf_topk_int4_scan(
    nibbles: torch.Tensor,  # [nlist, cap/2, D] uint8 nibble-pair bytes
    scales: torch.Tensor,
    penalty: torch.Tensor,
    fills: torch.Tensor,
    probe_ids: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    cbias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 probe scan over nibble-pair byte blocks."""
    if nibbles.device.type == "cpu":
        return ivf_topk_int4_plain(nibbles, scales, penalty, fills, probe_ids,
                                   queries, k, cbias)
    if nibbles.device.type != "cuda":
        raise ValueError(f"unsupported device {nibbles.device}")
    if nibbles.dtype != torch.uint8:
        raise TypeError(f"block dtype {nibbles.dtype}, expected uint8")
    nlist, half, _ = nibbles.shape
    return _digit_scan("ivf_topk_int4", nibbles, scales, penalty, fills,
                       probe_ids, queries, k, cbias, 2 * half,
                       nlist * 2 * half, True)
