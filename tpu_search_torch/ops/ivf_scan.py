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

Each scan on the card is one C call of three launches: a prologue kernel
(``csrc/ivf_prep.cuh``) that writes the schedule, the probe table and each
query block's member list, with the query digits and the bias for the
int8 / int4 scans (plain twin :func:`ivf_digit_prep_plain`) or the bf16
cast of the queries for bf16 blocks (:func:`ivf_float_prep_plain`), both
composed of the functions above; the scan (``csrc/ivf_digit_scan.cuh``,
``csrc/ivf_float_scan.cuh``); and the tree merge (``csrc/run_merge.cuh``),
which multiplies the int8 / int4 scores by ``qs1``.  Nothing of
PyTorch's runs between them, and the scratch is one ``torch.empty``.

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
from .ring_scan import (
    FLOAT_CUTOFF,
    MAX_K,
    Scratch,
    c_entry,
    check_scan_args,
    digit_block,
    float_block,
    merge_parts,
    scan_config,
    scan_runs,
)
from .topk_scan import quantize_queries, query_nibble_offsets

__all__ = [
    "FLOAT_CUTOFF",
    "IVF_TILE",
    "build_probe_schedule",
    "float_block",
    "ivf_digit_prep",
    "ivf_digit_prep_plain",
    "ivf_float_prep",
    "ivf_float_prep_plain",
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
    # blocks, penalty, queries, probe, fills; d, q, k, nlist, nprobe, cap,
    # max_sched, qb, runs, is_bf16; alpha; prologue_only; the scratch
    # (qcast at bf16, then _schedule_parts), out_s, out_i, scores, stream
    "ivf_topk": [_P] * 5 + [_I] * 10 + [_F, _I] + [_P] * 16,
    # corpus, scale, penalty, queries, probe, fills, cbias; d, q, k, nlist,
    # nprobe, cap, max_sched, qb, runs, prologue_only; the scratch
    # (the query digits, then _schedule_parts), out_s, out_i, scores,
    # stream
    "ivf_topk_int8": [_P] * 7 + [_I] * 10 + [_P] * 19,
    "ivf_topk_int4": [_P] * 7 + [_I] * 10 + [_P] * 19,
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


# -- the kernels: prologue, scan and merge in one C call ---------------------


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


def _schedule_parts(q, nlist, max_sched, q_blocks, runs, kpad):
    """The prologue's schedule, table and member lists, the merge's
    counters and the runs' and groups' lists, in the C entries' order."""
    i32, f32 = torch.int32, torch.float32
    return (("table", f32, (q, nlist)), ("tile_idx", i32, (max_sched + 1,)),
            ("clusters", i32, (max_sched + 1,)), ("n_sched", i32, (1,)),
            ("members", i32, (q_blocks, max_sched, 2)),
            ("member_count", i32, (q_blocks,)), ("merge_count", i32, (q,)),
            *merge_parts(q, runs, kpad))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _ivf_call(kernel, corpus, fills, probe_ids, queries, k, cap, qb,
              config_head, extra_parts, head, tail, cbias=None):
    """One C call of an IVF scan: the prologue, then (``corpus`` the
    tensors it scans, by name) the scan and the merge, or with ``corpus``
    None the prologue alone.  ``config_head`` are the arguments of the
    kernel's config entry before ``qb``; ``extra_parts(q, d)`` the scratch
    parts before the schedule's; ``head(d, q, nlist, nprobe, max_sched, runs)``
    the entry's arguments before ``prologue_only``, ``tail(work)`` the
    scratch addresses.  Returns ``(work, out_s, out_i, scores)``: the scratch
    (:class:`Scratch`), the ``[Q, k]`` results (k <= 128) or the masked
    ``[Q, max_sched * 128]`` scores (k > 128)."""
    q, nprobe = probe_ids.shape
    nlist, d = fills.shape[0], queries.shape[1]
    tensors = {"queries": queries, "probe_ids": probe_ids, "fills": fills,
               **(corpus or {})}
    if cbias is not None:
        tensors["cbias"] = cbias
    dev = check_scan_args(nlist * cap, min(k, nlist * cap), **tensors)
    q_blocks = cdiv(q, qb)
    max_sched = min(q * nprobe, nlist) * (cap // IVF_TILE)
    kpad = 0 if k > MAX_K else round_up(k, 32)
    ctas = scan_config(kernel, qb, k, *config_head)[1]
    runs = scan_runs(ctas, q_blocks, max_sched, dev)
    work = Scratch((*extra_parts(q, d),
                    *_schedule_parts(q, nlist, max_sched, q_blocks, runs,
                                     kpad)), dev)
    out_s = out_i = scores = None
    if corpus is not None and k > MAX_K:
        scores = torch.full((q, max_sched * IVF_TILE), float("-inf"),
                            dtype=torch.float32, device=dev)
    elif corpus is not None:
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    code = c_entry(kernel, kernel, _ARGTYPES[kernel])(
        *head(d, q, nlist, nprobe, max_sched, runs), int(corpus is None),
        *tail(work), _ptr(out_s), _ptr(out_i), _ptr(scores),
        _build.stream_ptr(dev))
    _build.check(code, kernel)
    _build.LAUNCHES[kernel] += 1
    return work, out_s, out_i, scores


def _prep_result(parts: dict, names) -> dict:
    """The prologue's outputs as compared: ``names`` as they are, then the
    schedule with entries past ``n_sched`` and member entries past each
    block's count zeroed."""
    n_sched = parts["n_sched"].reshape(())
    dev = n_sched.device
    live = torch.arange(parts["tile_idx"].shape[0], device=dev) < n_sched
    counts = parts["member_count"]
    listed = (torch.arange(parts["members"].shape[1], device=dev)[None, :]
              < counts[:, None])
    return {
        **{name: parts.get(name) for name in names},
        "table": parts["table"], "n_sched": n_sched,
        "tile_idx": torch.where(live, parts["tile_idx"], 0),
        "clusters": torch.where(live, parts["clusters"], 0),
        "members": torch.where(listed[..., None], parts["members"], 0),
        "member_count": counts,
    }


def _plain_schedule(probe_ids, fills, cap, qb, table):
    """The plain twin's schedule, member lists and ``table`` as the
    prologue writes them (see :func:`ivf_digit_prep_plain`)."""
    q = probe_ids.shape[0]
    nlist = fills.shape[0]
    tile_idx, clusters, n_sched = build_probe_schedule(
        probe_ids, fills.to(torch.int32), cap, IVF_TILE)
    pos = probe_positions(probe_ids, nlist)
    n = int(n_sched)
    blocks = cdiv(q, qb)
    members = torch.zeros((blocks, tile_idx.shape[0] - 1, 2),
                          dtype=torch.int32, device=probe_ids.device)
    counts = torch.zeros((blocks,), dtype=torch.int32,
                         device=probe_ids.device)
    for b in range(blocks):
        hit = (pos[b * qb: (b + 1) * qb][:, clusters[:n].long()] >= 0).any(0)
        js = torch.nonzero(hit).flatten()
        members[b, : js.shape[0], 0] = tile_idx[js]
        members[b, : js.shape[0], 1] = js.to(torch.int32)
        counts[b] = js.shape[0]
    return {"table": table(pos), "tile_idx": tile_idx, "clusters": clusters,
            "n_sched": n_sched, "members": members, "member_count": counts}


# -- the bf16 / f32 scan ---------------------------------------------------------


def ivf_float_prep_plain(probe_ids, fills, queries, cap, bf16=True) -> dict:
    """What the bf16 / f32 scan's prologue kernel writes, from the plain
    pieces: ``qcast`` (the queries as bf16 for bf16 blocks, else None),
    ``build_probe_schedule`` (``tile_idx``, ``clusters``, ``n_sched``),
    ``probe_positions`` (``table [Q, nlist]``: 0 where the query probes
    the cluster, ``-inf`` elsewhere) and the member lists of each block of
    :func:`float_block` queries (``members``, ``member_count``, as
    :func:`ivf_digit_prep_plain`'s)."""
    q = probe_ids.shape[0]

    def table(pos):
        return torch.where(pos >= 0, 0.0, float("-inf")).to(torch.float32)

    out = _plain_schedule(probe_ids, fills, cap, float_block(q, bf16), table)
    out["qcast"] = queries.float().to(torch.bfloat16) if bf16 else None
    return _prep_result(out, ("qcast",))


def _float_call(blocks, penalty, fills, probe_ids, queries, k, alpha, cap,
                bf16):
    """One C call of the bf16 / f32 scan (``blocks`` None: the prologue
    alone, for a dtype ``bf16``)."""
    qb = float_block(probe_ids.shape[0], bf16)
    probe_ids = probe_ids.to(torch.int32).contiguous()
    fills = fills.to(torch.int32).contiguous()
    queries = queries.float().contiguous()
    corpus = None
    if blocks is not None:
        corpus = {"blocks": blocks, "penalty": penalty}

    def extra(q, d):
        return (("qcast", torch.bfloat16, (q, d)),) if bf16 else ()

    def head(d, q, nlist, nprobe, max_sched, runs):
        return (_ptr(blocks), _ptr(penalty), queries.data_ptr(),
                probe_ids.data_ptr(), fills.data_ptr(), d, q, k, nlist,
                nprobe, cap, max_sched, qb, runs, int(bf16), float(alpha))

    def tail(work):
        return ([None] if not bf16 else []) + work.ptrs

    return _ivf_call("ivf_topk", corpus, fills, probe_ids, queries, k, cap,
                     qb, (int(bf16),), extra, head, tail)


def ivf_float_prep(probe_ids, fills, queries, cap, bf16=True) -> dict:
    """The prologue kernel of the bf16 / f32 scan alone, on CUDA tensors
    (the plain twin on CPU ones); outputs as :func:`ivf_float_prep_plain`."""
    if probe_ids.device.type == "cpu":
        return ivf_float_prep_plain(probe_ids, fills, queries, cap, bf16)
    work = _float_call(None, None, fills, probe_ids, queries, 1, 1.0, cap,
                       bf16)[0]
    parts = {name: work.view(name) for name in work.parts}
    return _prep_result(parts, ("qcast",))


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
    work, out_s, out_i, scores = _float_call(
        blocks, penalty, fills, probe_ids, queries, k, alpha, cap,
        blocks.dtype == torch.bfloat16)
    if scores is None:
        return out_s, out_i
    rows, _ = _schedule_rows(work.view("tile_idx"), work.view("n_sched")[0],
                             IVF_TILE)
    return _select(scores, rows, k)


# -- the digit scans ---------------------------------------------------------------


def _digit_call(kernel, corpus, fills, probe_ids, queries, k, cbias, cap):
    """One C call of a digit scan: the prologue, then (``corpus`` =
    ``(blocks, scales, penalty)``) the scan and the merge, or with
    ``corpus`` None the prologue alone; as :func:`_ivf_call`."""
    q = probe_ids.shape[0]
    probe_ids = probe_ids.to(torch.int32).contiguous()
    fills = fills.to(torch.int32).contiguous()
    queries = queries.float().contiguous()
    if cbias is not None:
        cbias = cbias.float().contiguous()
    named = None
    if corpus is not None:
        named = dict(zip(("blocks", "scales", "penalty"), corpus))

    def extra(q, d):
        i8, i32, f32 = torch.int8, torch.int32, torch.float32
        return (("digits", i8, (2 * q, d)), ("rho", f32, (q,)),
                ("qs1", f32, (q,)), ("qoff", i32, (2 * q,)))

    def head(d, q, nlist, nprobe, max_sched, runs):
        return (*map(_ptr, corpus or (None, None, None)), queries.data_ptr(),
                probe_ids.data_ptr(), fills.data_ptr(), _ptr(cbias), d, q, k,
                nlist, nprobe, cap, max_sched, digit_block(q), runs)

    def tail(work):
        ptrs = list(work.ptrs)
        if kernel == "ivf_topk_int8":
            ptrs[3] = None  # no nibble offsets
        return ptrs

    return _ivf_call(kernel, named, fills, probe_ids, queries, k, cap,
                     digit_block(q), (), extra, head, tail, cbias)


_DIGIT_NAMES = ("digits", "rho", "qs1", "qoff")


def ivf_digit_prep_plain(probe_ids, fills, queries, cbias, cap,
                         int4=False) -> dict:
    """What the digit scans' prologue kernel writes, from the plain pieces:
    ``quantize_queries`` (``digits``, ``rho``, ``qs1``),
    ``query_nibble_offsets`` (``qoff``, int4), ``build_probe_schedule``
    (``tile_idx``, ``clusters``, ``n_sched``), and ``probe_positions`` with
    ``_bias_pre`` (``table [Q, nlist]``: the probe's ``cbias / qs1``, ``-inf``
    where the query does not probe the cluster); ``members [blocks,
    max_sched, 2]``: per block of :func:`digit_block` queries, ``(tile,
    j)`` of each schedule entry ``j`` one of its queries probes, ascending,
    and ``member_count``."""
    q = probe_ids.shape[0]
    q_i8, rho, qs1 = quantize_queries(queries)
    bias = _bias_pre(cbias, qs1, probe_ids)

    def table(pos):
        return torch.where(pos >= 0, bias.gather(1, pos.clamp(min=0).long()),
                           float("-inf"))

    out = _plain_schedule(probe_ids, fills, cap, digit_block(q), table)
    out.update(digits=q_i8, rho=rho, qs1=qs1,
               qoff=query_nibble_offsets(q_i8) if int4 else None)
    return _prep_result(out, _DIGIT_NAMES)


def ivf_digit_prep(probe_ids, fills, queries, cbias, cap,
                   int4=False) -> dict:
    """The prologue kernel of the digit scans alone, on CUDA tensors (the
    plain twin on CPU ones); outputs as :func:`ivf_digit_prep_plain`."""
    if probe_ids.device.type == "cpu":
        return ivf_digit_prep_plain(probe_ids, fills, queries, cbias, cap,
                                    int4)
    kernel = "ivf_topk_int4" if int4 else "ivf_topk_int8"
    work = _digit_call(kernel, None, fills, probe_ids, queries, 1, cbias,
                       cap)[0]
    parts = {name: work.view(name) for name in work.parts}
    if not int4:
        parts["qoff"] = None
    return _prep_result(parts, _DIGIT_NAMES)


def _digit_scan(kernel, blocks, scales, penalty, fills, probe_ids, queries,
                k, cbias, cap):
    nlist, _, d = blocks.shape
    _check_ivf_args(penalty, fills, probe_ids, queries, nlist, cap, d)
    if d % 16:
        raise ValueError("the int8 / int4 CUDA scans need D % 16 == 0")
    if scales.shape != (nlist, cap) or scales.dtype != torch.float32:
        raise ValueError("scales must be [nlist, cap] float32")
    if cbias is not None and cbias.shape != probe_ids.shape:
        raise ValueError("cbias must be [Q, nprobe], as probe_ids")
    work, out_s, out_i, scores = _digit_call(
        kernel, (blocks, scales, penalty), fills, probe_ids, queries, k,
        cbias, cap)
    if scores is None:
        return out_s, out_i
    rows, _ = _schedule_rows(work.view("tile_idx"), work.view("n_sched")[0],
                             IVF_TILE)
    top, ids = _select(scores, rows, k)
    return top * work.view("qs1")[:, None], ids


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
                       probe_ids, queries, k, cbias, cap)


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
                       probe_ids, queries, k, cbias, 2 * half)
