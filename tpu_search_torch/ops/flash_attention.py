"""The stock flash attention of the JAX encoder's ``attention_impl="flash"``
mode, forward and backward, with their plain PyTorch versions and the
wrappers of three hand-written CUDA kernels: ``csrc/flash_attention.cu``
(the bf16 forward), ``csrc/flash_attention_f32.cu`` (the f32 forward, 3xTF32
wgmma) and ``csrc/flash_attention_bwd.cu`` (the backward: bf16 wgmma and
TMA in bf16 up to hd 256, 3xTF32 wgmma in f32 and tf32 wgmma in bf16
above).

It replaces ``jax.experimental.pallas.ops.tpu.flash_attention`` as
``tpu_search/models/mpnet.py`` calls it (:262-274, operands built at
:409-417): ``[B, heads, S, hd]`` q, k and v, an additive bias ``ab`` in the
compute dtype, segment ids, ``sm_scale = 1 / sqrt(hd)``, the default block
sizes (128 queries, 128 keys).  Its forward, for each (batch row, head,
query), in f32 over 128-key blocks in order:

- ``s = (q . k^T + f32(ab)) * sm_scale``: the bias is added **before** the
  scale (not the dense path's ``q . k^T * scale + bias``);
- ``s += where(q_seg == kv_seg, 0, -0.7 * f32max)``: a query attends to the
  keys of its own segment, so a pad query (segment 0) attends to the pad
  keys only;
- S = 128 (one block): ``p = exp(s - max) / sum``, rounded to v's dtype,
  then ``p @ v`` in f32;
- S > 128: the online softmax with the running max ``m`` and sum ``l``;
  ``acc`` stays normalized: ``acc = acc * (alpha * l_prev / l) + (p.to(
  v.dtype) @ v) / l`` with ``p = exp(s - m)`` unnormalized and ``1 / l``
  taken once (``l == 0`` gives 1);
- the output in q's dtype; under grad also each row's final ``m`` and
  ``l`` (f32 ``[B, heads, S]``), the stock kernel's ``save_residuals``.

Its backward is the stock kernel's VJP (``_flash_attention_bwd``, with its
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq`` kernels), per
(batch row, head), in f32 over 128-key blocks:

- ``di = rowsum(f32(o) * f32(dO))``, from the forward's output in q's
  dtype (not ``rowsum(P * dP)``);
- ``s`` as in the forward, ``p = exp(s - m) * (1 / l)``;
- ``dV = p.to(dO.dtype)^T dO``; ``dP = dO V^T``;
  ``dS = (dP - di) * p * sm_scale``;
- ``dK = dS.to(dO.dtype)^T q``, ``dQ = dS.to(k.dtype) K``: in bf16 dS is
  rounded once, before both products; in f32 nothing rounds;
- the bias's gradient ``dS.to(ab.dtype)`` per batch row, summed over the
  batch (the transpose of JAX's broadcast of one ``[heads, S, S]`` bias to
  ``[B, heads, S, S]``), in f32 and rounded to ab's dtype once, in the
  card kernel's order (:func:`grouped_batch_sum`: groups of
  :data:`BIAS_GROUP_ROWS` batch rows from B 32 on, each summed in order,
  then the groups in order; one group below); the segment ids get none.

The bias is one ``[heads, S, S]`` tensor shared by the batch, which holds
the values of JAX's ``[B, heads, S, S]`` broadcast without writing them out
per batch row.  S must be a multiple of 128, as the stock kernel's block
sizes require, and a head size above 128 a multiple of 128 where S > 128,
as the stock kernel's tiling requires (``NotImplementedError``, as JAX
raises, on the CPU and on the card alike); the card's kernels take every
head size the stock kernel takes.

CPU tensors take the plain versions; a CUDA tensor launches the kernels or
raises.  Where grad is enabled and q, k, v or ``ab`` needs it,
:func:`flash_attention` runs :class:`FlashAttention`, whose forward keeps
``(m, l)`` and whose backward is :func:`flash_attention_bwd` (on the CPU
the plain versions of both: the CPU path follows JAX's VJP, not autograd
of the plain forward).  Otherwise it calls the forward alone, saving
nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "BLOCK",
    "FlashAttention",
    "MASK_VALUE",
    "check_flash_shapes",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_plain",
    "grouped_batch_sum",
]

BLOCK = 128  # the stock kernel's block_q, block_k_major and block_k
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# Batch rows a group of the backward's bias gradient sums (the card
# kernel's kGroupRows): B // 16 groups, so that their f32 partials hold an
# eighth of the bytes of every row's bf16 dS (a sixteenth of its f32 dS).
BIAS_GROUP_ROWS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = ([_P] * 9 + [_I] * 4 + [ctypes.c_float, _P], ctypes.c_int)
# each C entry point's (argtypes, restype)
_SIGNATURES = {
    "flash_attention": _FWD,
    "flash_attention_f32": _FWD,
    "flash_attention_bwd": ([_P] * 16 + [_I] * 6 + [ctypes.c_float, _P],
                            ctypes.c_int),
    "flash_attention_bwd_workspace": ([_I] * 6, ctypes.c_longlong),
}


def check_flash_shapes(q, k, v, ab, q_seg, kv_seg) -> None:
    """Raise ``ValueError`` unless the operands have the shapes the stock
    kernel takes: ``[B, heads, S, hd]`` q, k and v with S a multiple of
    128, ``ab [heads, S, S]``, segment ids ``[B, S]``; and
    ``NotImplementedError`` for a head size above 128 that is not a
    multiple of 128 where S > 128, as the stock kernel raises."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, heads, S, hd] shape")
    b, nh, s, hd = q.shape
    if s < BLOCK:
        raise ValueError(f"block_q={BLOCK} should be smaller or equal to "
                         f"q_seq_len={s}")
    if s % BLOCK:
        raise ValueError(f"kv_seq_len={s} should be divisible by "
                         f"block_k_major={BLOCK}")
    if hd < 1:
        raise ValueError(f"head_dim={hd} is empty")
    if s > BLOCK and hd > BLOCK and hd % BLOCK:
        raise NotImplementedError(f"head_dim={hd} should be a multiple of "
                                  f"{BLOCK} if larger")
    if ab.shape != (nh, s, s):
        raise ValueError(f"ab must be [heads, S, S] = {(nh, s, s)}, "
                         f"got {tuple(ab.shape)}")
    if q_seg.shape != (b, s) or kv_seg.shape != (b, s):
        raise ValueError("segment ids must be [B, S]")


def _mask_add(q_seg, kv_seg) -> torch.Tensor:
    """``[B, 1, S, S]`` f32: 0 where the query's segment is the key's, the
    stock mask value elsewhere."""
    live = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    return torch.where(live, 0.0, MASK_VALUE).float()


def _scores(q32, k, ab, mask_add, k0, sm_scale) -> torch.Tensor:
    """``(q k^T + f32(ab)) * sm_scale + mask`` against keys k0 .. k0 + 127,
    in f32, each operation rounding where the stock kernel's does."""
    kb = k[:, :, k0:k0 + BLOCK].float()
    sb = q32 @ kb.transpose(-1, -2)
    sb = sb + ab[None, :, :, k0:k0 + BLOCK].float()
    sb = sb * sm_scale
    return sb + mask_add[..., k0:k0 + BLOCK]


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, m, l)``: the ``[B, heads, S, hd]`` attention output in q's
    dtype, walking the 128-key blocks in the stock kernel's order (see the
    module docstring), and each row's final max ``m`` and sum ``l`` of
    ``exp(s - m)``, f32 ``[B, heads, S]``."""
    check_flash_shapes(q, k, v, ab, q_seg, kv_seg)
    s = q.shape[2]
    qf = q.float()
    mask_add = _mask_add(q_seg, kv_seg)

    if s == BLOCK:
        sb = _scores(qf, k, ab, mask_add, 0, sm_scale)
        m = sb.amax(dim=-1, keepdim=True)
        p = torch.exp(sb - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        out = (p.to(v.dtype).float() @ v.float()).to(q.dtype)
        return out, m[..., 0], l[..., 0]

    shape = q.shape[:3] + (1,)
    m = torch.full(shape, float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, s, BLOCK):
        sb = _scores(qf, k, ab, mask_add, k0, sm_scale)
        m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        o = p.to(v.dtype).float() @ v[:, :, k0:k0 + BLOCK].float()
        acc = acc + o * inv
        m, l = m_next, l_next
    return acc.to(q.dtype), m[..., 0], l[..., 0]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """The ``[B, heads, S, hd]`` attention output in q's dtype
    (:func:`flash_attention_fwd_plain` without the residuals)."""
    return flash_attention_fwd_plain(q, k, v, ab, q_seg, kv_seg, sm_scale)[0]


def bias_group_rows(b: int) -> int:
    """The batch rows of a group of the bias's gradient at batch size
    ``b``, in either dtype: ``ceil(b / groups)`` with ``max(1, b // 16)``
    groups."""
    groups = max(1, b // BIAS_GROUP_ROWS)
    return -(-b // groups)


def grouped_batch_sum(x: torch.Tensor, group: int) -> torch.Tensor:
    """``x [B, ...]`` summed over its first axis in f32 in a fixed order:
    each run of ``group`` rows from the first, in order, then the runs'
    sums in order (the card's bias gradient: a CTA sums its group's rows
    into shared memory, one pass then sums the groups)."""
    x = x.float()
    parts = []
    for g0 in range(0, x.shape[0], group):
        acc = x[g0].clone()
        for row in range(g0 + 1, min(x.shape[0], g0 + group)):
            acc = acc + x[row]
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    out: torch.Tensor,
    grad_out: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    sm_scale: float,
    ab_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(dq, dk, dv, dab)`` of the stock kernel's VJP (see the module
    docstring), over 128-key blocks at its rounding sites, from the
    forward's output ``out`` and residuals ``m``, ``l``: dq, dk, dv in the
    dtypes of q, k, v; ``dab [heads, S, S]`` in ab's dtype, None without
    ``ab_grad``."""
    check_flash_shapes(q, k, v, ab, q_seg, kv_seg)
    s = q.shape[2]
    qf, dof = q.float(), grad_out.float()
    di = (out.float() * dof).sum(dim=-1, keepdim=True)
    m = m[..., None].float()
    inv_l = 1.0 / l[..., None].float()
    mask_add = _mask_add(q_seg, kv_seg)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs, dabs = [], [], []
    for k0 in range(0, s, BLOCK):
        sb = _scores(qf, k, ab, mask_add, k0, sm_scale)
        p = torch.exp(sb - m) * inv_l
        dvs.append(p.to(grad_out.dtype).float().transpose(-1, -2) @ dof)
        dp = dof @ v[:, :, k0:k0 + BLOCK].float().transpose(-1, -2)
        ds = (dp - di) * p
        ds = ds * sm_scale
        dks.append(ds.to(grad_out.dtype).float().transpose(-1, -2) @ qf)
        dq = dq + ds.to(k.dtype).float() @ k[:, :, k0:k0 + BLOCK].float()
        if ab_grad:
            dabs.append(grouped_batch_sum(
                ds.to(ab.dtype), bias_group_rows(q.shape[0])).to(ab.dtype))
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    dab = torch.cat(dabs, dim=-1) if ab_grad else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dab


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")


def _fn(name: str, source: Optional[str] = None):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``<name>.cu``
    by default)."""
    fn = getattr(_build.library(source or name), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _workspace_bytes(b, nh, s, ld, bf16: bool, ab_grad: bool) -> int:
    """The bytes of the backward's workspace (``csrc/flash_attention_bwd.cu``
    ``flash_attention_bwd_workspace``): each row's statistics, the
    bias's partial sums (a [groups, heads, S, S] f32 partial, groups B /
    16, where there is more than one group) and dQ's f32 scratch (where the
    row pass takes the keys in chunks)."""
    nbytes = _fn("flash_attention_bwd_workspace", "flash_attention_bwd")(
        b, nh, s, ld, int(bf16), int(ab_grad))
    if nbytes < 0:
        raise ValueError(f"no backward plan fits the card at B={b} S={s} "
                         f"ld={ld}")
    return nbytes


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 backward's operand: rows of a multiple of 8
    elements on a 16-byte aligned base (zero columns appended where hd % 8,
    a copy where the base is not aligned), as TMA copies them (up to hd 256;
    the tf32 passes above read the same rows)."""
    pad = -t.shape[-1] % 8
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_card_operands(q, tensors, q_seg, kv_seg) -> None:
    """The card kernels' operand rules (the shapes are
    :func:`check_flash_shapes`'s, as the stock kernel's): bf16 or f32 q and
    every tensor of ``tensors`` of q's dtype, int32 segment ids, all
    contiguous and on q's device."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("q must be bfloat16 or float32 on CUDA")
    for name, t in tensors:
        if t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {q.dtype} on CUDA, "
                             f"q's dtype")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q_seg", q_seg), ("kv_seg", kv_seg)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flash_kernel(q, k, v, ab, q_seg, kv_seg, sm_scale,
                  residuals: bool = False):
    """The card's forward: ``flash_attention.cu`` (bf16) or
    ``flash_attention_f32.cu`` (f32) after the checks, one launch.
    Returns ``(out, m, l)``; ``m`` and ``l`` are None unless
    ``residuals``, and the kernel then writes none."""
    _check_card_operands(q, (("q", q), ("k", k), ("v", v), ("ab", ab)),
                         q_seg, kv_seg)
    check_flash_shapes(q, k, v, ab, q_seg, kv_seg)
    b, nh, s, hd = q.shape
    name = ("flash_attention" if q.dtype == torch.bfloat16
            else "flash_attention_f32")
    out = torch.empty_like(q)
    m = l = None
    if residuals:
        m, l = (torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
                for _ in range(2))
    code = _fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(),
        q_seg.data_ptr(), kv_seg.data_ptr(), out.data_ptr(), _ptr(m),
        _ptr(l), b, nh, s, hd, float(sm_scale), _build.stream_ptr(q.device),
    )
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out, m, l


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, m, l)`` (:func:`flash_attention_fwd_plain`'s contract), by
    the forward kernel of q's dtype on the card, outside autograd."""
    if not _on_card(q):
        return flash_attention_fwd_plain(q, k, v, ab, q_seg, kv_seg, sm_scale)
    return _flash_kernel(q, k, v, ab, q_seg, kv_seg, sm_scale, True)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    out: torch.Tensor,
    grad_out: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    sm_scale: float,
    ab_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(dq, dk, dv, dab)``: :func:`flash_attention_bwd_plain`'s contract,
    by ``csrc/flash_attention_bwd.cu`` on the card (bf16 or f32, every
    tensor of q's dtype): one C call of three launches (the rows'
    statistics, the row pass, the column pass), one more that sums the
    bias's partials where ``ab_grad`` and more than one batch group, and in
    the tf32 passes (f32, and bf16 above hd 256) one more that sums dQ's
    parts where the row pass splits the keys; without ``ab_grad`` ``dab``
    is None.  In bf16, q, k, v and dO with a
    head size that is not a multiple of 8 go to the kernel as zero-padded
    copies (TMA copies rows of a multiple of 16 bytes)."""
    if not _on_card(q):
        return flash_attention_bwd_plain(q, k, v, ab, q_seg, kv_seg, out,
                                         grad_out, m, l, sm_scale, ab_grad)
    _check_card_operands(
        q, (("q", q), ("k", k), ("v", v), ("ab", ab), ("out", out),
            ("grad_out", grad_out)), q_seg, kv_seg)
    check_flash_shapes(q, k, v, ab, q_seg, kv_seg)
    b, nh, s, hd = q.shape
    for name, t in (("m", m), ("l", l)):
        if (t.shape != (b, nh, s) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 [B, heads, "
                             f"S] on q's device")
    bf16 = q.dtype == torch.bfloat16
    ops = ([_tma_rows(t) for t in (q, k, v, grad_out)] if bf16
           else [q, k, v, grad_out])
    ld = ops[0].shape[-1]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dab = torch.empty_like(ab) if ab_grad else None
    work = torch.empty(_workspace_bytes(b, nh, s, ld, bf16, ab_grad),
                       dtype=torch.uint8, device=q.device)
    code = _fn("flash_attention_bwd")(
        *(t.data_ptr() for t in ops), out.data_ptr(), grad_out.data_ptr(),
        ab.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), m.data_ptr(),
        l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(dab), work.data_ptr(), b, nh, s, hd, ld, int(bf16),
        float(sm_scale), _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv, dab


class FlashAttention(torch.autograd.Function):
    """The flash attention with the stock kernel's gradient:
    :func:`flash_attention_fwd` (the output and ``(m, l)``), then
    :func:`flash_attention_bwd` from the saved q, k, v, ``ab``, segment
    ids, output and ``(m, l)``; the bias's gradient only where ``ab``
    needs one, the segment ids none."""

    @staticmethod
    def forward(ctx, q, k, v, ab, q_seg, kv_seg, sm_scale):
        out, m, l = flash_attention_fwd(q, k, v, ab, q_seg, kv_seg, sm_scale)
        ctx.save_for_backward(q, k, v, ab, q_seg, kv_seg, out, m, l)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, ab, q_seg, kv_seg, out, m, l = ctx.saved_tensors
        dq, dk, dv, dab = flash_attention_bwd(
            q, k, v, ab, q_seg, kv_seg, out, grad_out.contiguous(), m, l,
            ctx.sm_scale, ab_grad=ctx.needs_input_grad[3])
        return dq, dk, dv, dab, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """See the module docstring.  On the card: q, k, v and ab contiguous
    in one dtype, bf16 or f32; int32 segment ids, contiguous."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, ab)):
        return FlashAttention.apply(q, k, v, ab, q_seg, kv_seg, sm_scale)
    if not _on_card(q):
        return flash_attention_plain(q, k, v, ab, q_seg, kv_seg, sm_scale)
    return _flash_kernel(q, k, v, ab, q_seg, kv_seg, sm_scale)[0]
