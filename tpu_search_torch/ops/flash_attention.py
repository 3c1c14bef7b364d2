"""The stock flash attention of the JAX encoder's ``attention_impl="flash"``
mode, with its plain PyTorch version and the wrapper of a hand-written CUDA
kernel (``csrc/flash_attention.cu``).

It replaces ``jax.experimental.pallas.ops.tpu.flash_attention`` as
``tpu_search/models/mpnet.py`` calls it (:262-274, operands built at
:409-417): ``[B, heads, S, hd]`` q, k and v, an additive bias ``ab`` in the
compute dtype, segment ids, ``sm_scale = 1 / sqrt(hd)``, the default block
sizes (128 queries, 128 keys).  Its function, for each (batch row, head,
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
- the output in q's dtype.

The bias is one ``[heads, S, S]`` tensor shared by the batch, which holds
the values of JAX's ``[B, heads, S, S]`` broadcast without writing them out
per batch row.  S must be a multiple of 128 and the head size at most 128,
as the stock kernel's block sizes require; anything else raises
``ValueError`` on every device.

CPU tensors take :func:`flash_attention_plain` (which autograd
differentiates); a CUDA tensor launches the kernel or raises.  The kernel
writes its output outside autograd and has no backward, so on the card a
call with grad enabled and q, k, v or ``ab`` requiring it raises
``ValueError`` instead of giving them no gradient: the dense mode
(``ops.mpnet_attention.MPNetAttention``) is the one with a backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "BLOCK",
    "MASK_VALUE",
    "check_flash_shapes",
    "flash_attention",
    "flash_attention_plain",
]

BLOCK = 128  # the stock kernel's block_q, block_k_major and block_k
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P]


def check_flash_shapes(q, k, v, ab, q_seg, kv_seg) -> None:
    """Raise ``ValueError`` unless the operands have the shapes the stock
    kernel takes: ``[B, heads, S, hd]`` q, k and v with S a multiple of 128
    and hd at most 128, ``ab [heads, S, S]``, segment ids ``[B, S]``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, heads, S, hd] shape")
    b, nh, s, hd = q.shape
    if s < BLOCK:
        raise ValueError(f"block_q={BLOCK} should be smaller or equal to "
                         f"q_seq_len={s}")
    if s % BLOCK:
        raise ValueError(f"kv_seq_len={s} should be divisible by "
                         f"block_k_major={BLOCK}")
    if not 1 <= hd <= BLOCK:
        raise ValueError(f"head_dim={hd} outside 1..{BLOCK}")
    if ab.shape != (nh, s, s):
        raise ValueError(f"ab must be [heads, S, S] = {(nh, s, s)}, "
                         f"got {tuple(ab.shape)}")
    if q_seg.shape != (b, s) or kv_seg.shape != (b, s):
        raise ValueError("segment ids must be [B, S]")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """``[B, heads, S, hd]`` attention output in q's dtype, walking the
    128-key blocks in the stock kernel's order (see the module docstring)."""
    check_flash_shapes(q, k, v, ab, q_seg, kv_seg)
    s = q.shape[2]
    qf = q.float()
    live = q_seg[:, None, :, None] == kv_seg[:, None, None, :]  # [B,1,S,S]
    mask_add = torch.where(live, 0.0, MASK_VALUE).float()

    def scores(k0):
        kb = k[:, :, k0:k0 + BLOCK].float()
        sb = qf @ kb.transpose(-1, -2)
        sb = sb + ab[None, :, :, k0:k0 + BLOCK].float()
        sb = sb * sm_scale
        return sb + mask_add[..., k0:k0 + BLOCK]

    if s == BLOCK:
        sb = scores(0)
        m = sb.amax(dim=-1, keepdim=True)
        p = torch.exp(sb - m)
        p = p / p.sum(dim=-1, keepdim=True)
        return (p.to(v.dtype).float() @ v.float()).to(q.dtype)

    shape = q.shape[:3] + (1,)
    m = torch.full(shape, float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, s, BLOCK):
        sb = scores(k0)
        m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        o = p.to(v.dtype).float() @ v[:, :, k0:k0 + BLOCK].float()
        acc = acc + o * inv
        m, l = m_next, l_next
    return acc.to(q.dtype)


def _fn():
    fn = _build.library("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: torch.Tensor,
    q_seg: torch.Tensor,
    kv_seg: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """See the module docstring.  On the card: bf16 q, k, v and ab, int32
    segment ids, all contiguous."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, ab, q_seg, kv_seg, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _flash_kernel(q, k, v, ab, q_seg, kv_seg, sm_scale)


def _flash_kernel(q, k, v, ab, q_seg, kv_seg, sm_scale) -> torch.Tensor:
    """The card's branch of :func:`flash_attention`: ``flash_attention.cu``
    after the checks, refused under grad (it has no backward)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, ab)):
        raise ValueError(
            "flash_attention has no backward on the card: its kernel writes "
            "outside autograd, so q, k, v and ab would get no gradient; "
            "train with attention_impl='dense', whose MPNetAttention runs "
            "the backward kernel, or call it under torch.no_grad()")
    check_flash_shapes(q, k, v, ab, q_seg, kv_seg)
    b, nh, s, hd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("ab", ab)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16 on CUDA")
    for name, t in (("q_seg", q_seg), ("kv_seg", kv_seg)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    for name, t in (("k", k), ("v", v), ("ab", ab), ("q_seg", q_seg),
                    ("kv_seg", kv_seg)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    out = torch.empty_like(q)
    code = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(),
        q_seg.data_ptr(), kv_seg.data_ptr(), out.data_ptr(), b, nh, s, hd,
        float(sm_scale), _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
