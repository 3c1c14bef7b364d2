"""Encoder attention in two layouts, each with its plain PyTorch version
and the wrapper of a hand-written CUDA kernel:

- ``[B, S, H]`` (the projection layout, heads split inside):
  :func:`mpnet_attention`, ``csrc/mpnet_attention.cu`` (replaces
  ``mpnet_flash_attention_nsh`` of
  ``tpu_search/ops/pallas_mpnet_attention.py``);
- ``[B, heads, S, hd]``: :func:`mpnet_attention_bhsd`,
  ``csrc/mpnet_attention_bhsd.cu`` (replaces ``mpnet_flash_attention``),
  for any head size up to 128.

Those two kernels take bf16.  f32 inputs, in either layout, launch
``csrc/mpnet_attention_f32.cu`` (replaces no TPU kernel: the JAX package
runs f32 through its dense XLA graph).

:func:`attention_layout` says which one an encoder's shape takes.  Both
share one contract: one ``[heads, S, S]`` f32 bias shared by the batch;
the key mask additive ``[B, S]`` f32; whole-row softmax in f32 with a
guard for rows whose max is not finite (uniform weights, no NaN); the
probabilities rounded to the value dtype before ``P V``, which accumulates
in f32.

The gradient: where grad is enabled and q, k, v or the bias needs it, the
wrappers run :class:`MPNetAttention`, whose forward is the same kernel
and whose backward is :func:`mpnet_attention_bwd`
(``csrc/mpnet_attention_bwd.cu``, no TPU kernel either: JAX differentiates
its dense graph), with :func:`mpnet_attention_bwd_plain` its plain
version.  Otherwise they call the forward kernels as they are, saving
nothing.

CPU tensors take the plain versions; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "MPNetAttention",
    "attention_layout",
    "mpnet_attention",
    "mpnet_attention_bhsd",
    "mpnet_attention_bhsd_plain",
    "mpnet_attention_bwd",
    "mpnet_attention_bwd_plain",
    "mpnet_attention_plain",
    "mpnet_attention_smem_bytes",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]
_F32_ARGTYPES = [_P] * 6 + [_I] * 4 + [_L] * 3 + [ctypes.c_float, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I] * 4 + [_L] * 3 + [_I, ctypes.c_float, _P]


def attention_layout(hidden: int, num_heads: int) -> str:
    """``"bsh"`` where the ``[B, S, H]`` kernel takes the shape (the JAX
    encoder's layout-native condition, ``models/mpnet.py:218``, and a head
    size the kernel is built for), else ``"bhsd"``."""
    hd = hidden // num_heads
    native = (hidden % 128 == 0 and 128 % hd == 0
              and num_heads % (128 // hd) == 0)
    return "bsh" if native and hd in (32, 64, 128) else "bhsd"


def mpnet_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    num_heads: int,
    scale: float = 1.0,
) -> torch.Tensor:
    b, s, h = q.shape
    hd = h // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    ctx = mpnet_attention_bhsd_plain(heads(q), heads(k), heads(v), bias,
                                     key_mask_add, scale)
    return ctx.transpose(1, 2).reshape(b, s, h)


def mpnet_attention_bhsd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """``[B, heads, S, hd]`` context in ``q``'s dtype."""
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * scale
    scores = scores + bias.float()[None]
    scores = scores + key_mask_add.float()[:, None, None, :]
    row_max = scores.amax(dim=-1, keepdim=True)
    safe = torch.isfinite(row_max)
    shift = torch.where(safe, row_max, torch.zeros_like(row_max))
    scores = torch.where(safe, scores - shift, torch.zeros_like(scores))
    e = torch.exp(scores)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


def mpnet_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    grad_out: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    scale: float = 1.0,
    num_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv, dbias)`` of the attention by its explicit formula, in
    f32 (``csrc/mpnet_attention_bwd.cu``'s contract and oracle): q, k, v
    and ``grad_out`` in ``[B, S, H]`` when ``num_heads`` is given, else
    ``[B, heads, S, hd]``; dq, dk, dv in q's layout and dtype, dbias
    ``[heads, S, S]`` f32.  P is recomputed as the forward computes it; dV
    takes P rounded to v's dtype, dS the f32 P; rows whose max is not
    finite get dS = 0; the key mask gets no gradient."""
    if num_heads is not None:
        b, s, h = q.shape

        def heads(t):
            return t.reshape(b, s, num_heads, h // num_heads).transpose(1, 2)

        dq, dk, dv, dbias = mpnet_attention_bwd_plain(
            heads(q), heads(k), heads(v), heads(grad_out), bias,
            key_mask_add, scale)
        return (*(t.transpose(1, 2).reshape(b, s, h) for t in (dq, dk, dv)),
                dbias)
    qf, kf, vf, do = q.float(), k.float(), v.float(), grad_out.float()
    scores = qf @ kf.transpose(-1, -2)
    scores = scores * scale
    scores = scores + bias.float()[None]
    scores = scores + key_mask_add.float()[:, None, None, :]
    row_max = scores.amax(dim=-1, keepdim=True)
    safe = torch.isfinite(row_max)
    shift = torch.where(safe, row_max, torch.zeros_like(row_max))
    scores = torch.where(safe, scores - shift, torch.zeros_like(scores))
    e = torch.exp(scores)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = torch.where(safe, ds, torch.zeros_like(ds))
    dq = ds @ kf * scale
    dk = ds.transpose(-1, -2) @ qf * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=0)


def _geometry(q: torch.Tensor, num_heads: Optional[int]):
    """``(b, heads, s, hd, (sb, sh, ss))``: q's sizes and the element
    strides of (batch, head, row) in its layout, ``[B, S, H]`` when
    ``num_heads`` is given, else ``[B, heads, S, hd]``."""
    if num_heads is None:
        b, nh, s, hd = q.shape
        return b, nh, s, hd, (nh * s * hd, s * hd, hd)
    b, s, h = q.shape
    if h % num_heads:
        raise ValueError(f"hidden {h} does not divide by {num_heads} heads")
    return b, num_heads, s, h // num_heads, (s * h, h // num_heads, h)


def _check_operands(q, tensors, bias, key_mask_add, b, nh, s, dtypes,
                    what: str) -> None:
    for name, t in tensors:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not q's "
                             f"{tuple(q.shape)}")
        if t.dtype not in dtypes or t.dtype != q.dtype or (
                not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {what} on CUDA, "
                             f"of q's dtype")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if bias.shape != (nh, s, s) or key_mask_add.shape != (b, s):
        raise ValueError("bias must be [heads, S, S] and the mask [B, S]")
    for name, t in (("bias", bias), ("key_mask_add", key_mask_add)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _library_fn(library: str, name: str, argtypes):
    fn = getattr(_build.library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _f32_forward(q, k, v, bias, key_mask_add, scale, num_heads):
    """``csrc/mpnet_attention_f32.cu``: the f32 forward in either layout."""
    b, nh, s, hd, strides = _geometry(q, num_heads)
    _check_operands(q, (("k", k), ("v", v)), bias, key_mask_add, b, nh, s,
                    (torch.float32,), "float32")
    if not 1 <= hd <= 128:
        raise ValueError(f"head dim {hd} not in 1..128")
    out = torch.empty_like(q)
    code = _library_fn("mpnet_attention_f32", "mpnet_attention_f32",
                       _F32_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        key_mask_add.data_ptr(), out.data_ptr(), b, nh, s, hd, *strides,
        float(scale), _build.stream_ptr(q.device),
    )
    _build.check(code, "mpnet_attention_f32")
    _build.LAUNCHES["mpnet_attention_f32"] += 1
    return out


def mpnet_attention_smem_bytes(hidden: int, num_heads: int) -> int:
    """The dynamic shared memory (bytes) one launch of the ``[B, S, H]``
    kernel takes at this width; it does not depend on S."""
    fn = _build.library("mpnet_attention").mpnet_attention_smem_bytes
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_int
    return fn(hidden, num_heads)


def _bf16_forward(q, k, v, bias, key_mask_add, scale, num_heads):
    """``csrc/mpnet_attention.cu`` (``[B, S, H]``) or
    ``csrc/mpnet_attention_bhsd.cu`` (``num_heads`` None): bf16 alone,
    S a multiple of 64 up to 512."""
    b, nh, s, hd, _ = _geometry(q, num_heads)
    if num_heads is not None and hd not in (32, 64, 128):
        raise ValueError(f"head dim {q.shape[2]}/{num_heads} not in "
                         f"(32, 64, 128)")
    if num_heads is None and not 1 <= hd <= 128:
        raise ValueError(f"head dim {hd} not in 1..128")
    if s % 64 or s > 512:
        raise ValueError(f"sequence {s} must be a multiple of 64, <= 512")
    _check_operands(q, (("q", q), ("k", k), ("v", v)), bias, key_mask_add,
                    b, nh, s, (torch.bfloat16,), "bfloat16")
    if num_heads is None:
        name, dims = "mpnet_attention_bhsd", (b, nh, s, hd)
    else:
        name, dims = "mpnet_attention", (b, s, q.shape[2], num_heads)
    out = torch.empty_like(q)
    code = _library_fn(name, name, _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        key_mask_add.data_ptr(), out.data_ptr(), *dims, float(scale),
        _build.stream_ptr(q.device),
    )
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out


def _forward(q, k, v, bias, key_mask_add, scale, num_heads):
    """The forward in the layout ``num_heads`` names, outside autograd: the
    plain version on the CPU, else the kernel of q's dtype."""
    if q.device.type == "cpu":
        if num_heads is None:
            return mpnet_attention_bhsd_plain(q, k, v, bias, key_mask_add,
                                              scale)
        return mpnet_attention_plain(q, k, v, bias, key_mask_add, num_heads,
                                     scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype == torch.float32:
        return _f32_forward(q, k, v, bias, key_mask_add, scale, num_heads)
    return _bf16_forward(q, k, v, bias, key_mask_add, scale, num_heads)


def mpnet_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    grad_out: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    scale: float = 1.0,
    num_heads: Optional[int] = None,
    bias_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(dq, dk, dv, dbias)``: :func:`mpnet_attention_bwd_plain`'s
    contract, by ``csrc/mpnet_attention_bwd.cu`` on the card (bf16 or f32,
    either layout, head dim up to 128, any S; one C call of three launches,
    two without ``bias_grad``).  ``dbias`` is None when ``bias_grad`` is
    false, and the call then allocates no ``[B, heads, S, S]`` scratch."""
    if q.device.type == "cpu":
        out = mpnet_attention_bwd_plain(q, k, v, grad_out, bias,
                                        key_mask_add, scale, num_heads)
        return out if bias_grad else (*out[:3], None)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, nh, s, hd, strides = _geometry(q, num_heads)
    _check_operands(q, (("k", k), ("v", v), ("grad_out", grad_out)), bias,
                    key_mask_add, b, nh, s,
                    (torch.bfloat16, torch.float32), "bfloat16 or float32")
    if not 1 <= hd <= 128:
        raise ValueError(f"head dim {hd} not in 1..128")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    dbias = torch.empty((nh, s, s), **f32) if bias_grad else None
    # each row's (m, l, 1 / l, D), and the f32 dS the bias's batch sum reads
    stats = torch.empty((b, nh, s, 4), **f32)
    ds = torch.empty((b, nh, s, s), **f32) if bias_grad else None
    code = _library_fn("mpnet_attention_bwd", "mpnet_attention_bwd",
                       _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(),
        bias.data_ptr(), key_mask_add.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr() if dbias is not None else None,
        ds.data_ptr() if ds is not None else None, stats.data_ptr(), b, nh,
        s, hd,
        *strides, int(q.dtype == torch.bfloat16), float(scale),
        _build.stream_ptr(q.device),
    )
    _build.check(code, "mpnet_attention_bwd")
    _build.LAUNCHES["mpnet_attention_bwd"] += 1
    return dq, dk, dv, dbias


class MPNetAttention(torch.autograd.Function):
    """The attention with a gradient, in the layout ``num_heads`` names
    (``[B, S, H]`` when given, else ``[B, heads, S, hd]``): the forward
    kernel (or the plain version on the CPU), then
    :func:`mpnet_attention_bwd` from the saved q, k, v, bias and mask (the
    backward recomputes P; the forward saves nothing else)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask_add, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias, key_mask_add)
        ctx.scale, ctx.num_heads = scale, num_heads
        return _forward(q, k, v, bias, key_mask_add, scale, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias, key_mask_add = ctx.saved_tensors
        dq, dk, dv, dbias = mpnet_attention_bwd(
            q, k, v, grad_out.contiguous(), bias, key_mask_add, ctx.scale,
            ctx.num_heads, bias_grad=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mpnet_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    num_heads: int,
    scale: float = 1.0,
) -> torch.Tensor:
    """``[B, S, H]`` context; see the module docstring for the contract.
    bf16 on the card: head dim 32, 64 or 128, S a multiple of 64 up to
    512; f32: head dim up to 128, any S."""
    if _wants_grad(q, k, v, bias):
        return MPNetAttention.apply(q, k, v, bias, key_mask_add, scale,
                                    num_heads)
    return _forward(q, k, v, bias, key_mask_add, scale, num_heads)


def mpnet_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """``[B, heads, S, hd]`` context; see the module docstring for the
    contract.  Any ``hd`` up to 128; bf16 on the card: ``S`` a multiple
    of 64, at most 512."""
    if _wants_grad(q, k, v, bias):
        return MPNetAttention.apply(q, k, v, bias, key_mask_add, scale, None)
    return _forward(q, k, v, bias, key_mask_add, scale, None)
