"""Encoder attention in two layouts, each with its plain PyTorch version
and the wrapper of a hand-written CUDA kernel:

- ``[B, S, H]`` (the projection layout, heads split inside):
  :func:`mpnet_attention`, ``csrc/mpnet_attention.cu`` (replaces
  ``mpnet_flash_attention_nsh`` of
  ``tpu_search/ops/pallas_mpnet_attention.py``);
- ``[B, heads, S, hd]``: :func:`mpnet_attention_bhsd`,
  ``csrc/mpnet_attention_bhsd.cu`` (replaces ``mpnet_flash_attention``),
  for any head size up to 128.

:func:`attention_layout` says which one an encoder's shape takes.  Both
share one contract: one ``[heads, S, S]`` f32 bias shared by the batch;
the key mask additive ``[B, S]`` f32; whole-row softmax in f32 with a
guard for rows whose max is not finite (uniform weights, no NaN); the
probabilities rounded to the value dtype before ``P V``, which accumulates
in f32.

CPU tensors take the plain versions; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "attention_layout",
    "mpnet_attention",
    "mpnet_attention_bhsd",
    "mpnet_attention_bhsd_plain",
    "mpnet_attention_plain",
    "mpnet_attention_smem_bytes",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]


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


def _fn():
    fn = _build.library("mpnet_attention").mpnet_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def mpnet_attention_smem_bytes(hidden: int, num_heads: int) -> int:
    """The dynamic shared memory (bytes) one launch of the ``[B, S, H]``
    kernel takes at this width; it does not depend on S."""
    fn = _build.library("mpnet_attention").mpnet_attention_smem_bytes
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_int
    return fn(hidden, num_heads)


def mpnet_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    num_heads: int,
    scale: float = 1.0,
) -> torch.Tensor:
    """``[B, S, H]`` context; see the module docstring for the contract."""
    if q.device.type == "cpu":
        return mpnet_attention_plain(
            q, k, v, bias, key_mask_add, num_heads, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, h = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, S, H] shape")
    if h % num_heads or h // num_heads not in (32, 64, 128):
        raise ValueError(f"head dim {h}/{num_heads} not in (32, 64, 128)")
    if s % 64 or s > 512:
        raise ValueError(f"sequence {s} must be a multiple of 64, <= 512")
    if bias.shape != (num_heads, s, s) or key_mask_add.shape != (b, s):
        raise ValueError("bias must be [heads, S, S] and the mask [B, S]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16 on CUDA")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("bias", bias), ("key_mask_add", key_mask_add)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    out = torch.empty_like(q)
    code = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        key_mask_add.data_ptr(), out.data_ptr(), b, s, h, num_heads,
        float(scale), _build.stream_ptr(q.device),
    )
    _build.check(code, "mpnet_attention")
    _build.LAUNCHES["mpnet_attention"] += 1
    return out


def _bhsd_fn():
    fn = _build.library("mpnet_attention_bhsd").mpnet_attention_bhsd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def mpnet_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    key_mask_add: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """``[B, heads, S, hd]`` context; see the module docstring for the
    contract.  Any ``hd`` up to 128; ``S`` a multiple of 64, at most 512."""
    if q.device.type == "cpu":
        return mpnet_attention_bhsd_plain(q, k, v, bias, key_mask_add, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, nh, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, heads, S, hd] shape")
    if not 1 <= hd <= 128:
        raise ValueError(f"head dim {hd} not in 1..128")
    if s % 64 or s > 512:
        raise ValueError(f"sequence {s} must be a multiple of 64, <= 512")
    if bias.shape != (nh, s, s) or key_mask_add.shape != (b, s):
        raise ValueError("bias must be [heads, S, S] and the mask [B, S]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16 on CUDA")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("bias", bias), ("key_mask_add", key_mask_add)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    out = torch.empty_like(q)
    code = _bhsd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        key_mask_add.data_ptr(), out.data_ptr(), b, nh, s, hd,
        float(scale), _build.stream_ptr(q.device),
    )
    _build.check(code, "mpnet_attention_bhsd")
    _build.LAUNCHES["mpnet_attention_bhsd"] += 1
    return out
