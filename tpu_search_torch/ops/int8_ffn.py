"""The W8A8 post-attention half of an encoder layer.

LN1 -> int8 quantize -> GEMM1 -> tanh-gelu -> requantize -> GEMM2 ->
residual -> LN2, the function of ``int8_ffn_ln_fused`` in
``tpu_search/ops/pallas_int8_gemm.py``, with each of its rounding sites:
the LN1 output and ``ff + residual`` round to the output dtype,
activations quantize by multiplying with ``127 / amax`` (round half to
even, clip to +-127), the weight quantizer divides by its scale, every
``amax / 127.0`` is ``amax * f32(1/127)``, and the two dequantize
epilogues ``acc * s_row * s_col + bias`` round once, as an FMA of
``acc * s_row``, ``s_col`` and the bias: XLA computes them so under jit
(the kernel in interpret mode on planted inputs,
``tests/test_torch_int8_ffn.py``).

Widths: on the card H a multiple of 8 up to 1,024 and I a multiple of 8 up
to 4,096; the wrapper raises ``ValueError`` beyond them.

Weights are passed in PyTorch's ``[out, in]`` layout (``w1 [I, H]``,
``w2 [H, I]``), which is also what the tensor-core kernel wants.

:func:`int8_ffn_ln_plain` is the plain version (CPU and the comparison on
the card); :func:`int8_ffn_ln` launches ``csrc/int8_ffn_ln.cu`` for a CUDA
tensor or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .topk_scan import INV127

__all__ = ["int8_ffn_ln", "int8_ffn_ln_plain", "quantize_weight_columns"]

MAX_HIDDEN, MAX_INTERMEDIATE = 1024, 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 11 + [ctypes.c_float, _I, _I, _I, _P, _P, _P, _P, _P]


def _div(a, b):
    """IEEE ``a / b`` with one operand a Python number.  ``tensor / 127.0``
    and ``127.0 / tensor`` are not: PyTorch computes them through a
    reciprocal on CUDA (and ``127.0 / tensor`` on every device), which
    differs from the true quotient in the last bit and moves int8 codes at
    .5 steps away from the JAX package's and the kernels' ``127 / amax``."""
    if isinstance(a, (int, float)):
        a = torch.full_like(b, a)
    else:
        b = torch.full_like(a, b)
    return a / b


def quantize_weight_columns(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 quantization of an ``[in, out]``
    weight (``tpu_search/models/mpnet.py`` ``_qcol_stacked``, as the jitted
    forward runs it): returns ``(w_q [in, out] int8, scale [out] f32)``
    with ``w ~ w_q * scale``, ``scale = amax * f32(1/127)`` (1 for a zero
    column) and ``w_q = clip(rint(w / scale))``, a true quotient."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    s = torch.where(amax > 0, amax * float(INV127), 1.0)
    wq = torch.clamp(torch.round(wf / s[None, :]), -127.0, 127.0)
    return wq.to(torch.int8), s


def _quantize_rows_mul(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_q f64 [M, K], scale [M, 1] f32)``: multiply by ``127 / amax``
    (the f32 quotient); ``scale = amax * f32(1/127)``."""
    return _quantize_rows_by(x, x.abs().amax(dim=1, keepdim=True))


def _quantize_rows_by(x, amax):
    """``x [M, K]`` f32 quantized with the row maxima ``amax [M, 1]`` f32,
    as the JAX int8 kernels requantize inside: ``(x_q f64, scale f32)``."""
    live = amax > 0
    inv = torch.where(live, _div(127.0, amax), torch.zeros_like(amax))
    xq = torch.clamp(torch.round(x * inv), -127.0, 127.0)
    scale = torch.where(live, amax * float(INV127), 1.0)
    return xq.double(), scale


def _fma(a, b, c):
    """``a * b + c`` of f32 tensors, rounded to f32 once (a float64 product
    of two f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _layer_norm_f32(x, scale, bias, eps):
    mean = x.mean(dim=1, keepdim=True)
    var = torch.square(x - mean).mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def int8_ffn_ln_plain(
    pre: torch.Tensor,
    w1_q: torch.Tensor,
    s1: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    s2: torch.Tensor,
    b2: torch.Tensor,
    ln1_scale: torch.Tensor,
    ln1_bias: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    eps: float = 1e-5,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``pre [M, H]`` -> ``[M, H]`` in ``out_dtype``.  The int8 products
    run as float64 matmuls: every int8 product sum (|.| < 2^53) is exact,
    as the int32 accumulation of the kernels is."""
    f = torch.float32
    xln = _layer_norm_f32(
        pre.to(f), ln1_scale.to(f), ln1_bias.to(f), eps
    )
    x = xln.to(out_dtype).to(f)
    x_q, sx = _quantize_rows_mul(x)
    acc1 = (x_q @ w1_q.double().T).to(f)
    y = _fma(acc1 * sx, s1.to(f), b1.to(f))
    c = 0.7978845608028654
    h = 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))
    h_q, scale_h = _quantize_rows_mul(h)
    acc2 = (h_q @ w2_q.double().T).to(f)
    ff = _fma(acc2 * scale_h, s2.to(f), b2.to(f)) + x
    ffc = ff.to(out_dtype).to(f)
    out = _layer_norm_f32(ffc, ln2_scale.to(f), ln2_bias.to(f), eps)
    return out.to(out_dtype)


def _fn():
    fn = _build.library("int8_ffn_ln").int8_ffn_ln
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def int8_ffn_ln(
    pre: torch.Tensor,
    w1_q: torch.Tensor,
    s1: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    s2: torch.Tensor,
    b2: torch.Tensor,
    ln1_scale: torch.Tensor,
    ln1_bias: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    eps: float = 1e-5,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """See the module docstring; ``w1_q [I, H]``, ``w2_q [H, I]`` int8."""
    if pre.device.type == "cpu":
        return int8_ffn_ln_plain(
            pre, w1_q, s1, b1, w2_q, s2, b2, ln1_scale, ln1_bias,
            ln2_scale, ln2_bias, eps, out_dtype,
        )
    if pre.device.type != "cuda":
        raise ValueError(f"unsupported device {pre.device}")
    m, h = pre.shape
    inter = w1_q.shape[0]
    if h % 8 or not 0 < h <= MAX_HIDDEN or inter % 8 or not (
            0 < inter <= MAX_INTERMEDIATE):
        raise ValueError(
            f"hidden {h} / intermediate {inter} not supported: the CUDA FFN "
            f"takes multiples of 8 up to {MAX_HIDDEN} / {MAX_INTERMEDIATE}")
    if out_dtype != torch.bfloat16 or pre.dtype != torch.bfloat16:
        raise ValueError("the CUDA FFN takes and returns bfloat16")
    if w1_q.shape != (inter, h) or w2_q.shape != (h, inter):
        raise ValueError("w1_q must be [I, H] and w2_q [H, I]")
    if w1_q.dtype != torch.int8 or w2_q.dtype != torch.int8:
        raise ValueError("weights must be int8")
    tensors = (pre, w1_q, w2_q)
    for t in tensors:
        if not t.is_contiguous() or t.device != pre.device:
            raise ValueError("operands must be contiguous on one device")
    vecs = []
    for t, n in ((s1, inter), (b1, inter), (s2, h), (b2, h), (ln1_scale, h),
                 (ln1_bias, h), (ln2_scale, h), (ln2_bias, h)):
        if t.shape != (n,) or t.device != pre.device:
            raise ValueError("scale/bias vectors have the wrong shape")
        vecs.append(t.to(torch.float32).contiguous())
    dev = pre.device
    xres = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    hbuf = torch.empty((m, inter), dtype=torch.float32, device=dev)
    amax = torch.zeros((m,), dtype=torch.int32, device=dev)
    out = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
    s1f, b1f, s2f, b2f, l1s, l1b, l2s, l2b = vecs
    code = _fn()(
        pre.data_ptr(), w1_q.data_ptr(), s1f.data_ptr(), b1f.data_ptr(),
        w2_q.data_ptr(), s2f.data_ptr(), b2f.data_ptr(),
        l1s.data_ptr(), l1b.data_ptr(), l2s.data_ptr(), l2b.data_ptr(),
        float(eps), m, h, inter,
        xres.data_ptr(), hbuf.data_ptr(), amax.data_ptr(), out.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(code, "int8_ffn_ln")
    _build.LAUNCHES["int8_ffn_ln"] += 1
    return out
