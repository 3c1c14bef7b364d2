"""The W8A8 GEMM family of the JAX package's ``ops/pallas_int8_gemm.py``.

- :func:`quantize_rows` (:45): symmetric per-row int8 quantization, as the
  jitted JAX function computes it (plain PyTorch on every device, as it is
  plain XLA there);
- :func:`int8_gemm` (:646): ``((x_q . w) * sx) * sw + bias``, optional
  tanh-gelu (``csrc/int8_gemm.cu``);
- :func:`int8_ffn_in` (:158): the same with gelu, plus each row's max
  ``|y|`` over the f32 ``y``: ``int8_ffn_ln``'s GEMM1 with ``h`` in the
  output dtype (``csrc/int8_ffn_ln.cu``);
- :func:`int8_ffn_out` (:275): requantizes ``h`` with those maxima, GEMM,
  bias and residual: ``int8_ffn_ln``'s GEMM2 loop on 128 x 256 tiles whose
  consumers quantize ``h`` into shared memory, so that the int8 copy of
  ``h`` never exists in device memory (``csrc/int8_ffn_ln.cu``);
- :func:`int8_ffn_fused` (:578): the whole FFN in one call, whose GEMM1,
  requantize and GEMM2 are ``int8_ffn_ln``'s launches
  (``csrc/int8_ffn_ln.cu``); ``h`` passes through device memory.

Weights come in the port's ``[out, in]`` int8 layout (``w [N, K]``, as
``ops/int8_ffn.py`` takes them; the JAX functions take ``[K, N]``) with f32
column scales.  The epilogues round where XLA rounds the JAX kernels
(measured against them in interpret mode): ``acc * s_row`` rounds, ``*
s_col + bias`` is one fused multiply-add, a residual adds after; ``127 /
amax`` is the f32 quotient and ``amax / 127.0`` the multiply ``amax *
f32(1/127)``.

Each ``*_plain`` function is the plain version (the CPU path and the
kernel's oracle on the card): the int8 products run as float64 matmuls,
exact as the kernels' int32 sums are.  Each wrapper takes its plain
version for a CPU tensor, launches its kernel for a CUDA tensor, and
raises otherwise; ``out_dtype`` is bfloat16 or float32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .int8_ffn import (
    MAX_HIDDEN,
    MAX_INTERMEDIATE,
    _fma,
    _quantize_rows_by,
    _scratch,
)
from .topk_scan import INV127

__all__ = [
    "int8_ffn_fused",
    "int8_ffn_fused_plain",
    "int8_ffn_in",
    "int8_ffn_in_plain",
    "int8_ffn_out",
    "int8_ffn_out_plain",
    "int8_gemm",
    "int8_gemm_plain",
    "quantize_rows",
]

OUT_DTYPES = (torch.bfloat16, torch.float32)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "int8_gemm": [_P] * 6 + [_I] * 5 + [_P],
    "int8_ffn_in": [_P] * 7 + [_I] * 4 + [_P],
    "int8_ffn_out": [_P] * 7 + [_I] * 6 + [_P],
    "int8_ffn_fused": [_P] * 10 + [_I] * 3 + [_P] * 3 + [_I] * 2 + [_P],
}
# The library of each export: its own, but the FFN's pieces are exports of
# int8_ffn_ln's library, on its GEMM loops.
_LIBRARY = {name: "int8_ffn_ln"
            for name in ("int8_ffn_in", "int8_ffn_out", "int8_ffn_fused")}


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x ~ x_q * sx[:, None]``: ``(x_q [M, K] int8, sx [M] f32)`` with
    ``sx = max|x| * f32(1/127)`` (1 for an all-zero row) and ``x_q =
    clip(rint(x / sx))``, a true quotient."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    sx = torch.where(amax > 0, amax * float(INV127), 1.0)
    x_q = torch.clamp(torch.round(xf / sx[:, None]), -127.0, 127.0)
    return x_q.to(torch.int8), sx


def _gelu(y):
    c = 0.7978845608028654
    return 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))


def _product(x_q, w):
    """``x_q [M, K] . w [N, K]^T`` as f32 (exact sums, rounded to f32 once,
    as the kernels convert their int32 sums)."""
    return (x_q.double() @ w.double().T).float()


def _check_out(out_dtype):
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32, not {out_dtype}")


def _dequant(acc, s_row, s_col, bias):
    return _fma(acc * s_row.float().reshape(-1, 1), s_col.float(), bias.float())


def int8_gemm_plain(x_q, w, sx, sw, bias, fuse_gelu=False,
                    out_dtype=torch.bfloat16):
    y = _dequant(_product(x_q, w), sx, sw, bias)
    return (_gelu(y) if fuse_gelu else y).to(out_dtype)


def int8_ffn_in_plain(x_q, w, sx, sw, bias, out_dtype=torch.bfloat16):
    y = _gelu(_dequant(_product(x_q, w), sx, sw, bias))
    return y.to(out_dtype), y.abs().amax(dim=1, keepdim=True)


def int8_ffn_out_plain(h, row_amax, w, sw, bias, residual,
                       out_dtype=torch.bfloat16):
    h_q, scale = _quantize_rows_by(h.float(), row_amax.float().reshape(-1, 1))
    y = _dequant((h_q @ w.double().T).float(), scale, sw, bias)
    return (y + residual.float()).to(out_dtype)


def int8_ffn_fused_plain(x_q, sx, w1, s1, b1, w2, s2, b2, residual,
                         out_dtype=torch.bfloat16):
    h = _gelu(_dequant(_product(x_q, w1), sx, s1, b1))
    return int8_ffn_out_plain(h, h.abs().amax(dim=1), w2, s2, b2, residual,
                              out_dtype)


# -- the wrappers ---------------------------------------------------------------


def _fn(name):
    fn = getattr(_build.library(_LIBRARY.get(name, name)), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _operand(t, shape, dtypes, what, dev):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {list(shape)}, got {list(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what} must be {' or '.join(map(str, dtypes))}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous on {dev}")
    return t


def _vector(t, n, what, dev):
    if t.numel() != n or t.device != dev:
        raise ValueError(f"{what} must hold {n} values on {dev}")
    return t.reshape(n).to(torch.float32).contiguous()


def _multiple_of_8(**dims):
    for name, v in dims.items():
        if v <= 0 or v % 8:
            raise ValueError(f"{name} = {v}: the int8 kernels take multiples of 8")


def _gemm_args(x_q, w, sx, sw, bias):
    dev = x_q.device
    m, k = x_q.shape
    n = w.shape[0]
    _multiple_of_8(K=k, N=n)
    _operand(x_q, (m, k), (torch.int8,), "x_q", dev)
    _operand(w, (n, k), (torch.int8,), "w", dev)
    return (dev, m, n, k, _vector(sx, m, "sx", dev), _vector(sw, n, "sw", dev),
            _vector(bias, n, "bias", dev))


def int8_gemm(x_q: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
              sw: torch.Tensor, bias: torch.Tensor, fuse_gelu: bool = False,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x_q [M, K] int8``, ``w [N, K] int8``, f32 ``sx [M]``, ``sw [N]``,
    ``bias [N]`` -> ``[M, N]`` in ``out_dtype``.  On the card K and N are
    multiples of 8; M is any."""
    _check_out(out_dtype)
    if not _on_card(x_q):
        return int8_gemm_plain(x_q, w, sx, sw, bias, fuse_gelu, out_dtype)
    dev, m, n, k, sxf, swf, bf = _gemm_args(x_q, w, sx, sw, bias)
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    code = _fn("int8_gemm")(
        x_q.data_ptr(), w.data_ptr(), sxf.data_ptr(), swf.data_ptr(),
        bf.data_ptr(), y.data_ptr(), m, n, k, int(fuse_gelu),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(code, "int8_gemm")
    _build.LAUNCHES["int8_gemm"] += 1
    return y


def int8_ffn_in(x_q: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, bias: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN's first GEMM with gelu: ``(h [M, N] out_dtype, row_amax
    [M, 1] f32)``, ``row_amax`` the max ``|y|`` of each row over the f32
    ``y`` before its cast (what :func:`int8_ffn_out` quantizes ``h``
    with).  Operands as :func:`int8_gemm`."""
    _check_out(out_dtype)
    if not _on_card(x_q):
        return int8_ffn_in_plain(x_q, w, sx, sw, bias, out_dtype)
    dev, m, n, k, sxf, swf, bf = _gemm_args(x_q, w, sx, sw, bias)
    h = torch.empty((m, n), dtype=out_dtype, device=dev)
    amax = torch.empty((m,), dtype=torch.int32, device=dev)  # zeroed there
    code = _fn("int8_ffn_in")(
        x_q.data_ptr(), w.data_ptr(), sxf.data_ptr(), swf.data_ptr(),
        bf.data_ptr(), h.data_ptr(), amax.data_ptr(), m, n, k,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(code, "int8_ffn_in")
    _build.LAUNCHES["int8_ffn_in"] += 1
    return h, amax.view(torch.float32).reshape(m, 1)


def int8_ffn_out(h: torch.Tensor, row_amax: torch.Tensor, w: torch.Tensor,
                 sw: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The FFN's second GEMM: ``h [M, K]`` (bf16 or f32) requantized per row
    with ``row_amax [M, 1]`` inside the kernel, times ``w [N, K] int8``,
    ``* sw + bias + residual [M, N]`` (bf16 or f32) -> ``[M, N]``."""
    _check_out(out_dtype)
    if not _on_card(h):
        return int8_ffn_out_plain(h, row_amax, w, sw, bias, residual,
                                  out_dtype)
    dev = h.device
    m, k = h.shape
    n = w.shape[0]
    _multiple_of_8(K=k, N=n)
    _operand(h, (m, k), OUT_DTYPES, "h", dev)
    _operand(w, (n, k), (torch.int8,), "w", dev)
    _operand(residual, (m, n), OUT_DTYPES, "residual", dev)
    amax = _vector(row_amax, m, "row_amax", dev)
    swf, bf = _vector(sw, n, "sw", dev), _vector(bias, n, "bias", dev)
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    code = _fn("int8_ffn_out")(
        h.data_ptr(), amax.data_ptr(), w.data_ptr(), swf.data_ptr(),
        bf.data_ptr(), residual.data_ptr(), y.data_ptr(), m, n, k,
        int(h.dtype == torch.bfloat16), int(residual.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(code, "int8_ffn_out")
    _build.LAUNCHES["int8_ffn_out"] += 1
    return y


def int8_ffn_fused(x_q: torch.Tensor, sx: torch.Tensor, w1: torch.Tensor,
                   s1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   s2: torch.Tensor, b2: torch.Tensor, residual: torch.Tensor,
                   out_dtype: torch.dtype = torch.bfloat16,
                   splits: int = 1) -> torch.Tensor:
    """The whole W8A8 FFN in one call: ``x_q [M, H] int8``, ``sx [M]``,
    ``w1 [I, H]``, ``w2 [H, I]`` int8, f32 ``s1, b1 [I]``, ``s2, b2 [H]``,
    ``residual [M, H]`` -> ``[M, H]``.  The gelu output is quantized from
    f32 (the pair quantizes int8_ffn_in's output, in its dtype).  On the
    card H and I are multiples of 8 up to 1,024 and 4,096.

    ``splits`` (at least 1) only carves the TPU kernel's row block into
    sub-chains there, each row's arithmetic the same for every value, so
    it changes nothing here."""
    _check_out(out_dtype)
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    if not _on_card(x_q):
        return int8_ffn_fused_plain(x_q, sx, w1, s1, b1, w2, s2, b2,
                                    residual, out_dtype)
    dev = x_q.device
    m, h = x_q.shape
    inter = w1.shape[0]
    if h % 8 or not 0 < h <= MAX_HIDDEN or inter % 8 or not (
            0 < inter <= MAX_INTERMEDIATE):
        raise ValueError(
            f"hidden {h} / intermediate {inter} not supported: the fused "
            f"FFN takes multiples of 8 up to {MAX_HIDDEN} / "
            f"{MAX_INTERMEDIATE}")
    _operand(x_q, (m, h), (torch.int8,), "x_q", dev)
    _operand(w1, (inter, h), (torch.int8,), "w1", dev)
    _operand(w2, (h, inter), (torch.int8,), "w2", dev)
    _operand(residual, (m, h), OUT_DTYPES, "residual", dev)
    vecs = [_vector(t, n, what, dev) for t, n, what in (
        (sx, m, "sx"), (s1, inter, "s1"), (b1, inter, "b1"), (s2, h, "s2"),
        (b2, h, "b2"))]
    sxf, s1f, b1f, s2f, b2f = vecs
    y = torch.empty((m, h), dtype=out_dtype, device=dev)
    # the amax_h [M] words, h [M, I] f32 and h_q [M, I] int8
    work, ptrs = _scratch(dev, 4 * m, 4 * m * inter,
                          m * inter)  # alive until enqueued
    code = _fn("int8_ffn_fused")(
        x_q.data_ptr(), sxf.data_ptr(), w1.data_ptr(), s1f.data_ptr(),
        b1f.data_ptr(), w2.data_ptr(), s2f.data_ptr(), b2f.data_ptr(),
        residual.data_ptr(), y.data_ptr(), m, h, inter, *ptrs,
        int(residual.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(code, "int8_ffn_fused")
    _build.LAUNCHES["int8_ffn_fused"] += 1
    return y
