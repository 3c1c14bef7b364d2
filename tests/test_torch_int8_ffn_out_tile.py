"""Why ``int8_ffn_out``'s ``quant_word`` (``csrc/int8_ffn_ln.cu``) may
round without a conversion instruction: clip ``v * inv`` (an f32 product)
to +-127, add 1.5 * 2^23 in f32 and keep the low byte of the sum's bits.
The f32 add rounds half to even, as ``rintf`` does, so the codes are the
port's quantizer's (``ops/int8_ffn._quantize_rows_by``).  The kernel
itself is held to its plain twin on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np

MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def quant_word(v, inv):
    """``quant_word`` in numpy: the code as the low byte of the f32 sum's
    bits, read as int8."""
    t = np.clip(np.float32(v) * np.float32(inv), np.float32(-127),
                np.float32(127)).astype(np.float32)
    bits = (t + MAGIC).astype(np.float32).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


def test_quant_word_rounds_half_to_even_and_clips():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 1e6, -1e6,
                  -127.5, 0.0, -0.0], dtype=np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 126, 127, 127, -127, -127, 0, 0],
                    dtype=np.int8)
    np.testing.assert_array_equal(quant_word(v, np.float32(1)), want)
