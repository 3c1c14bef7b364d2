"""The arithmetic of the two-pass loop of ``csrc/mpnet_attention.cu`` and
``csrc/mpnet_attention_bhsd.cu``, modelled block by block on the CPU,
against the JAX package's Pallas kernels in interpret mode: the
layout-native ``mpnet_flash_attention_nsh`` (``[B, S, H]``) and
``mpnet_flash_attention`` (``[B, heads, S, hd]``, where the model pads
head columns with zeros to a multiple of 16, as the kernel does in shared
memory: hd 26 and 13 as TinyBERT's and an odd head size run it).

The kernel walks 64-key tiles twice.  Pass 1 keeps each row's running max
``m`` and its sum ``l`` of ``exp(s - m)``, rescaled whenever ``m`` grows;
pass 2 recomputes the same scores and forms ``p = bf16(exp(s - m) / l)``
(``bf16(1 / S)`` where ``m`` is not finite) before ``P V``, so the
normalized probabilities round where the TPU kernel rounds them.  The
model here does the same in f32 and is held to ``chip_smoke.attention_ok``'s
gates (max 3e-2, mean 1e-5, at most 1e-3 of outputs over one bf16 ulp), the
gates the kernel meets on the card.  A one-pass online softmax (round the
unnormalized ``exp(s - m_running)``, divide at the end) moves that rounding
and must fail them.  The kernel divides by ``l`` through its correctly
rounded reciprocal and one FMA correction; that this is the correctly
rounded quotient is checked here with exact rational arithmetic.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import attention_ok, bf16_errors
from tpu_search.ops.pallas_mpnet_attention import (
    mpnet_flash_attention,
    mpnet_flash_attention_nsh,
)

NEG = float(np.finfo(np.float32).min)
TILE = 64  # the kernel's keys per tile


def inputs(seed, b, s, h, nh, pad_value, shape=None):
    """bf16-representable q, k, v of ``shape`` (default ``[B, S, H]``), a
    ``[heads, S, S]`` bias, and a key mask with random lengths (row 0 full,
    row 1 fully padded)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape or (b, s, h))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    bias = (0.5 * rng.standard_normal((nh, s, s))).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    live = np.arange(s)[None, :] < lengths[:, None]
    mask = np.where(live, 0.0, pad_value).astype(np.float32)
    mask[1] = pad_value
    return q, k, v, torch.from_numpy(bias), torch.from_numpy(mask)


def jax_reference(q, k, v, bias, mask, nh, scale):
    out = mpnet_flash_attention_nsh(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)),
        jnp.asarray(bias.numpy()), jnp.asarray(mask.numpy()), num_heads=nh,
        scale=scale, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def jax_reference_bhsd(q, k, v, bias, mask, scale):
    out = mpnet_flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)),
        jnp.asarray(bias.numpy()), jnp.asarray(mask.numpy()), scale=scale,
        interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _heads(t, nh):
    b, s, h = t.shape
    return t.float().reshape(b, s, nh, h // nh).transpose(1, 2)


def _padded(t):
    """f32 ``[B, heads, S, hd]`` with head columns zero-padded to a
    multiple of 16, as the kernel stages them."""
    hd = t.shape[-1]
    return torch.nn.functional.pad(t.float(), (0, -hd % 16))


def _tile_scores(qf, kf, bias, mask, scale, t):
    """f32 ``(q k^T) * scale + bias + mask`` of key tile ``t``."""
    keys = slice(t * TILE, (t + 1) * TILE)
    s = (qf @ kf[:, :, keys].transpose(-1, -2)) * scale
    s = s + bias[None, :, :, keys]
    return s + mask[:, None, None, keys]


def _two_pass_heads(qf, kf, vf, bias, mask, scale):
    """The kernel's order over f32 ``[B, heads, S, hd]``: pass 1 online m
    and l, pass 2 p = bf16(exp(s - m) / l), P V in f32."""
    b, nh, s, _ = qf.shape
    m = torch.full((b, nh, s), float("-inf"))
    l = torch.zeros((b, nh, s))
    for t in range(s // TILE):
        sc = _tile_scores(qf, kf, bias, mask, scale, t)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new)
        l = l * torch.exp(m - shift) + torch.exp(sc - shift[..., None]).sum(-1)
        m = m_new
    safe = torch.isfinite(m)[..., None]
    o = torch.zeros_like(qf)
    for t in range(s // TILE):
        sc = _tile_scores(qf, kf, bias, mask, scale, t)
        p = torch.exp(sc - m[..., None]) / l[..., None]
        p = torch.where(safe, p, torch.tensor(1.0 / s, dtype=torch.float32))
        o = o + p.to(torch.bfloat16).float() @ vf[:, :, t * TILE:(t + 1) * TILE]
    return o


def two_pass(q, k, v, bias, mask, nh, scale):
    """The ``[B, S, H]`` kernel's loop."""
    o = _two_pass_heads(*(_heads(t, nh) for t in (q, k, v)), bias, mask,
                        scale)
    return o.transpose(1, 2).reshape(q.shape).to(torch.bfloat16)


def two_pass_bhsd(q, k, v, bias, mask, scale):
    """The ``[B, heads, S, hd]`` kernel's loop over zero-padded head
    columns; the output's padding columns are dropped."""
    o = _two_pass_heads(*(_padded(t) for t in (q, k, v)), bias, mask, scale)
    return o[..., :q.shape[-1]].to(torch.bfloat16)


def one_pass(q, k, v, bias, mask, nh, scale):
    """A one-pass online softmax: bf16(exp(s - m_running)) into P V, the
    output divided by l at the end (uniform weights where m is not
    finite, as the kernel)."""
    qf, kf, vf = (_heads(t, nh) for t in (q, k, v))
    b, _, s, _ = qf.shape
    m = torch.full((b, nh, s), float("-inf"))
    l = torch.zeros((b, nh, s))
    o = torch.zeros_like(qf)
    for t in range(s // TILE):
        sc = _tile_scores(qf, kf, bias, mask, scale, t)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - shift)
        e = torch.exp(sc - shift[..., None])
        l = l * corr + e.sum(-1)
        o = o * corr[..., None] + (e.to(torch.bfloat16).float()
                                   @ vf[:, :, t * TILE:(t + 1) * TILE])
        m = m_new
    safe = torch.isfinite(m)[..., None]
    uniform = (torch.full((s,), 1.0 / s).to(torch.bfloat16).float()
               @ vf)[..., None, :]
    o = torch.where(safe, o / l.clamp_min(1e-30)[..., None], uniform)
    return o.transpose(1, 2).reshape(q.shape).to(torch.bfloat16)


@pytest.mark.parametrize("pad_value", [NEG, -np.inf])
@pytest.mark.parametrize("nh", [2, 4])  # head dim 64 and 32 at H 128
@pytest.mark.parametrize("s", [64, 512])
def test_two_pass_model_meets_the_kernel_gates(s, nh, pad_value):
    b, h = 3, 128
    q, k, v, bias, mask = inputs(s + nh, b, s, h, nh, pad_value)
    scale = 1.0 / np.sqrt(h // nh)
    ref = jax_reference(q, k, v, bias, mask, nh, scale)
    got = two_pass(q, k, v, bias, mask, nh, scale)
    assert torch.isfinite(got.float()).all()
    errors = bf16_errors(got, ref)
    assert attention_ok(errors, "mpnet_attention"), errors


@pytest.mark.parametrize("pad_value", [NEG, -np.inf])
@pytest.mark.parametrize("nh,hd", [(2, 26), (2, 13), (2, 32)])
@pytest.mark.parametrize("s", [64, 512])
def test_two_pass_model_meets_the_kernel_gates_head_major(s, nh, hd,
                                                          pad_value):
    """hd 26 (TinyBERT's H 52 in two heads: 4-byte row copies), 13 (odd:
    plain stores) and 32 (the tiny-overlap reranker's: no padding)."""
    b = 3
    q, k, v, bias, mask = inputs(s + hd, b, s, nh * hd, nh, pad_value,
                                 shape=(b, nh, s, hd))
    scale = 1.0 / np.sqrt(hd)
    ref = jax_reference_bhsd(q, k, v, bias, mask, scale)
    got = two_pass_bhsd(q, k, v, bias, mask, scale)
    assert got.shape == (b, nh, s, hd) and torch.isfinite(got.float()).all()
    errors = bf16_errors(got, ref)
    assert attention_ok(errors, "mpnet_attention_bhsd"), errors


def test_one_pass_softmax_fails_the_gates():
    b, s, h, nh = 3, 384, 128, 2
    q, k, v, bias, mask = inputs(7, b, s, h, nh, NEG)
    scale = 1.0 / np.sqrt(h // nh)
    ref = jax_reference(q, k, v, bias, mask, nh, scale)
    two = bf16_errors(two_pass(q, k, v, bias, mask, nh, scale), ref)
    errors = bf16_errors(one_pass(q, k, v, bias, mask, nh, scale), ref)
    print(f"two-pass {two}\none-pass {errors}")  # shown with pytest -s
    assert attention_ok(two, "mpnet_attention"), two
    assert not attention_ok(errors, "mpnet_attention"), errors


def _f32(x):
    return np.float32(x)


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the exact ``x`` (ties to even)."""
    guess = np.float32(float(x))
    best = None
    for c in (np.nextafter(guess, np.float32(-np.inf)), guess,
              np.nextafter(guess, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        odd = int(np.array(c).view(np.uint32)) & 1
        if best is None or d < best[0] or (d == best[0] and not odd):
            best = (d, c)
    return best[1]


def test_reciprocal_division_is_the_correctly_rounded_quotient():
    """p = fma(fma(-q1, l, e), r, q1) with r = RN(1 / l) and q1 = RN(e * r)
    equals RN(e / l) (Markstein), for e = exp(s - m) in (0, 1] and l in
    [1, 512]: the kernel's p is exactly the plain version's quotient."""
    rng = np.random.default_rng(0)
    es = np.concatenate([rng.random(3000, dtype=np.float32),
                         np.exp(-rng.random(1000) * 80).astype(np.float32),
                         np.float32([1.0, 0.5, 2.0 ** -20])])
    ls = np.concatenate([(1 + rng.random(2000) * 511).astype(np.float32),
                         (1 + rng.random(2003)).astype(np.float32)])
    for e, l in zip(es, ls):
        e, l = _f32(e), _f32(l)
        r = _round_f32(Fraction(1) / Fraction(float(l)))
        q1 = _round_f32(Fraction(float(e)) * Fraction(float(r)))
        res = _round_f32(Fraction(float(e)) - Fraction(float(q1))
                         * Fraction(float(l)))
        p = _round_f32(Fraction(float(res)) * Fraction(float(r))
                       + Fraction(float(q1)))
        assert p == _round_f32(Fraction(float(e)) / Fraction(float(l))), (e, l)
