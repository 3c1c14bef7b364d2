"""The attention's gradient (``ops.mpnet_attention``: ``MPNetAttention``,
``mpnet_attention_bwd`` and its plain version) against ``jax.vjp`` of the
JAX encoder's dense attention and against torch autograd of the plain
forward, on the same seeded numpy inputs.

The JAX side is the dense branch of ``_attention``
(``tpu_search/models/mpnet.py:276-281``) on given q, k, v: scores by an
f32 einsum, the bias plus additive mask, ``jax.nn.softmax``, the
probabilities cast to the compute dtype, the context einsum.  Cases: both
layouts (``[B, S, H]`` and ``[B, heads, S, hd]``), head dims 8, 26 and 64,
a batch row with masked keys, f32 and bf16; S 24 (the plain versions take
any S; the card's kernels are held to them in ``chip_smoke.py``).

Tolerances, each max |error| over the largest |reference| of its output:
- f32: 1e-5.  The three computations differ in the order of f32 sums
  only (read: at most 5.9e-7).
- bf16: 2^-5 anywhere, and at most 1 % of elements more than 2^-7 (two
  bf16 ulps at the top of the range) off (read: at most 5.1e-3, none past
  2^-7).  dQ, dK and dV are rounded to bf16 on the way out, and both
  references round dP (the gradient through the rounded P) to bf16 where
  the contract keeps it in f32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search_torch.ops.mpnet_attention import (
    MPNetAttention,
    mpnet_attention,
    mpnet_attention_bhsd,
    mpnet_attention_bhsd_plain,
    mpnet_attention_bwd,
    mpnet_attention_bwd_plain,
    mpnet_attention_plain,
)

B, S, NH = 2, 24, 3
NEG = float(np.finfo(np.float32).min)
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
BF16_SHARE = 0.01


def inputs(seed: int, hd: int, dtype: str):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, NH, S, hd)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((NH, S, S)) * 0.5).astype(np.float32)
    mask = np.zeros((B, S), np.float32)
    mask[1, 17:] = NEG  # batch row 1 is padded past token 17
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q, k, v, do = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                       for t in (q, k, v, do))
    return q, k, v, do, bias, mask


def jax_vjp(q, k, v, do, bias, mask, dtype: str):
    """``(dq, dk, dv, dbias)`` of the dense branch, ``[B, heads, S, hd]``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    hd = q.shape[-1]

    def dense(q, k, v, bias):
        scores = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                            preferred_element_type=jnp.float32)
        scores = scores / math.sqrt(hd)
        scores = scores + (bias[None] + jnp.asarray(mask)[:, None, None, :])
        probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
        return jnp.einsum("bhqk,bhkd->bhqd", probs, v)

    args = [jnp.asarray(t, jd) for t in (q, k, v)] + [jnp.asarray(bias)]
    _, pull = jax.vjp(dense, *args)
    return [np.asarray(g, np.float32) for g in pull(jnp.asarray(do, jd))]


def to_layout(t: np.ndarray, layout: str, dtype) -> torch.Tensor:
    x = torch.from_numpy(t)
    if layout == "bsh":
        b, nh, s, hd = t.shape
        x = x.transpose(1, 2).reshape(b, s, nh * hd)
    return x.contiguous().to(dtype)


def from_layout(x: torch.Tensor, layout: str, hd: int) -> np.ndarray:
    x = x.detach().float()
    if layout == "bsh":
        b, s, _ = x.shape
        x = x.reshape(b, s, NH, hd).transpose(1, 2)
    return x.numpy()


def check(got, want, dtype: str, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want) / scale
    if dtype == "float32":
        assert err.max() <= F32_TOL, (what, err.max())
    else:
        assert err.max() <= 4 * BF16_TOL, (what, err.max())
        assert (err > BF16_TOL).mean() <= BF16_SHARE, (
            what, (err > BF16_TOL).mean())


def autograd_plain(q, k, v, do, bias, mask, layout, hd, dtype):
    """Torch autograd of the plain forward, in the layout."""
    tq, tk, tv = (to_layout(t, layout, dtype).requires_grad_()
                  for t in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    tm = torch.from_numpy(mask)
    if layout == "bsh":
        out = mpnet_attention_plain(tq, tk, tv, tb, tm, NH, hd ** -0.5)
    else:
        out = mpnet_attention_bhsd_plain(tq, tk, tv, tb, tm, hd ** -0.5)
    out.backward(to_layout(do, layout, dtype))
    return [from_layout(t.grad, layout, hd) for t in (tq, tk, tv)] + [
        tb.grad.numpy()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [8, 26, 64])
@pytest.mark.parametrize("layout", ["bsh", "bhsd"])
def test_backward_matches_jax_and_autograd(layout, hd, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v, do, bias, mask = inputs(hd, hd, dtype)
    want = jax_vjp(q, k, v, do, bias, mask, dtype)
    auto = autograd_plain(q, k, v, do, bias, mask, layout, hd, tdt)
    nh = NH if layout == "bsh" else None
    plain = mpnet_attention_bwd_plain(
        *(to_layout(t, layout, tdt) for t in (q, k, v, do)),
        torch.from_numpy(bias), torch.from_numpy(mask), hd ** -0.5, nh)
    assert [t.dtype for t in plain] == [tdt, tdt, tdt, torch.float32]
    plain = [from_layout(t, layout, hd) for t in plain[:3]] + [
        plain[3].numpy()]
    # The wrapper's gradient through autograd: the Function runs the plain
    # backward on the CPU, bit for bit.
    tq, tk, tv = (to_layout(t, layout, tdt).requires_grad_()
                  for t in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    args = (tq, tk, tv, tb, torch.from_numpy(mask))
    if layout == "bsh":
        out = mpnet_attention(*args, NH, hd ** -0.5)
    else:
        out = mpnet_attention_bhsd(*args, hd ** -0.5)
    assert out.grad_fn is not None
    out.backward(to_layout(do, layout, tdt))
    fn = [from_layout(t.grad, layout, hd) for t in (tq, tk, tv)] + [
        tb.grad.numpy()]
    for name, p, f, a, w in zip(("dq", "dk", "dv", "dbias"), plain, fn,
                                auto, want):
        np.testing.assert_array_equal(f, p, err_msg=name)
        check(p, w, dtype, f"{name} vs jax")
        check(p, a, dtype, f"{name} vs autograd")
    # the masked keys of row 1 get no key or value gradient
    for g in (plain[1], plain[2]):
        assert not g[1, :, 17:].any()


def test_no_grad_calls_the_forward_alone():
    """Without a tensor that needs grad, or under no_grad, the wrappers
    return the forward as before: no graph, nothing saved."""
    q, k, v, _, bias, mask = inputs(0, 8, "float32")
    args = [torch.from_numpy(t) for t in (q, k, v, bias, mask)]
    out = mpnet_attention_bhsd(*args, 0.25)
    assert out.grad_fn is None
    assert torch.equal(out, mpnet_attention_bhsd_plain(*args, 0.25))
    args[0].requires_grad_()
    with torch.no_grad():
        assert mpnet_attention_bhsd(*args, 0.25).grad_fn is None
    out = mpnet_attention_bhsd(*args, 0.25)
    assert type(out.grad_fn).__name__ == "MPNetAttentionBackward"


def test_rows_with_no_finite_max_get_no_score_gradient():
    """A row whose scores are all -inf takes uniform weights forward and
    dS = 0 backward: its dq is zero, it adds nothing to dbias or dk, and
    its uniform P still reaches dv, as autograd of the plain forward
    gives."""
    q, k, v, do, bias, _ = inputs(3, 8, "float32")
    mask = np.zeros((B, S), np.float32)
    mask[0] = -np.inf
    got = mpnet_attention_bwd(
        *(torch.from_numpy(t) for t in (q, k, v, do, bias, mask)), 8 ** -0.5)
    auto = autograd_plain(q, k, v, do, bias, mask, "bhsd", 8, torch.float32)
    assert not got[0][0].any()
    np.testing.assert_allclose(got[2][0].numpy(),
                               do[0].sum(axis=1, keepdims=True) / S
                               * np.ones_like(do[0]), rtol=1e-5, atol=1e-6)
    for g, a in zip(got, auto):
        assert np.isfinite(g.numpy()).all()
        check(g.numpy(), a, "float32", "unsafe rows")
    assert mpnet_attention_bwd(
        *(torch.from_numpy(t) for t in (q, k, v, do, bias, mask)), 0.5,
        bias_grad=False)[3] is None


def test_function_marks_the_mask_without_gradient():
    q, k, v, do, bias, mask = inputs(5, 8, "float32")
    t = [torch.from_numpy(x) for x in (q, k, v, bias, mask)]
    t[4].requires_grad_()
    t[0].requires_grad_()
    out = MPNetAttention.apply(*t, 0.5, None)
    out.backward(torch.from_numpy(do))
    assert t[4].grad is None and t[0].grad is not None


def design_bwd(q, k, v, do, bias, mask, scale, ds_split=True, tile=64):
    """``(dq, dk, dv, dbias)`` by ``csrc/mpnet_attention_bwd.cu``'s
    arithmetic in plain torch, ``[B, heads, S, hd]`` bf16 operands: every
    product of bf16 operands exact with f32 sums; m, l and
    d = sum exp(s - m) dP online over key tiles (rescaled as m grows), so
    D = d / l is the f32 rowsum(P o dP); P = exp(s - m) / l; dS rounded to
    bf16 hi + lo (``ds_split``) for ``dS K`` and ``dS^T Q``, each half its
    own product into one f32 sum, or to one bf16 (the trap)."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s_all = ((qf @ kf.transpose(-1, -2)) * scale + bias[None]) + mask[
        :, None, None, :]
    dp_all = dof @ vf.transpose(-1, -2)
    shape = s_all.shape[:-1]
    m = torch.full(shape, float("-inf"))
    l, d = torch.zeros(shape), torch.zeros(shape)
    for kb in range(0, s_all.shape[-1], tile):
        st, dpt = s_all[..., kb:kb + tile], dp_all[..., kb:kb + tile]
        m_new = torch.maximum(m, st.amax(-1))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new)
        e = torch.exp(st - shift[..., None])
        f = torch.exp(m - shift)
        l, d, m = l * f + e.sum(-1), d * f + (e * dpt).sum(-1), m_new
    safe = torch.isfinite(m)[..., None]
    big_d = torch.where(safe, (d / l)[..., None], 0.0)
    p = torch.where(safe, torch.exp(s_all - torch.where(safe, m[..., None],
                                                        0.0)) / l[..., None],
                    1.0 / s_all.shape[-1])
    ds = torch.where(safe, p * (dp_all - big_d), 0.0)
    hi = ds.to(torch.bfloat16).float()
    parts = (hi, (ds - hi).to(torch.bfloat16).float()) if ds_split else (hi,)
    dq = sum(x @ kf for x in parts) * scale
    dk = sum(x.transpose(-1, -2) @ qf for x in parts) * scale
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ dof
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16), ds.sum(dim=0))


@pytest.mark.parametrize("layout", ["bsh", "bhsd"])
def test_tensor_core_design_numerics_pass_the_card_gates(layout):
    """The redesigned backward's arithmetic (``design_bwd``) against
    ``mpnet_attention_bwd_plain`` under ``chip_smoke.py``'s bf16 gates:
    dQ, dK and dV within ``ATTN_GRAD_BF16_TOL`` of the largest value and at
    most ``ATTN_GRAD_ULP_SHARE`` of outputs more than one bf16 ulp off;
    dBias (f32) within ``ATTN_GRAD_F32_TOL``.  B 2, 4 heads, S 256, hd 64,
    a key-padded row, a trained-scale bias; inputs in either layout go
    through the plain twin, the design runs on their heads.  Rounding dS
    to one bf16 instead of hi + lo breaks the ulp gate on dQ and dK."""
    from chip_smoke import (
        ATTN_GRAD_BF16_TOL,
        ATTN_GRAD_F32_TOL,
        ATTN_GRAD_ULP_SHARE,
        bf16_ulp_share,
        rel_errors,
    )

    b, nh, s, hd = 2, 4, 256, 64
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, nh, s, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    bias = torch.from_numpy((rng.standard_normal((nh, s, s)) * 0.5).astype(
        np.float32))
    mask = torch.zeros((b, s))
    mask[1, 150:] = NEG
    scale = hd ** -0.5

    def to_bsh(t):
        return t.transpose(1, 2).reshape(b, s, nh * hd)

    if layout == "bsh":
        want = mpnet_attention_bwd_plain(*(to_bsh(t) for t in (q, k, v, do)),
                                         bias, mask, scale, nh)
        want = [t.reshape(b, s, nh, hd).transpose(1, 2) for t in want[:3]] + [
            want[3]]
    else:
        want = mpnet_attention_bwd_plain(q, k, v, do, bias, mask, scale)
    got = design_bwd(q, k, v, do, bias, mask, scale)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        errors = rel_errors(g, w)
        if name == "dbias":
            assert errors["max_rel_err"] <= ATTN_GRAD_F32_TOL, errors
            continue
        assert errors["max_rel_err"] <= ATTN_GRAD_BF16_TOL, (name, errors)
        assert bf16_ulp_share(g, w) <= ATTN_GRAD_ULP_SHARE, name
    rounded = design_bwd(q, k, v, do, bias, mask, scale, ds_split=False)
    for name, g, w in zip(("dq", "dk"), rounded, want):
        assert bf16_ulp_share(g, w) > ATTN_GRAD_ULP_SHARE, name
