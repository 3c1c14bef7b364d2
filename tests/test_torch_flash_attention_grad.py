"""The gradient of the port's stock-flash mode against ``jax.grad`` of the
JAX package's, on the CPU.

The JAX side runs ``jax.experimental.pallas.ops.tpu.flash_attention`` (a
``jax.custom_vjp`` whose backward is the ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` Pallas kernels) under
``pltpu.force_tpu_interpret_mode()``; the port's CPU path is
``FlashAttention`` with the plain forward and the plain backward
(``flash_attention_bwd_plain``).  Inputs come from a numpy seed; bf16
cases hand both sides the same bf16 values.

- Op level: f32 and bf16, S 128 (the one-step forward) and 256, head
  sizes 26 and 32, three batch rows (one whole, one with a padded tail, one
  mostly padding), a bias of trained scale (N(0, 4)).  dQ, dK and dV, and
  the bias's gradient: JAX's ``[B, heads, S, S]`` dS in ab's dtype summed
  over the batch in f32 and rounded once, the port's contract.  (JAX's own
  broadcast transpose of one ``[heads, S, S]`` bf16 bias, summed over the
  batch by XLA on the CPU, reads 2.4e-3 to 3.9e-3 of the largest |value|
  from it, one bf16 ulp; in f32, 0.)  The forward's ``(m, l)`` against
  JAX's ``save_residuals`` outputs.  Tolerances, each max |error| over the
  largest |reference| of its output: f32 ``F32_TOL`` (the same f32
  formula, sums in another order; read: at most 3.9e-7); bf16
  ``BF16_TOL`` and at most ``BF16_SHARE`` of entries more than one bf16
  ulp off (read: at most 7.2e-4 and 4.7e-4: an f32 value rounded to bf16
  that lands an ulp apart); ``(m, l)`` are f32 in both dtypes:
  ``F32_TOL`` (read: m exact in f32, at most 2.7e-7).
- Model level: ``forward_hidden(attention_impl="flash")`` of the MPNet
  (its relative bias at trained scale) and BERT archs, 2 layers, H 64, S
  256, weights carried over by ``models/convert.py``, the layers cast to
  the compute dtype, the loss the sum of the hidden state times fixed
  weights (pad rows included).  Every parameter's gradient, mapped back by
  ``params_to_numpy``: f32 within ``MODEL_F32_TOL`` of its largest |value|
  (read: at most 5.1e-6); bf16 at cosine ``MODEL_BF16_COS`` or more (read:
  at least 0.99943, on BERT's ``v_b``; the dense mode's gradients read
  0.99984 there, the rest of the encoder's bf16 roundings).  A key
  projection's bias gets a gradient of zero in exact arithmetic (softmax is
  shift-invariant along a row), so both sides hold rounding residue there:
  ``k_b`` is held against ``q_b``'s scale instead, within
  ``MODEL_F32_TOL`` of it in f32 (read: 4.1e-6) and ``K_B_BF16_TOL`` in
  bf16 (read: 1.7e-2; dS rounds to bf16 before its row sums).
- Head sizes above 128, as the stock kernel takes them (the card's
  kernels take every one): the op level also at hd 192, S 128 and hd 256,
  S 256, in both dtypes; hd 160 in f32 against JAX at S 128; hd 384 at S
  256 in f32 (B 2, one head); at S 256 both packages refuse 160
  (``NotImplementedError``: the stock kernel's tiling).
- The bias's gradient in the card kernel's order
  (``grouped_batch_sum``: groups of batch rows, each summed in order, then
  the groups) from JAX's per-row bf16 dS, against JAX's dab (those rows
  summed in f32 and rounded once, as above) within the card's gate
  (``PERF.md`` §2: 2^-7 of the largest |value|, at most 1e-3 of entries
  over one bf16 ulp), and within 2^-7 of JAX's own gradient of one
  ``[heads, S, S]`` bias shared by the batch (XLA's transpose of the
  broadcast, summed in bf16: one ulp off on 1.5 % of entries, so not the
  share).  In f32 the same groups (``bias_group_rows``), the rows' f32 dS
  summed in that order within ``F32_TOL`` of JAX's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from tpu_search.models import mpnet as jm
from tpu_search_torch.models.convert import model_from_params, params_to_numpy
from tpu_search_torch.models.mpnet import MPNetConfig, init_params
from tpu_search_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd_plain,
    grouped_batch_sum,
)

B, NH = 3, 2
F32_TOL = 2e-6
BF16_TOL = 2.0 ** -9
BF16_SHARE = 1e-3
MODEL_F32_TOL = 1e-5
MODEL_BF16_COS = 0.999
K_B_BF16_TOL = 2.0 ** -5
GATE_TOL, GATE_SHARE = 2.0 ** -7, 1e-3  # the card's bf16 gradient gate

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def op_inputs(s, hd, seed, dtype, b=B, nh=NH):
    """q, k, v, dO ``[b, heads, S, hd]``, ab ``[heads, S, S]`` and segment
    ids, as f32 numpy holding values of ``dtype``."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, nh, s, hd)).astype(np.float32)
                   for _ in range(4))
    ab = (2.0 * rng.standard_normal((nh, s, s))).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[1, s - 37:] = 0  # a padded tail
    if b > 2:
        seg[2, 5:] = 0  # mostly padding
    jd = DTYPES[dtype][0]
    q, k, v, do, ab = (np.asarray(jnp.asarray(t, jd).astype(jnp.float32))
                       for t in (q, k, v, do, ab))
    return q, k, v, do, ab, seg


def jax_side(q, k, v, do, ab, seg, dtype):
    """JAX's ``(out, dq, dk, dv, ds, m, l)``: ``ds`` the ``[B, heads, S,
    S]`` gradient of the per-row bias, ``m`` and ``l`` the residuals."""
    jd = DTYPES[dtype][0]
    b, nh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    ids = jfa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    args = [jnp.asarray(t, jd) for t in (q, k, v)]
    abb = jnp.broadcast_to(jnp.asarray(ab, jd), (b, nh, s, s))
    with pltpu.force_tpu_interpret_mode():
        out, pull = jax.vjp(
            lambda q, k, v, ab: jfa.flash_attention(
                q, k, v, ab=ab, segment_ids=ids, sm_scale=scale),
            *args, abb)
        grads = pull(jnp.asarray(do, jd))
        _, l, m = jfa._flash_attention_impl(
            *args, abb, ids, True, False, scale, 1, jfa.MIN_BLOCK_SIZE,
            jfa.MIN_BLOCK_SIZE, jfa.MIN_BLOCK_SIZE, False)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads, m, l)]


def port_side(q, k, v, do, ab, seg, dtype):
    td = DTYPES[dtype][1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    leaves = [torch.tensor(t, dtype=td).requires_grad_()
              for t in (q, k, v, ab)]
    segs = torch.from_numpy(seg)
    out = flash_attention(*leaves, segs, segs, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.tensor(do, dtype=td))
    _, m, l = flash_attention_fwd_plain(*(t.detach() for t in leaves), segs,
                                        segs, scale)
    return [t.detach().float().numpy()
            for t in (out, *(x.grad for x in leaves), m, l)]


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def over_ulp_share(got, want) -> float:
    ulp = np.ldexp(1.0, np.frexp(want)[1] - 8)
    return float((np.abs(got - want) > ulp).mean())


def check(got, want, dtype, what) -> None:
    err = rel_err(got, want)
    if dtype == "float32":
        assert err <= F32_TOL, (what, err)
    else:
        share = over_ulp_share(got, want)
        assert err <= BF16_TOL and share <= BF16_SHARE, (what, err, share)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hd", [(128, 32), (128, 26), (256, 32), (256, 26),
                                  (128, 192), (256, 256)])
def test_op_gradient_matches_jax(s, hd, dtype):
    inputs = op_inputs(s, hd, seed=s + hd, dtype=dtype)
    want = jax_side(*inputs, dtype)
    got = port_side(*inputs, dtype)
    names = ("out", "dq", "dk", "dv", "dab", "m", "l")
    jd = DTYPES[dtype][0]
    # the port's bias gradient: each row's dS in ab's dtype, summed in f32
    want[4] = np.asarray(jnp.asarray(want[4].sum(axis=0), jd).astype(
        jnp.float32))
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        if name in ("m", "l"):
            assert rel_err(g, w) <= F32_TOL, (name, rel_err(g, w))
        else:
            check(g, w, dtype, name)


def test_op_gradient_matches_jax_above_256():
    """hd 384 at S 256 (above 256, a multiple of 128 as the stock kernel
    takes it), f32, B 2 and one head."""
    inputs = op_inputs(256, 384, seed=384, dtype="float32", b=2, nh=1)
    want = jax_side(*inputs, "float32")
    got = port_side(*inputs, "float32")
    want[4] = want[4].sum(axis=0)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dab", "m", "l"), got,
                          want):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        assert rel_err(g, w) <= F32_TOL, (name, rel_err(g, w))


@pytest.mark.parametrize("group", [16, 2])
def test_grouped_bias_sum_matches_jax(group):
    """Each batch row's bf16 dS from JAX's VJP, summed in the card's
    order (one group at B 3 as the kernel runs it; groups of 2 rows to
    walk more than one), against JAX's gradient of a shared bias."""
    q, k, v, do, ab, seg = op_inputs(128, 32, seed=33, dtype="bfloat16")
    rows = jax_side(q, k, v, do, ab, seg, "bfloat16")[4]
    got = grouped_batch_sum(torch.tensor(rows), group).to(
        torch.bfloat16).float().numpy()
    summed = np.asarray(jnp.asarray(rows.sum(axis=0), jnp.bfloat16).astype(
        jnp.float32))
    assert rel_err(got, summed) <= GATE_TOL, rel_err(got, summed)
    assert over_ulp_share(got, summed) <= GATE_SHARE
    scale = 1.0 / math.sqrt(q.shape[-1])
    ids = jfa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    args = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        _, pull = jax.vjp(
            lambda shared: jfa.flash_attention(
                *args, ab=jnp.broadcast_to(shared, (B, NH) + ab.shape[1:]),
                segment_ids=ids, sm_scale=scale),
            jnp.asarray(ab, jnp.bfloat16))
        (want,) = pull(jnp.asarray(do, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    assert rel_err(got, want) <= GATE_TOL, rel_err(got, want)


@pytest.mark.parametrize("group", [3, 2, 1])
def test_grouped_bias_sum_matches_jax_in_f32(group):
    """The f32 bias gradient takes the bf16 groups (``bias_group_rows``:
    B / 16 groups from B 32 on, in either dtype): each batch row's f32 dS
    from JAX's VJP summed in that order within ``F32_TOL`` of the rows
    summed at once and of JAX's gradient of one shared f32 bias; the
    port's plain backward gives the same sum as ``grouped_batch_sum`` with
    its groups."""
    from tpu_search_torch.ops.flash_attention import (
        bias_group_rows,
        flash_attention_bwd_plain,
    )

    assert [bias_group_rows(b) for b in (3, 31, 32, 40, 128)] == [
        3, 31, 16, 20, 16]
    q, k, v, do, ab, seg = op_inputs(128, 32, seed=34, dtype="float32")
    rows = jax_side(q, k, v, do, ab, seg, "float32")[4]
    got = grouped_batch_sum(torch.tensor(rows), group).numpy()
    assert rel_err(got, rows.sum(axis=0)) <= F32_TOL
    scale = 1.0 / math.sqrt(q.shape[-1])
    ids = jfa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    args = [jnp.asarray(t) for t in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        _, pull = jax.vjp(
            lambda shared: jfa.flash_attention(
                *args, ab=jnp.broadcast_to(shared, (B, NH) + ab.shape[1:]),
                segment_ids=ids, sm_scale=scale),
            jnp.asarray(ab))
        (want,) = pull(jnp.asarray(do))
    assert rel_err(got, np.asarray(want)) <= F32_TOL
    t = [torch.tensor(x) for x in (q, k, v, ab)]
    segs = torch.from_numpy(seg)
    out, m, l = flash_attention_fwd_plain(*t, segs, segs, scale)
    dab = flash_attention_bwd_plain(*t, segs, segs, out, torch.tensor(do),
                                    m, l, scale)[3]
    assert rel_err(dab.numpy(), rows.sum(axis=0)) <= F32_TOL


def test_segments_get_no_gradient_and_ab_none_skips_its_gradient():
    """Only q needing a gradient: the backward runs without the bias's,
    and q's gradient is the same as with every input needing one."""
    q, k, v, do, ab, seg = (torch.tensor(t)
                            for t in op_inputs(128, 32, 9, "float32"))
    leaf = q.clone().requires_grad_()
    flash_attention(leaf, k, v, ab, seg, seg, 0.125).backward(do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, ab)]
    flash_attention(*leaves, seg, seg, 0.125).backward(do)
    assert torch.equal(leaf.grad, leaves[0].grad)
    assert not seg.requires_grad


def config(arch):
    return MPNetConfig(vocab_size=100, hidden_size=64, num_layers=2,
                       num_heads=2, intermediate_size=128, max_position=520,
                       arch=arch, pad_token_id=0 if arch == "bert" else 1)


def model_params(cfg, seed):
    p = init_params(cfg, seed)
    if cfg.arch == "mpnet":
        # a trained model's relative bias is O(1), not the 0.02 init
        rng = np.random.default_rng(seed + 50)
        p["rel_bias"] = (2.0 * rng.standard_normal(p["rel_bias"].shape)
                         ).astype(np.float32)
    return p


def model_batch(cfg, s, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, size=(3, s)).astype(np.int32)
    mask = np.ones((3, s), np.int32)
    for row, length in ((1, s - 45), (2, 7)):
        ids[row, length:] = cfg.pad_token_id
        mask[row, length:] = 0
    weights = rng.standard_normal((3, s, cfg.hidden_size)).astype(np.float32)
    return ids, mask, weights


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_model_grads(p, cfg, ids, mask, weights, dtype):
    jd = DTYPES[dtype][0]
    jcfg = jm.MPNetConfig(**dataclasses.asdict(cfg))

    def loss(params):
        hidden = jm.forward_hidden(params, jnp.asarray(ids),
                                   jnp.asarray(mask), jcfg, compute_dtype=jd,
                                   attention_impl="flash")
        return jnp.sum(hidden.astype(jnp.float32) * jnp.asarray(weights))

    params = jax.tree.map(jnp.asarray, p)
    with pltpu.force_tpu_interpret_mode():
        return leaves(jax.grad(loss)(params))


def port_model_grads(p, cfg, ids, mask, weights, dtype):
    model = model_from_params(p, cfg)
    model.layers.to(DTYPES[dtype][1])  # the compute dtype, as JAX casts
    hidden = model.forward_hidden(torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask),
                                  attention_impl="flash")
    (hidden.float() * torch.from_numpy(weights)).sum().backward()
    grads = {n: t.grad.float() for n, t in model.named_parameters()
             if t.grad is not None}
    missing = {n for n, _ in model.named_parameters()} - set(grads)
    for name in missing:  # no path to the loss (BERT's unused tables)
        grads[name] = torch.zeros_like(dict(model.named_parameters())[name],
                                       dtype=torch.float32)
    return leaves(params_to_numpy(grads, cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mpnet", "bert"])
def test_model_gradients_match_jax(arch, dtype):
    cfg = config(arch)
    p = model_params(cfg, seed=11)
    ids, mask, weights = model_batch(cfg, 256, seed=12)
    want = jax_model_grads(p, cfg, ids, mask, weights, dtype)
    got = port_model_grads(p, cfg, ids, mask, weights, dtype)
    assert got.keys() == want.keys()
    if arch == "mpnet":
        assert np.abs(want["['rel_bias']"]).max() > 1e-2  # it trains
    q_scale = np.abs(want["['layers']['q_b']"]).max()
    for key, w in want.items():
        g = got[key]
        assert np.isfinite(g).all(), key
        if key == "['layers']['k_b']":
            tol = MODEL_F32_TOL if dtype == "float32" else K_B_BF16_TOL
            err = np.abs(g - w).max()
            assert err <= tol * q_scale, (key, err, q_scale)
            continue
        if not np.abs(w).max():
            assert not np.abs(g).max(), key
            continue
        if dtype == "float32":
            assert rel_err(g, w) <= MODEL_F32_TOL, (key, rel_err(g, w))
        else:
            cos = float((g * w).sum()
                        / (np.linalg.norm(g) * np.linalg.norm(w)))
            assert cos >= MODEL_BF16_COS, (key, cos)


def test_head_size_160_matches_jax_at_s128():
    inputs = op_inputs(128, 160, seed=160, dtype="float32")
    want = jax_side(*inputs, "float32")
    got = port_side(*inputs, "float32")
    want[4] = want[4].sum(axis=0)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dab", "m", "l"), got,
                          want):
        assert rel_err(g, w) <= F32_TOL, (name, rel_err(g, w))


def test_head_size_160_is_refused_by_both_at_s256():
    q, k, v, _, ab, seg = op_inputs(256, 160, seed=161, dtype="float32")
    ids = jfa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        with pltpu.force_tpu_interpret_mode():
            jfa.flash_attention(
                *(jnp.asarray(t) for t in (q, k, v)),
                ab=jnp.broadcast_to(jnp.asarray(ab), (B, NH, 256, 256)),
                segment_ids=ids, sm_scale=0.1)
    segs = torch.from_numpy(seg)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        flash_attention(*(torch.tensor(t) for t in (q, k, v, ab)), segs,
                        segs, 0.1)
