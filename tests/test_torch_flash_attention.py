"""The port's stock-flash mode against the JAX package's, on the CPU.

- Op level: ``flash_attention`` (its plain version on the CPU) against
  ``jax.experimental.pallas.ops.tpu.flash_attention`` run under
  ``pltpu.force_tpu_interpret_mode()``, in f32, with a bias of trained
  scale (N(0, 4)) and padded tails, at head sizes 26 to 256 (192 at S
  128, 256 at S 256: above 128 as the stock kernel takes them), and above
  256 (320 at S 128, 384 at S 256) at B 2 and one head in both dtypes;
  hd 320 at S 256 is refused by both.
  Tolerance 1e-5 absolute: the same f32 formula, block by block, with
  sums in another order (read: under 5e-7).  In bf16 at the head sizes
  above 128, the bf16 gate of ``test_torch_flash_attention_grad.py``:
  2^-9 of the largest |value|, at most 1e-3 of entries over one bf16 ulp.
- Model level: the port's ``forward_hidden(attention_impl="flash")``
  against JAX ``forward_hidden(..., attention_impl="flash")`` in interpret
  mode, on the MPNet arch with its relative bias scaled to trained size
  and on the BERT arch, f32, weights carried over by
  ``models/convert.py``.  Live and pad rows are both compared, within 1e-5
  absolute on the O(1) LayerNorm outputs (f32 sums in another order
  through two layers; read: under 1e-6).
- The flash mode is not the dense path on MPNet (the bias is added before
  the scale, and pad queries attend to the pad keys), but is on the live
  rows of BERT, whose bias is zero.
- S that is not a multiple of 128 is refused by both packages.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
)
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as jax_flash_attention,
)

from tpu_search.models import mpnet as jm
from tpu_search_torch.models.convert import model_from_params
from tpu_search_torch.models.mpnet import MPNetConfig, init_params
from tpu_search_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

OP_TOL = 1e-5
MODEL_TOL = 1e-5
BF16_TOL, BF16_SHARE = 2.0 ** -9, 1e-3


def op_inputs(s, hd, seed, b=2, nh=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nh, s, hd)).astype(np.float32)
               for _ in range(3))
    ab = (2.0 * rng.standard_normal((nh, s, s))).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[0, s - 37:] = 0  # a padded tail
    seg[1, 5:] = 0  # mostly padding
    return q, k, v, ab, seg


def jax_flash(q, k, v, ab, seg, scale):
    b, nh, s, _ = q.shape
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            ab=jnp.broadcast_to(jnp.asarray(ab), (b, nh, s, s)),
            segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
            sm_scale=scale,
        )
    return np.asarray(out)


@pytest.mark.parametrize("s,hd", [(128, 32), (256, 26), (256, 32), (128, 192),
                                  (256, 256)])
def test_op_matches_the_stock_kernel(s, hd):
    q, k, v, ab, seg = op_inputs(s, hd, seed=s + hd)
    scale = 1.0 / math.sqrt(hd)
    ref = jax_flash(q, k, v, ab, seg, scale)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v, ab, seg,
                                                          seg)), scale)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OP_TOL)

    # The formula: the bias before the scale, segments for the padding.
    live = seg[:, None, :, None] == seg[:, None, None, :]
    logits = (q @ k.transpose(0, 1, 3, 2) + ab[None]) * scale
    logits = np.where(live, logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OP_TOL)
    # ... which is not the dense path's bias after the scale.
    dense = q @ k.transpose(0, 1, 3, 2) * scale + ab[None]
    dense = np.where(live, dense, -np.inf)
    p = np.exp(dense - dense.max(-1, keepdims=True))
    assert np.abs((p / p.sum(-1, keepdims=True)) @ v - ref).max() > 0.1


@pytest.mark.parametrize("s,hd", [(128, 192), (256, 256)])
def test_op_matches_the_stock_kernel_in_bf16(s, hd):
    q, k, v, ab, seg = op_inputs(s, hd, seed=s + hd + 1)
    q, k, v, ab = (np.asarray(jnp.asarray(t, jnp.bfloat16).astype(
        jnp.float32)) for t in (q, k, v, ab))
    scale = 1.0 / math.sqrt(hd)
    b, nh = q.shape[:2]
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(
            *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
            ab=jnp.broadcast_to(jnp.asarray(ab, jnp.bfloat16),
                                (b, nh, s, s)),
            segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
            sm_scale=scale)
    ref = np.asarray(ref.astype(jnp.float32))
    got = flash_attention(*(torch.tensor(t, dtype=torch.bfloat16)
                            for t in (q, k, v, ab)),
                          torch.from_numpy(seg), torch.from_numpy(seg), scale)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref)
    assert err.max() <= BF16_TOL * np.abs(ref).max(), err.max()
    ulp = np.ldexp(1.0, np.frexp(ref)[1] - 8)
    assert (err > ulp).mean() <= BF16_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hd", [(128, 320), (256, 384)])
def test_op_matches_the_stock_kernel_above_256(s, hd, dtype):
    """Head sizes above 256, as the stock kernel takes them (any at S 128,
    multiples of 128 above), at B 2 and one head: f32 within ``OP_TOL``,
    bf16 within the bf16 gate."""
    q, k, v, ab, seg = op_inputs(s, hd, seed=s + hd + 2, nh=1)
    scale = 1.0 / math.sqrt(hd)
    if dtype == "float32":
        ref = jax_flash(q, k, v, ab, seg, scale)
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v, ab)),
                              torch.from_numpy(seg), torch.from_numpy(seg),
                              scale)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OP_TOL)
        return
    q, k, v, ab = (np.asarray(jnp.asarray(t, jnp.bfloat16).astype(
        jnp.float32)) for t in (q, k, v, ab))
    b, nh = q.shape[:2]
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(
            *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
            ab=jnp.broadcast_to(jnp.asarray(ab, jnp.bfloat16),
                                (b, nh, s, s)),
            segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
            sm_scale=scale)
    ref = np.asarray(ref.astype(jnp.float32))
    got = flash_attention(*(torch.tensor(t, dtype=torch.bfloat16)
                            for t in (q, k, v, ab)),
                          torch.from_numpy(seg), torch.from_numpy(seg), scale)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref)
    assert err.max() <= BF16_TOL * np.abs(ref).max(), err.max()
    ulp = np.ldexp(1.0, np.frexp(ref)[1] - 8)
    assert (err > ulp).mean() <= BF16_SHARE


def test_head_size_320_is_refused_by_both_at_s256():
    """``check_flash_shapes`` refuses hd 320 at S 256 as the stock kernel
    does (above 128, a multiple of 128 where S > 128)."""
    from tpu_search_torch.ops.flash_attention import check_flash_shapes

    q, k, v, ab, seg = op_inputs(256, 320, seed=9, nh=1)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        jax_flash(q, k, v, ab, seg, 0.1)
    tensors = [torch.from_numpy(x) for x in (q, k, v, ab, seg, seg)]
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        check_flash_shapes(*tensors)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        flash_attention(*tensors, 0.1)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, ab, seg = (torch.from_numpy(x) for x in op_inputs(256, 32, 1))
    assert torch.equal(flash_attention(q, k, v, ab, seg, seg, 0.25),
                       flash_attention_plain(q, k, v, ab, seg, seg, 0.25))
    meta = torch.zeros((1, 1, 128, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(meta, meta, meta, meta, meta, meta, 1.0)


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
    return ids, mask


def port_hidden(p, cfg, ids, mask, impl):
    model = model_from_params(p, cfg)
    with torch.no_grad():
        return model.forward_hidden(
            torch.from_numpy(ids).long(), torch.from_numpy(mask),
            attention_impl=impl).numpy()


def jax_hidden(p, cfg, ids, mask, impl):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jm.forward_hidden(
            p, jnp.asarray(ids), jnp.asarray(mask),
            jm.MPNetConfig(**dataclasses.asdict(cfg)),
            compute_dtype=jnp.float32, attention_impl=impl))


@pytest.mark.parametrize("arch", ["mpnet", "bert"])
def test_forward_hidden_matches_the_jax_flash_path(arch):
    cfg = config(arch)
    p = model_params(cfg, seed=3)
    ids, mask = model_batch(cfg, 128, seed=4)
    ref = jax_hidden(p, cfg, ids, mask, "flash")
    got = port_hidden(p, cfg, ids, mask, "flash")
    assert got.shape == ref.shape == (3, 128, 64)
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=MODEL_TOL)
    np.testing.assert_allclose(got[~live], ref[~live], rtol=0, atol=MODEL_TOL)

    dense = port_hidden(p, cfg, ids, mask, "dense")
    gap_live = np.abs(got[live] - dense[live]).max()
    gap_pad = np.abs(got[~live] - dense[~live]).max()
    # pad queries attend to the pad keys in the flash mode, to the live
    # keys in the dense path
    assert gap_pad > 0.01, gap_pad
    if arch == "mpnet":
        # (q.k + ab) * scale against q.k * scale + ab
        assert gap_live > 0.01, gap_live
    else:
        # a zero bias: the two orders agree on the live rows
        assert gap_live < MODEL_TOL, gap_live


@pytest.mark.parametrize("s", [64, 192])
def test_sequences_off_the_block_are_refused_by_both(s):
    cfg = config("mpnet")
    p = model_params(cfg, seed=5)
    ids, mask = model_batch(cfg, s, seed=6)
    with pytest.raises(ValueError, match="block_q|block_k_major"):
        jax_hidden(p, cfg, ids, mask, "flash")
    with pytest.raises(ValueError, match="block_q|block_k_major"):
        port_hidden(p, cfg, ids, mask, "flash")


def test_other_impls_are_refused():
    cfg = config("bert")
    ids, mask = model_batch(cfg, 128, seed=7)
    with pytest.raises(ValueError, match="attention_impl"):
        port_hidden(init_params(cfg, 0), cfg, ids, mask, "xla")


def test_card_branch_runs_the_kernels_with_and_without_grad(monkeypatch):
    """The card's branch with its C calls patched (``_on_card`` true,
    ``_fn`` recording each call): with grad enabled and q, k, v or ``ab``
    requiring it, one forward call that writes the residuals ``(m, l)``,
    then one backward call, which skips the bias's gradient (no ``dab``, no
    scratch) unless ``ab`` needs one; without grad or under ``no_grad``,
    one forward call without residuals and one count, as before; bf16 goes
    to ``flash_attention``, f32 to ``flash_attention_f32``; the backward
    asks its workspace's size first; head sizes of 160 and 320 run at S
    128 (the card has no head-size limit of its own), and 320 at S 256
    raises the stock kernel's ``NotImplementedError`` before any call."""
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops import flash_attention as fa

    calls = []

    def fn(name, source=None):
        def kernel(*args):
            calls.append((name, args))
            return 0
        return kernel

    monkeypatch.setattr(fa, "_fn", fn)
    monkeypatch.setattr(fa, "_on_card", lambda t: True)
    monkeypatch.setattr(fa._build, "stream_ptr", lambda device: 0)
    q, k, v, ab, seg = (torch.from_numpy(x) for x in op_inputs(128, 32, 3))
    for dtype, fwd in ((torch.bfloat16, "flash_attention"),
                       (torch.float32, "flash_attention_f32")):
        operands = [t.to(dtype) for t in (q, k, v, ab)]
        for i in range(4):
            args = list(operands)
            args[i] = args[i].clone().requires_grad_()
            before = dict(_build.LAUNCHES)
            out = fa.flash_attention(*args, seg, seg, 0.125)
            assert [name for name, _ in calls] == [fwd]
            assert all(p is not None for p in calls[0][1][7:9])  # m, l
            out.backward(torch.ones_like(out))
            assert [name for name, _ in calls] == [
                fwd, "flash_attention_bwd_workspace", "flash_attention_bwd"]
            size, bwd = calls[1][1], calls[2][1]
            assert bwd[21] == size[4] == int(dtype == torch.bfloat16)
            # dab and its partial sums only where ab needs a gradient
            assert (bwd[14] is None) == (size[5] == 0) == (i != 3)
            assert args[i].grad is not None
            assert _build.LAUNCHES[fwd] == before[fwd] + 1
            assert (_build.LAUNCHES["flash_attention_bwd"]
                    == before["flash_attention_bwd"] + 1)
            calls.clear()
            with torch.no_grad():
                out = fa.flash_attention(*args, seg, seg, 0.125)
            assert out.shape == q.shape and out.dtype == dtype
            assert [name for name, _ in calls] == [fwd]
            assert calls[0][1][7:9] == (None, None)
            calls.clear()
        before = _build.LAUNCHES[fwd]
        fa.flash_attention(*operands, seg, seg, 0.125)
        assert len(calls) == 1 and _build.LAUNCHES[fwd] == before + 1
        calls.clear()
    wide = torch.zeros((1, 2, 128, 160), dtype=torch.bfloat16)
    big = torch.zeros((1, 2, 128, 320), dtype=torch.bfloat16)
    big_ab = torch.zeros((2, 128, 128), dtype=torch.bfloat16)
    one = torch.ones((1, 128), dtype=torch.int32)
    fa.flash_attention(wide, wide, wide, big_ab, one, one, 0.1)
    fa.flash_attention(big, big, big, big_ab, one, one, 0.1)
    assert [name for name, _ in calls] == ["flash_attention"] * 2
    assert calls[1][1][12] == 320  # hd
    calls.clear()
    off = torch.zeros((1, 2, 256, 320), dtype=torch.bfloat16)
    off_ab = torch.zeros((2, 256, 256), dtype=torch.bfloat16)
    two = torch.ones((1, 256), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        fa.flash_attention(off, off, off, off_ab, two, two, 0.1)
    assert not calls
