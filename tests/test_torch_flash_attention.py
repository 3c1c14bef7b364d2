"""The port's stock-flash mode against the JAX package's, on the CPU.

- Op level: ``flash_attention`` (its plain version on the CPU) against
  ``jax.experimental.pallas.ops.tpu.flash_attention`` run under
  ``pltpu.force_tpu_interpret_mode()``, in f32, with a bias of trained
  scale (N(0, 4)) and padded tails.  Tolerance 1e-5 absolute: the same
  f32 formula, block by block, with sums in another order (read: under
  5e-7).
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


@pytest.mark.parametrize("s,hd", [(128, 32), (256, 26), (256, 32)])
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
