"""The port's ``[B, heads, S, hd]`` attention (plain version) against the
JAX package's Pallas kernel ``mpnet_flash_attention`` in interpret mode,
for head sizes 8, 26 and 32 at S 64, with padded rows and a fully padded
row; and the table that sends an encoder shape to the ``[B, S, H]`` or the
``[B, heads, S, hd]`` kernel.

Tolerance: f32 inputs within 1e-5 (same math, sums in another order);
bf16 inputs within 1e-2 absolute + 1e-2 relative, about one bf16 ulp of
the O(1) outputs (both round the probabilities and the output to bf16 at
the same sites).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.ops.pallas_mpnet_attention import mpnet_flash_attention
from tpu_search_torch.models.mpnet import MPNetConfig, MPNetModel
from tpu_search_torch.ops.mpnet_attention import (
    attention_layout,
    mpnet_attention_bhsd,
    mpnet_attention_bhsd_plain,
)

NEG = float(np.finfo(np.float32).min)


def inputs(seed, b, nh, s, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, nh, s, hd)).astype(np.float32)
               for _ in range(3))
    bias = (0.5 * rng.standard_normal((nh, s, s))).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    live = np.arange(s)[None, :] < lengths[:, None]
    mask = np.where(live, 0.0, NEG).astype(np.float32)
    mask[1] = NEG  # a fully padded row: the no-NaN guard
    return q, k, v, bias, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,hd", [(4, 8), (3, 26), (2, 32)])
def test_plain_matches_pallas(dtype, nh, hd):
    b, s = 3, 64
    q, k, v, bias, mask = inputs(hd, b, nh, s, hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    scale = 1.0 / np.sqrt(hd)
    ref = mpnet_flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        jnp.asarray(bias), jnp.asarray(mask), scale=scale, interpret=True,
    )
    got = mpnet_attention_bhsd(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(mask), scale,
    )
    assert got.dtype == tdt and got.shape == (b, nh, s, hd)
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(got).all()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_fully_padded_row_gets_uniform_weights():
    b, nh, s, hd = 2, 3, 64, 26
    q, k, v, bias, mask = inputs(5, b, nh, s, hd)
    bias[:] = 0.0
    got = mpnet_attention_bhsd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, bias, mask)), 0.2)
    mean_v = v[1].mean(axis=1, keepdims=True)  # [nh, 1, hd]
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(mean_v, (nh, s, hd)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden,heads,layout", [
    (768, 12, "bsh"),   # all-mpnet-base-v2
    (384, 12, "bsh"),   # all-MiniLM-L6-v2, ms-marco-MiniLM-L-6-v2
    (128, 2, "bsh"),    # hd 64 at H 128
    (64, 2, "bhsd"),    # the tiny-overlap reranker: H not a multiple of 128
    (312, 12, "bhsd"),  # TinyBERT-L-4: hd 26 does not divide 128
    (32, 4, "bhsd"),    # hd 8, the JAX test's shape
])
def test_attention_layout(hidden, heads, layout):
    assert attention_layout(hidden, heads) == layout
    config = MPNetConfig(vocab_size=16, hidden_size=hidden, num_heads=heads,
                         num_layers=1, intermediate_size=64, max_position=70)
    assert MPNetModel(config).layers[0].layout == layout


def test_wrapper_refuses_non_cpu_non_cuda():
    t = torch.zeros((1, 2, 64, 26), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mpnet_attention_bhsd(t, t, t, torch.zeros((2, 64, 64), device="meta"),
                             torch.zeros((1, 64), device="meta"))
