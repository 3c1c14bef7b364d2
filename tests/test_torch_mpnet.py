"""The port's MPNet encoder against the JAX package's ``encode`` on the
CPU, with the same numpy-made weights reaching both (the port's through
``params_from_numpy``).

Tolerances (embedding cosine, per row):
- f32 compute, erf gelu: > 0.99999 (same math, sums in another order);
- bf16 compute, tanh gelu: > 0.999, with and without the int8 FFN: bf16
  rounds at slightly different places in the two frameworks (the bias
  adds of the projections, the matmul output rounding).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.models import convert as jax_convert
from tpu_search.models import mpnet as jm
from tpu_search_torch.models.convert import (
    load_checkpoint,
    model_from_params,
    params_from_numpy,
    save_checkpoint,
)
from tpu_search_torch.models.mpnet import (
    MPNetConfig,
    MPNetModel,
    init_params,
    relative_position_bucket,
)


def tiny(num_heads):
    return MPNetConfig(
        vocab_size=100, hidden_size=128, num_layers=2, num_heads=num_heads,
        intermediate_size=256, max_position=520,
    )


def batch(seed, b=4, s=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 100, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, length in ((1, 40), (2, 5)):
        ids[row, length:] = 1
        mask[row, length:] = 0
    return ids, mask


def params(config, seed=0):
    p = init_params(config, seed)
    rng = np.random.default_rng(seed + 100)
    # non-trivial LayerNorm and bias parameters, so every leaf matters
    for key in ("ln_scale", "ln_bias"):
        p["embeddings"][key] = p["embeddings"][key] + (
            0.1 * rng.standard_normal(p["embeddings"][key].shape)
        ).astype(np.float32)
    for key, leaf in p["layers"].items():
        if key.endswith("_b") or "ln" in key:
            p["layers"][key] = leaf + (
                0.05 * rng.standard_normal(leaf.shape)
            ).astype(np.float32)
    return p


@pytest.mark.parametrize("num_heads", [2, 4])
@pytest.mark.parametrize(
    "dtype,int8,min_cos",
    [("float32", False, 0.99999), ("bfloat16", False, 0.999),
     ("bfloat16", True, 0.999)],
)
def test_encode_matches_jax(num_heads, dtype, int8, min_cos):
    config = tiny(num_heads)
    p = params(config)
    ids, mask = batch(1)
    jcfg = jm.MPNetConfig(**dataclasses.asdict(config))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jm.encode(
        {k: v for k, v in p.items()}, jnp.asarray(ids), jnp.asarray(mask),
        jcfg, compute_dtype=jdt, int8_ffn=int8,
    ))
    model = model_from_params(p, config)
    model.layers.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    if int8:
        model.quantize_ffn()
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    int8_ffn=int8).numpy()
    assert got.shape == ref.shape == (4, 128)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = (got * ref).sum(axis=1)
    assert cos.min() > min_cos, cos


@pytest.mark.parametrize("seq", [64, 128, 256, 384, 512])
def test_relative_position_buckets_equal_jax(seq):
    pos = np.arange(seq, dtype=np.int32)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jm._relative_position_bucket(jnp.asarray(rel), 32, 128))
    got = relative_position_bucket(torch.from_numpy(rel), 32, 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_from_numpy_layout():
    config = tiny(2)
    p = params(config)
    state = params_from_numpy(p, config)
    np.testing.assert_array_equal(state["layers.1.ff_in.weight"].numpy(),
                                  p["layers"]["ff_in_w"][1].T)
    np.testing.assert_array_equal(state["layers.0.q.bias"].numpy(),
                                  p["layers"]["q_b"][0])
    np.testing.assert_array_equal(state["rel_bias"].numpy(), p["rel_bias"])
    assert set(state) == set(MPNetModel(config).state_dict())


def test_checkpoint_format_shared_with_jax(tmp_path):
    config = tiny(4)
    p = params(config, seed=3)
    save_checkpoint(str(tmp_path / "port.npz"), p, config)
    jp, jcfg = jax_convert.load_checkpoint(str(tmp_path / "port.npz"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(config)
    np.testing.assert_array_equal(jp["layers"]["v_w"], p["layers"]["v_w"])

    jax_convert.save_checkpoint(str(tmp_path / "jax.npz"), jp, jcfg)
    tp, tcfg = load_checkpoint(str(tmp_path / "jax.npz"))
    assert tcfg == config
    np.testing.assert_array_equal(tp["embeddings"]["word"],
                                  p["embeddings"]["word"])


def test_other_archs_raise():
    """The three families are built; any other arch or pooling raises."""
    for arch in ("mpnet", "bert", "xlmr"):
        MPNetModel(dataclasses.replace(tiny(2), arch=arch))
    with pytest.raises(ValueError, match="arch"):
        MPNetModel(dataclasses.replace(tiny(2), arch="t5"))
    with pytest.raises(ValueError, match="pooling"):
        MPNetModel(dataclasses.replace(tiny(2), pooling="weighted"))
