"""Data- and tensor-parallel encode (``tpu_search_torch.parallel.encode``)
and the encoder's sharding rules (``mesh.encoder_param_specs``) against
the JAX package's, at ``tests/test_parallel.py``'s TINY width in f32, on
the same seeded numpy parameters and ids.

- dp over 8 data shards of one repeated CPU device against one device,
  at 1e-5 (JAX's own test's tolerance); against JAX ``make_sharded_encode``
  on its 8-device virtual mesh at 1e-5;
- tp on a 4 x 2 mesh (heads, the intermediate dim and the vocab split in
  two) against one device and against JAX's 4 x 2 tp encode, at 1e-4
  (JAX's tolerance: the partial products sum in another order);
- ``encoder_param_specs`` entry by entry: each port weight's spec is the
  JAX leaf's with the stacked-layer axis dropped and the weight axes
  swapped where the port keeps ``[out, in]`` (``models/convert.py``'s
  leaf map);
- the batch must divide by the data axis, with JAX's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.models.mpnet import MPNetConfig as JaxConfig
from tpu_search.models.mpnet import encode as jax_encode
from tpu_search.models.mpnet import init_params as jax_init_params
from tpu_search.parallel import build_mesh as jax_build_mesh
from tpu_search.parallel import encoder_param_specs as jax_specs
from tpu_search.parallel import make_sharded_encode as jax_sharded_encode
from tpu_search.parallel import shard_params as jax_shard_params
from tpu_search_torch.models.convert import _LAYER_LEAVES, model_from_params
from tpu_search_torch.models.mpnet import MPNetConfig
from tpu_search_torch.parallel import (
    build_mesh,
    data_sharding,
    encoder_param_specs,
    make_sharded_encode,
    replicated,
    shard_params,
)

JAX_TINY = JaxConfig(vocab_size=64, hidden_size=16, num_layers=2,
                     num_heads=2, intermediate_size=32, max_position=96)
TINY = MPNetConfig(**dataclasses.asdict(JAX_TINY))
CPU = torch.device("cpu")


def setup(seed: int, b: int, s: int):
    params = jax_init_params(JAX_TINY, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 4)
    ids = rng.integers(4, 64, size=(b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[1, s // 2:] = TINY.pad_token_id  # one padded row
    mask[1, s // 2:] = 0
    model = model_from_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), TINY)
    return params, model, ids, mask


def one_device(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask)).numpy()


def test_dp_matches_one_device_and_jax():
    params, model, ids, mask = setup(0, 16, 12)
    mesh = build_mesh(n_data=8, devices=[CPU] * 8)
    fn = make_sharded_encode(mesh, TINY, compute_dtype=torch.float32)
    sharded = shard_params(model, mesh)
    got = fn(sharded, ids, mask).numpy()
    assert got.shape == (16, 16)
    np.testing.assert_allclose(got, one_device(model, ids, mask), atol=1e-5)
    # one replica shared by the 8 shards of the repeated device
    placed = sharded.placement(torch.float32)
    assert len({id(p) for p in placed.values()}) == 1
    jmesh = jax_build_mesh(n_data=8)
    want = np.asarray(jax_sharded_encode(
        jmesh, JAX_TINY, compute_dtype=jnp.float32)(
            jax_shard_params(params, jmesh), jnp.asarray(ids),
            jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # a bare model is replicated on the fly
    np.testing.assert_array_equal(fn(model, ids, mask).numpy(), got)


def test_tp_matches_one_device_and_jax():
    params, model, ids, mask = setup(1, 8, 10)
    mesh = build_mesh(n_data=4, n_model=2, devices=[CPU] * 8)
    fn = make_sharded_encode(mesh, TINY, compute_dtype=torch.float32)
    got = fn(shard_params(model, mesh, tensor_parallel=True), ids,
             mask).numpy()
    np.testing.assert_allclose(got, one_device(model, ids, mask), atol=1e-4)
    jmesh = jax_build_mesh(n_data=4, n_model=2)
    want = np.asarray(jax_sharded_encode(
        jmesh, JAX_TINY, compute_dtype=jnp.float32)(
            jax_shard_params(params, jmesh, tensor_parallel=True),
            jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    ref = np.asarray(jax_encode(params, jnp.asarray(ids), jnp.asarray(mask),
                                JAX_TINY))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_tp_columns_hold_their_share():
    _, model, _, _ = setup(2, 8, 10)
    mesh = build_mesh(n_data=1, n_model=2, devices=[CPU] * 2)
    cols = shard_params(model, mesh, tensor_parallel=True).placement(
        torch.float32)[0]
    assert [c["heads"] for c in cols] == [1, 1]
    assert cols[1]["layers.0.q.weight"].shape == (8, 16)
    assert cols[1]["layers.0.o.weight"].shape == (16, 8)
    assert cols[1]["layers.0.ff_out.weight"].shape == (16, 16)
    assert cols[1]["word.weight"].shape == (32, 16)
    assert "layers.0.o.bias" not in cols[1]  # replicated: column 0 alone
    torch.testing.assert_close(cols[1]["layers.1.k.weight"],
                               model.layers[1].k.weight[8:])


def padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def logical(spec, ndim: int) -> tuple:
    """A spec with trailing Nones dropped (the same placement)."""
    spec = padded(spec, ndim)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_encoder_param_specs_match_jax_entry_by_entry():
    params = jax_init_params(JAX_TINY, jax.random.PRNGKey(0))
    want = jax_specs(params)
    model = model_from_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), TINY)
    got = encoder_param_specs(model)
    assert got.keys() == {n for n, _ in model.named_parameters()}
    for leaf, (name, transpose) in _LAYER_LEAVES.items():
        ndim = model.get_parameter(f"layers.0.{name}").ndim
        jspec = padded(tuple(want["layers"][leaf])[1:], ndim)  # drop [L]
        if transpose:
            jspec = jspec[::-1]
        for i in range(TINY.num_layers):
            assert logical(got[f"layers.{i}.{name}"], ndim) == logical(
                jspec, ndim), (leaf, got[f"layers.{i}.{name}"], jspec)
    emb = {"word": "word.weight", "position": "position.weight",
           "tt0": "tt0", "ln_scale": "ln_scale", "ln_bias": "ln_bias"}
    for leaf, name in emb.items():
        assert logical(got[name], 2) == logical(want["embeddings"][leaf], 2)
    assert logical(got["rel_bias"], 2) == logical(want["rel_bias"], 2)
    mesh = build_mesh(n_data=8, devices=[CPU] * 8)
    assert data_sharding(mesh).spec == ("data", None)
    assert data_sharding(mesh, 3).spec == ("data", None, None)
    assert replicated(mesh).spec == ()


def test_batch_must_divide_by_the_data_axis():
    params, model, ids, mask = setup(3, 12, 8)
    fn = make_sharded_encode(build_mesh(n_data=8, devices=[CPU] * 8), TINY,
                             compute_dtype=torch.float32)
    with pytest.raises(ValueError) as got:
        fn(model, ids, mask)
    jmesh = jax_build_mesh(n_data=8)
    with pytest.raises(ValueError) as want:
        jax_sharded_encode(jmesh, JAX_TINY, compute_dtype=jnp.float32)(
            jax_shard_params(params, jmesh), ids, mask)
    tail = ("should be divisible by 8, but it is equal to 12 (full shape: "
            "(12, 8))")
    assert tail in str(want.value) and tail in str(got.value)
