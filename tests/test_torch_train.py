"""The port's training step (``tpu_search_torch.parallel.train``) against
the JAX package's, on the same seeded numpy parameters and batches, at
``tests/test_parallel.py``'s TINY width in f32.

- ``infonce_loss``'s value and every parameter's gradient, ``rel_bias``
  included, against ``jax.value_and_grad(infonce_loss)``: each leaf
  within 1e-5 of its largest |JAX gradient| (f32 sums in another order;
  read about 1e-6), or of ``NOISE`` times the largest of any leaf where
  the leaf's own is rounding residue (k's bias, below).
- One and three AdamW steps against JAX ``make_train_step`` on a
  one-device mesh, lr 1e-3.  Adam's first step moves a parameter by
  lr * g / (|g| + 1e-8): about lr * sign(g) for any |g| well above eps, so
  a gradient that is rounding residue in both packages moves its
  parameter by an amount set by the residue alone.  k's bias is such a
  gradient (a constant added to every key of a row changes no softmax,
  so its exact gradient is 0; each package holds residue near 1e-11).
  An element whose JAX gradient, at any step, is below ``NOISE`` times
  the largest gradient of that step is held only to |difference| <= 2 lr
  a step; every other element within ``STEP_TOL`` * lr of the JAX
  parameters (read: at most 4e-3 lr after three steps, noise elements
  included).
- A JAX state after one step carried over by ``train_state_from_numpy``,
  then one more step in each package: the same parameters.
- Save, load and resume; the position-bias cache fresh after a step; S
  padded to 64 (the card's shape) changes no embedding beyond 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.models.mpnet import MPNetConfig as JaxConfig
from tpu_search.models.mpnet import init_params as jax_init_params
from tpu_search.parallel import build_mesh as jax_build_mesh
from tpu_search.parallel import init_train_state as jax_init_train_state
from tpu_search.parallel import make_train_step as jax_make_train_step
from tpu_search.parallel.train import infonce_loss as jax_infonce_loss
from tpu_search_torch.models.convert import model_from_params, params_to_numpy
from tpu_search_torch.models.mpnet import MPNetConfig
from tpu_search_torch.parallel import (
    build_mesh,
    infonce_loss,
    init_train_state,
    load_train_state,
    make_train_step,
    save_train_state,
    train_state_from_numpy,
)
from tpu_search_torch.parallel.encode import pad_sequences

JAX_TINY = JaxConfig(vocab_size=64, hidden_size=16, num_layers=2,
                     num_heads=2, intermediate_size=32, max_position=96)
TINY = MPNetConfig(**dataclasses.asdict(JAX_TINY))
LR = 1e-3
GRAD_TOL = 1e-5
NOISE = 1e-4
STEP_TOL = 1e-2
B, S = 8, 12


def batch(seed: int):
    rng = np.random.default_rng(seed)
    qids = rng.integers(4, 64, size=(B, S)).astype(np.int32)
    dids = rng.integers(4, 64, size=(B, S)).astype(np.int32)
    qmask, dmask = np.ones_like(qids), np.ones_like(dids)
    dids[3, 7:] = TINY.pad_token_id  # a padded document
    dmask[3, 7:] = 0
    return qids, qmask, dids, dmask


def tree(params) -> dict:
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def leaves(t) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(t)}


_value_and_grad = jax.jit(jax.value_and_grad(jax_infonce_loss),
                          static_argnums=(5, 6, 7))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX parameters, a one-device mesh and its jitted step, made
    once for every case."""
    params = jax_init_params(JAX_TINY, jax.random.PRNGKey(2))
    mesh = jax_build_mesh(n_data=1, devices=jax.devices()[:1])
    state, optimizer = jax_init_train_state(params, mesh, learning_rate=LR)
    step = jax_make_train_step(mesh, JAX_TINY, optimizer,
                               compute_dtype=jnp.float32)
    return params, state, step


def jax_grads(params, b):
    """``(loss, gradient leaves)`` of JAX's ``infonce_loss`` in f32."""
    loss, g = _value_and_grad(params, *(jnp.asarray(a) for a in b),
                              JAX_TINY, 0.05, jnp.float32)
    return float(loss), leaves(tree(g))


def cpu_mesh():
    return build_mesh(n_data=1, devices=[torch.device("cpu")])


def port_state(params):
    model = model_from_params(tree(params), TINY)
    return init_train_state(model, cpu_mesh(), learning_rate=LR)


def port_step(optimizer):
    return make_train_step(cpu_mesh(), TINY, optimizer,
                           compute_dtype=torch.float32)


def test_loss_and_every_gradient_match_jax(jax_side):
    params = jax_side[0]
    qids, qmask, dids, dmask = batch(0)
    loss, want = jax_grads(params, (qids, qmask, dids, dmask))
    model = model_from_params(tree(params), TINY)
    got = infonce_loss(model, qids, qmask, dids, dmask, TINY,
                       compute_dtype=torch.float32)
    assert abs(float(got) - loss) <= 1e-5 * abs(loss)
    got.backward()
    ours = leaves(params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, TINY))
    assert ours.keys() == want.keys()
    assert np.abs(want["['rel_bias']"]).max() > 1e-3  # it trains
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        scale = max(np.abs(w).max(), NOISE * top)
        err = np.abs(ours[key] - w).max()
        assert err <= GRAD_TOL * scale, (key, err, scale)


def check_params(model, jax_params, grads_seen, steps: int) -> None:
    """Parameters within ``STEP_TOL * lr`` of JAX's where every step's
    JAX gradient was above noise; within the update bound elsewhere."""
    ours = leaves(params_to_numpy(model))
    want = leaves(tree(jax_params))
    tops = [max(np.abs(v).max() for v in g.values()) for g in grads_seen]
    for key, w in want.items():
        noise = np.zeros(w.shape, bool)
        for g, top in zip(grads_seen, tops):
            noise |= np.abs(g[key]) < NOISE * top
        err = np.abs(ours[key] - w)
        assert err[~noise].max(initial=0) <= STEP_TOL * LR, (key,
                                                             err.max())
        assert err[noise].max(initial=0) <= 2 * steps * LR * 1.01, key


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_jax(jax_side, steps):
    params, jstate, jstep = jax_side
    state, optimizer = port_state(params)
    step = port_step(optimizer)
    seen = []
    for i in range(steps):
        b = batch(10 + i)
        seen.append(jax_grads(jstate.params, b)[1])
        jstate, jloss = jstep(jstate, *(jnp.asarray(a) for a in b))
        state, loss = step(state, *b)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert state.step == int(jstate.step) == steps
    check_params(state.params, jstate.params, seen, steps)
    # k's bias is the noise case: both packages' gradients are residue
    g = seen[0]["['layers']['k_b']"]
    assert np.abs(g).max() < 1e-6 * np.abs(seen[0]["['layers']['q_w']"]).max()


def test_jax_state_carried_over_continues_alike(jax_side):
    params, jstate, jstep = jax_side
    b0, b1 = batch(20), batch(21)
    jstate, _ = jstep(jstate, *(jnp.asarray(a) for a in b0))
    adam = jstate.opt_state[0]
    state, optimizer = train_state_from_numpy(
        tree(jstate.params), tree(adam.mu), tree(adam.nu), int(adam.count),
        int(jstate.step), TINY, cpu_mesh(), learning_rate=LR)
    assert state.step == 1
    np.testing.assert_array_equal(
        leaves(params_to_numpy(state.params))["['rel_bias']"],
        np.asarray(jstate.params["rel_bias"]))
    seen = [jax_grads(jstate.params, b1)[1]]
    jstate, _ = jstep(jstate, *(jnp.asarray(a) for a in b1))
    state, _ = port_step(optimizer)(state, *b1)
    assert state.step == int(jstate.step) == 2
    check_params(state.params, jstate.params, seen, 1)


def test_save_load_resume(jax_side, tmp_path):
    params = jax_side[0]
    state, optimizer = port_state(params)
    step = port_step(optimizer)
    state, _ = step(state, *batch(30))
    path = tmp_path / "ckpt"
    save_train_state(state, str(path))
    saved = leaves(params_to_numpy(state.params))  # steps update in place
    assert (path / "model.tpu.npz").exists()
    fresh, fresh_opt = port_state(params)
    restored = load_train_state(str(path), fresh_opt, fresh)
    assert restored.step == 1
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              restored.params.named_parameters()):
        assert torch.equal(a, b), n
    # resuming gives the step the original takes
    a_state, a_loss = step(state, *batch(31))
    b_state, b_loss = port_step(fresh_opt)(restored, *batch(31))
    assert a_state.step == b_state.step == 2
    assert torch.equal(a_loss, b_loss)
    for (n, a), (_, b) in zip(a_state.params.named_parameters(),
                              b_state.params.named_parameters()):
        assert torch.equal(a, b), n
    # the fine-tuned parameters load in the JAX package too
    from tpu_search.models.convert import load_checkpoint as jax_load

    loaded, config = jax_load(str(path / "model.tpu.npz"))
    assert config == JAX_TINY
    np.testing.assert_array_equal(np.asarray(loaded["layers"]["q_w"]),
                                  saved["['layers']['q_w']"])


def test_position_bias_cache_is_fresh_after_a_step(jax_side):
    state, optimizer = port_state(jax_side[0])
    model = state.params
    with torch.no_grad():
        before = model.position_bias(S).clone()
        assert model.position_bias(S) is model.position_bias(S)
    state, _ = port_step(optimizer)(state, *batch(40))
    with torch.no_grad():
        after = model.position_bias(S)
        want = model.rel_bias.float()[model.buckets(S, "cpu")].permute(
            2, 0, 1)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


def test_padding_to_64_changes_no_embedding(jax_side):
    model = model_from_params(tree(jax_side[0]), TINY)
    qids, qmask, dids, dmask = batch(50)
    ids, mask = torch.from_numpy(dids).long(), torch.from_numpy(dmask)
    pids, pmask = pad_sequences(ids, mask, TINY.pad_token_id)
    assert pids.shape == (B, 64) and not pmask[:, S:].any()
    with torch.no_grad():
        a, b = model(ids, mask), model(pids, pmask)
    assert float((a - b).abs().max()) <= 1e-6
