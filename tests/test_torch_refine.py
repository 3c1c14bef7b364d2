"""The port's refine tier against ``tpu_search.index.refine`` on the CPU.

Tolerances: int8 refine rows and scales, and bf16 rows, bit-identical
(the same quantizer); ``gather`` equal; ``refine_rescore`` ids equal and
scores within 1e-6 (the f32 dot products sum in another order);
``topk_all`` (the port's flat scans) scores and ids equal for int8 (the
plain int8 scan is bit-identical to the jitted XLA one), ids equal and
scores within 1e-6 for bf16; the
TPUSIDX2 sections read back by either store.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.index.refine import RefineStore as JaxRefine
from tpu_search.index.refine import refine_rescore as jax_rescore
from tpu_search.index.serialize import read_file as jax_read
from tpu_search.index.serialize import write_file as jax_write
from tpu_search_torch.index.refine import RefineStore, refine_rescore
from tpu_search_torch.index.serialize import read_file, write_file

T = torch.from_numpy


def rows(seed, n, d=48):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def bits(x):
    """bf16 arrays as their 16-bit patterns."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def stores(dtype, n=300):
    j = JaxRefine(48, dtype=dtype)
    t = RefineStore(48, dtype=dtype, device="cpu")
    a, b = rows(0, n - 100), rows(1, 100)
    for store in (j, t):
        store.append(a if store is t else jnp.asarray(a), a.shape[0])
        store.append(b if store is t else jnp.asarray(b), b.shape[0])
    return j, t


def torch_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if (
        t.dtype == torch.bfloat16) else t.numpy()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_rows_bit_identical_and_gather(dtype):
    j, t = stores(dtype)
    assert (t.count, t.capacity) == (j.count, j.capacity) == (300, 4096)
    np.testing.assert_array_equal(torch_bits(t.rows[:300]),
                                  bits(np.asarray(j.rows)[:300]))
    if dtype == "int8":
        np.testing.assert_array_equal(t.scales[:300].numpy(),
                                      np.asarray(j.scales)[:300])
    ids = np.asarray([0, 7, 299, 150])
    np.testing.assert_array_equal(t.gather(ids).numpy(),
                                  np.asarray(j.gather(ids)))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_rescore_matches(dtype):
    j, t = stores(dtype)
    q = rows(2, 4)
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 300, (4, 40)).astype(np.int32)
    cand[:, 30:] = -1  # fewer candidates than slots
    cand[1, 5] = cand[1, 4]  # a duplicate candidate: an exact tie
    for k in (10, 40):
        ws, wi = jax_rescore(j.rows, j.scales, jnp.asarray(q),
                             jnp.asarray(cand), k)
        gs, gi = refine_rescore(t.rows, t.scales, T(q), T(cand), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_topk_all_matches(dtype):
    j, t = stores(dtype)
    q = rows(4, 5)
    live = np.random.default_rng(5).random(300) > 0.3
    ws, wi = j.topk_all(q, live, 10)
    gs, gi = t.topk_all(q, live, 10)
    np.testing.assert_array_equal(gi, wi)
    if dtype == "int8":
        np.testing.assert_array_equal(gs, ws)
    else:
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_topk_all_scans_only_the_written_slots(dtype, monkeypatch):
    """``topk_all`` scans ``round_up(count, 128)`` rows (at least k), not
    the capacity, and returns what the JAX store's scan over the whole
    capacity returns, before and after an add and a compact."""
    import tpu_search_torch.index.refine as refine

    name = "flat_topk_int8_scan" if dtype == "int8" else "flat_topk_scan"
    scan, seen = getattr(refine, name), []

    def spy(corpus, *args):
        seen.append(corpus.shape[0])
        return scan(corpus, *args)

    monkeypatch.setattr(refine, name, spy)
    j, t = stores(dtype)
    q = rows(6, 3)
    rng = np.random.default_rng(8)
    for step in ("start", "add", "compact"):
        if step == "add":
            more = rows(7, 50)
            j.append(jnp.asarray(more), 50)
            t.append(more, 50)
        elif step == "compact":
            keep = np.arange(0, t.count, 2)
            j.compact(keep)
            t.compact(keep)
        live = rng.random(t.count) > 0.2
        for k in (1, 10, 128):
            ws, wi = j.topk_all(q, live, k)
            gs, gi = t.topk_all(q, live, k)
            np.testing.assert_array_equal(gi, wi)
            if dtype == "int8":
                np.testing.assert_array_equal(gs, ws)
            else:
                np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
            assert seen[-1] == max(-(-t.count // 128) * 128, k) < t.capacity


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_compact_and_sections_both_ways(tmp_path, dtype):
    j, t = stores(dtype)
    keep = np.arange(0, 300, 3)
    j.compact(keep)
    t.compact(keep)
    assert (t.count, t.capacity) == (j.count, j.capacity)
    np.testing.assert_array_equal(torch_bits(t.rows[: t.count]),
                                  bits(np.asarray(j.rows)[: j.count]))
    write_file(str(tmp_path / "port"), {"kind": "refine"}, t.sections())
    jax_write(str(tmp_path / "jax"), {"kind": "refine"}, j.sections())
    # each package reads the other's file with its own reader
    back_t = RefineStore.from_arrays(48, dtype,
                                     read_file(str(tmp_path / "jax"))[1],
                                     device="cpu")
    back_j = JaxRefine.from_arrays(48, dtype,
                                   jax_read(str(tmp_path / "port"))[1])
    np.testing.assert_array_equal(torch_bits(back_t.rows[: t.count]),
                                  torch_bits(t.rows[: t.count]))
    np.testing.assert_array_equal(bits(np.asarray(back_j.rows)[: j.count]),
                                  bits(np.asarray(j.rows)[: j.count]))
    t.clear()
    assert t.rows is None and t.count == 0
