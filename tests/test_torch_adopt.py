"""The port's bulk build (``FlatIndex.from_device_vectors``) against the
JAX package's, on the CPU, on the same numpy rows:

- every path of the JAX contract: float32 and bfloat16 (cast, padded,
  adopted as they are where N fills the capacity), int8 and int4
  quantized from f32 and from bf16 sources (a case past one of the JAX
  package's 262,144-row chunks at D 16, whose last chunk overlaps
  backwards there, at an even and an odd N), pre-quantized int8 rows with
  their scales, and ``packed=True`` words at ``capacity == n`` (taken as
  they are) and below it (copied);
- capacity, ``ntotal`` and ``live`` equal; the stored codes and scales
  of the live slots bit for bit (both packages' int8 words unpacked), and
  the validity over the whole capacity;
- search ids equal and scores within 1e-6, with and without a mask, and
  again after a remove and after an add (which grows the index);
- TPUSIDX2 saves of either package load in the other with the same
  answers;
- the JAX package's own ``TestDeviceAdoption`` cases and its argument
  errors on the port;
- ``ops.topk_scan.flat_topk_int8`` / ``flat_topk_int4``, the port's plain
  scans under the JAX names and arguments (int8 rows or int4 words and a
  bool mask), against the JAX functions: the same ids and scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.index.flat import FlatIndex as JaxFlatIndex
from tpu_search.ops.int4_pack import unpack_int4_rows_host
from tpu_search.ops.int8_pack import pack_int8_rows_host, unpack_int8_rows_host
from tpu_search_torch.index.flat import FlatIndex
from tpu_search_torch.ops.int4_pack import bytes_to_nibble_rows
from tpu_search_torch.ops.int8_pack import unpack_int8_rows

SCORE_TOL = 1e-6
INV127 = np.float32(1.0 / 127.0)

# (case, storage dtype, source: "f32" / "bf16" / "int8" / "words", N, D)
CASES = [
    ("f32_padded", "float32", "f32", 3000, 32),
    ("f32_aligned", "float32", "f32", 2048, 32),
    ("bf16_from_f32", "bfloat16", "f32", 1500, 32),
    ("bf16_aligned", "bfloat16", "bf16", 1024, 32),
    ("int8_from_f32", "int8", "f32", 1000, 32),
    ("int8_from_bf16", "int8", "bf16", 2500, 32),
    ("int4_from_f32", "int4", "f32", 999, 32),
    ("int4_from_bf16", "int4", "bf16", 3001, 32),
    ("int8_prequantized", "int8", "int8", 2000, 32),
    ("words_aligned", "int8", "words", 2048, 32),
    ("words_padded", "int8", "words", 2000, 32),
    # past one of the JAX package's 262,144-row chunks
    ("int8_two_chunks", "int8", "f32", 262144 + 1000, 16),
    ("int4_two_chunks", "int4", "bf16", 262144 + 1001, 16),
]
IDS = [c[0] for c in CASES]


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def quantized(rows):
    """Host int8 codes and scales as the JAX index's quantizer gives them."""
    scales = np.maximum(np.abs(rows).max(axis=1) * INV127,
                        np.float32(1e-12)).astype(np.float32)
    return np.rint(rows / scales[:, None]).astype(np.int8), scales


def sources(kind, rows):
    """``(jax args, port args)``: the same corpus for both packages."""
    if kind == "f32":
        return (jnp.asarray(rows),), (torch.from_numpy(rows),)
    if kind == "bf16":
        j = jnp.asarray(rows, dtype=jnp.bfloat16)
        t = torch.from_numpy(rows).to(torch.bfloat16)
        assert np.array_equal(np.asarray(j).view(np.uint16),
                              t.view(torch.int16).numpy().view(np.uint16))
        return (j,), (t,)
    codes, scales = quantized(rows)
    if kind == "words":
        codes = pack_int8_rows_host(codes)
    return ((jnp.asarray(codes), jnp.asarray(scales)),
            (torch.from_numpy(codes), torch.from_numpy(scales)))


def build(case):
    _, dtype, kind, n, d = case
    rows = normed(np.random.default_rng(n), n, d)
    (jv, *js), (tv, *ts) = sources(kind, rows)
    packed = kind == "words"
    ref = JaxFlatIndex.from_device_vectors(
        jv, dtype=dtype, scales=js[0] if js else None, packed=packed)
    port = FlatIndex.from_device_vectors(
        tv, dtype=dtype, scales=ts[0] if ts else None, packed=packed)
    return rows, (jv, tv), ref, port


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def built(request):
    return (request.param,) + build(request.param)


def stored(index):
    """``(codes or rows over the capacity, scales or None)`` as numpy (the
    values a package keeps in dead slots are its own)."""
    if isinstance(index, JaxFlatIndex):
        v = np.asarray(index._vectors)
        if index.dtype == "int8":
            v = unpack_int8_rows_host(v)
        elif index.dtype == "int4":
            v = unpack_int4_rows_host(v)
        elif index.dtype == "bfloat16":
            v = v.view(np.uint16)
        sc = None if index._scales is None else np.asarray(index._scales)
        return v, sc
    v = index._vectors
    if index.dtype == "int8":
        v = unpack_int8_rows(v)
    elif index.dtype == "int4":
        v = bytes_to_nibble_rows(v)
    elif index.dtype == "bfloat16":
        v = v.view(torch.int16)
    v = v.numpy()
    if index.dtype == "bfloat16":
        v = v.view(np.uint16)
    sc = None if index._scales is None else index._scales.numpy()
    return v.astype(np.uint8) if index.dtype == "int4" else v, sc


def assert_same_bits(ref, port):
    assert (port.capacity, port.ntotal, port.live) == (
        ref.capacity, ref.ntotal, ref.live)
    (rv, rs), (pv, ps) = stored(ref), stored(port)
    assert pv.shape == rv.shape
    n = port.ntotal
    np.testing.assert_array_equal(pv[:n], rv[:n].astype(pv.dtype))
    if rs is None:
        assert ps is None
    else:
        np.testing.assert_array_equal(ps[:n].view(np.uint32),
                                      rs[:n].view(np.uint32))
    np.testing.assert_array_equal(port._valid.numpy(), np.asarray(ref._valid))


def assert_same_search(ref, port, queries, k=10, mask=None):
    sr, ir = ref.search(queries, k, mask=mask)
    sp, ip = port.search(queries, k, mask=mask)
    np.testing.assert_array_equal(ip, ir)
    np.testing.assert_allclose(sp, sr, rtol=0, atol=SCORE_TOL)


def test_adoption_matches_jax(built):
    case, rows, _, ref, port = built
    assert_same_bits(ref, port)
    assert port.device == torch.device("cpu")
    rng = np.random.default_rng(1)
    queries = np.concatenate([rows[:3], normed(rng, 3, rows.shape[1])])
    assert_same_search(ref, port, queries)
    mask = rng.random(port.ntotal) < 0.5
    assert_same_search(ref, port, queries, mask=mask)


def test_zero_copy_where_n_fills_the_capacity(built):
    case, rows, (_, source), ref, port = built
    _, dtype, kind, n, _ = case
    if port.capacity != n or kind == "bf16" and dtype != "bfloat16":
        assert port._vectors.data_ptr() != source.data_ptr()
    elif kind == "words" or dtype in ("float32", "bfloat16") and (
            source.dtype == port._vectors.dtype):
        assert port._vectors.data_ptr() == source.data_ptr()
    if dtype == "int8":  # the JAX package's layout: 4 rows a word
        assert port._vectors.dtype == torch.int32
        assert port._vectors.shape == (port.capacity // 4, case[4])
    assert port.make_scan_fn()[0] == ("flat", dtype, "ip")


def test_remove_then_add_match_jax(built):
    case, rows, _, _, _ = built
    _, ref, port = build(case)[1:]  # fresh: the module fixture stays as built
    rng = np.random.default_rng(2)
    queries = normed(rng, 4, rows.shape[1])
    gone = [0, 5, 17, port.ntotal - 1]
    assert port.remove(gone) == ref.remove(gone) == 4
    assert_same_search(ref, port, np.concatenate([rows[5:6], queries]))
    more = normed(rng, 40, rows.shape[1])
    np.testing.assert_array_equal(port.add(more), ref.add(more))
    assert (port.ntotal, port.live) == (ref.ntotal, ref.live)
    n = case[3]
    v, _ = stored(port)
    r, _ = stored(ref)
    np.testing.assert_array_equal(v[: n + 40], r[: n + 40].astype(v.dtype))
    assert_same_search(ref, port, np.concatenate([more[:3], queries]))
    mask = rng.random(port.ntotal) < 0.7
    assert_same_search(ref, port, queries, mask=mask)


SAVE_CASES = ["words_aligned", "int8_from_bf16", "int4_from_f32",
              "bf16_from_f32"]


@pytest.mark.parametrize("name", SAVE_CASES)
def test_saves_load_across_packages(name, tmp_path):
    case = CASES[IDS.index(name)]
    rows, _, ref, port = build(case)
    port.remove([3, 9])
    ref.remove([3, 9])
    queries = normed(np.random.default_rng(3), 5, rows.shape[1])
    want = ref.search(queries, 10)
    port.save(str(tmp_path / "port.idx"))
    ref.save(str(tmp_path / "jax.idx"))
    assert (tmp_path / "port.idx").read_bytes() == (
        tmp_path / "jax.idx").read_bytes()
    for loaded in (JaxFlatIndex.load(str(tmp_path / "port.idx")),
                   FlatIndex.load(str(tmp_path / "jax.idx"), device="cpu")):
        got = loaded.search(queries, 10)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SCORE_TOL)


def test_compact_of_a_word_layout_index_matches_jax():
    rows, _, ref, port = build(CASES[IDS.index("words_aligned")])
    ref.remove(range(0, 600, 3))
    port.remove(range(0, 600, 3))
    assert port.compact() == ref.compact()
    # compact re-adds, and an add sizes the capacity by its own rule in
    # each package (the JAX one pads the batch to a bucket): the rows match
    assert (port.ntotal, port.live) == (ref.ntotal, ref.live)
    (pv, ps), (rv, rs) = stored(port), stored(ref)
    np.testing.assert_array_equal(pv[: port.ntotal], rv[: port.ntotal])
    np.testing.assert_array_equal(ps[: port.ntotal], rs[: port.ntotal])
    assert_same_search(ref, port, rows[:6])


def test_fused_scan_reads_the_words():
    """``make_scan_fn`` / ``scan_staged`` (the fused path's scan) on a
    word-layout index answers as ``search``."""
    from tpu_search_torch.index.flat import flat_scan

    rows, _, _, port = build(CASES[IDS.index("words_aligned")])
    port.remove([1, 2])
    key, buffers = port.make_scan_fn()
    s, i = flat_scan(key, buffers, port.scan_staged(None),
                     torch.from_numpy(rows[:8]), 10)
    want = port.search(rows[:8], 10)
    np.testing.assert_array_equal(i.numpy().astype(np.int64), want[1])
    np.testing.assert_array_equal(s.numpy(), want[0])


# -- the JAX package's adoption cases and errors on the port -----------------


@pytest.mark.parametrize("n", [1024, 900])
def test_prequantized_equals_quantize_on_adopt(n):
    rng = np.random.default_rng(5)
    v = normed(rng, n, 16)
    scales = (np.abs(v).max(axis=1) / 127.0).astype(np.float32)
    vi8 = np.rint(v / scales[:, None]).astype(np.int8)
    pre = FlatIndex.from_device_vectors(
        torch.from_numpy(vi8), dtype="int8", scales=torch.from_numpy(scales))
    ref = FlatIndex.from_device_vectors(torch.from_numpy(v), dtype="int8")
    queries = normed(rng, 4, 16)
    s1, i1 = pre.search(queries, k=5)
    s2, i2 = ref.search(queries, k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-6)


def test_adopted_index_accepts_incremental_adds():
    rng = np.random.default_rng(6)
    vecs = torch.from_numpy(normed(rng, 1024, 8))
    index = FlatIndex.from_device_vectors(vecs, dtype="float32")
    assert index._vectors is vecs
    extra = normed(rng, 10, 8)
    assert list(index.add(extra)) == list(range(1024, 1034))
    assert index.search(extra[3], k=1)[1][0, 0] == 1027
    assert vecs.data_ptr() != index._vectors.data_ptr()  # grown, not written


@pytest.mark.parametrize("call, match", [
    (lambda: FlatIndex.from_device_vectors(
        torch.zeros((1024, 16), dtype=torch.int8), dtype="int8"), "scales"),
    (lambda: FlatIndex.from_device_vectors(
        torch.zeros((1024, 16)), dtype="float32",
        scales=torch.ones(1024)), "scales"),
    (lambda: FlatIndex.from_device_vectors(
        torch.zeros((1022, 16), dtype=torch.int8), dtype="int8",
        scales=torch.ones(1022)), "N % 4"),
    (lambda: FlatIndex.from_device_vectors(
        torch.zeros((256, 16), dtype=torch.int32), dtype="bfloat16",
        packed=True), "packed adoption"),
    (lambda: FlatIndex.from_device_vectors(
        torch.zeros((256, 16)), dtype="int8", scales=torch.ones(1024),
        packed=True), "int32 words"),
    (lambda: FlatIndex.from_device_vectors(
        torch.zeros((64, 16)), metric="l2", dtype="int8"), "ip"),
])
def test_argument_errors_as_jax(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_jax_named_quantized_scans(dtype):
    from tpu_search.index.flat import _quantize_rows
    from tpu_search.ops import topk_scan as jax_scan
    from tpu_search.ops.int4_pack import (pack_int4_rows_host,
                                          quantize_rows_int4_host)
    from tpu_search_torch.ops import topk_scan

    rng = np.random.default_rng(8)
    rows, queries = normed(rng, 2048, 64), normed(rng, 5, 64)
    mask = rng.random(2048) < 0.8
    if dtype == "int8":
        codes, scales = _quantize_rows(rows)
    else:
        u, scales = quantize_rows_int4_host(rows)
        codes = pack_int4_rows_host(u)
    want = getattr(jax_scan, f"flat_topk_{dtype}")(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(mask),
        jnp.asarray(queries), 10)
    got = getattr(topk_scan, f"flat_topk_{dtype}")(
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(mask), torch.from_numpy(queries), 10)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
