"""The two scan probes (``python -m tpu_search_torch.benchmarks.int4_probe``
and ``.scan_overhead_probe``) end to end on the CPU at a small N: every key
of the JAX probes is there, and each variant's plain version returns what
the variant computes, checked against an independent computation:

- ``full``, ``concat1mm`` and ``prod`` (int4) give the plain flat int4
  top-k, and the bf16 ``prod`` and ``slot*`` variants the plain flat top-k,
  exactly (the same plain versions);
- the folds: ``dma`` and ``unpack`` equal a numpy XOR of the corpus words
  (split words), ``mm_only`` a numpy int64 product of the digits and the
  raw bytes, ``nomerge`` (int4) the top-1 of the flat int4 scan before
  the query scale, exactly; the bf16 ``nomerge`` the top-1 of the flat
  scan, exactly (the same f32 products).
The times are the host's, not a device's.
"""

import json

import numpy as np
import pytest
import torch

from tpu_search_torch.benchmarks import int4_probe, scan_overhead_probe
from tpu_search_torch.ops.topk_scan import flat_topk_int4_plain, flat_topk_plain

N = 4096 + 1024
# the keys the JAX probes write (benchmarks/int4_probe.py and
# benchmarks/scan_overhead_probe.py), with the port's row ranges
INT4_KEYS = {f"{mode}_t{rows}" for rows in int4_probe.ROWS
             for mode in ("prod", "dma", "mm_only", "unpack", "nomerge",
                          "full", "concat1mm")}
OVERHEAD_KEYS = {
    key for rows in scan_overhead_probe.ROWS for key in (
        *(f"t{rows}_{tag}_r{reps}" for tag in ("prod", "nomerge", "slot3",
                                               "slot4") for reps in (20, 100)),
        f"t{rows}_twice_r20", f"t{rows}_marginal")}


def test_int4_probe_has_every_jax_key():
    out = int4_probe.run(device="cpu", n=N, reps=1)
    assert out["device"] == "cpu" and out["n"] == N
    assert INT4_KEYS <= set(out["results"])
    for key, r in out["results"].items():
        assert r["ms"] > 0 and r["bound_ms"] > 0, key


def test_scan_overhead_probe_has_every_jax_key():
    out = scan_overhead_probe.run(device="cpu", n=512)
    assert out["device"] == "cpu" and out["n"] == 512
    assert OVERHEAD_KEYS <= set(out["results"])
    assert {f"t{r}_{v}_r20" for r in scan_overhead_probe.ROWS
            for v in scan_overhead_probe.VARIANTS} <= set(out["results"])


@pytest.fixture(scope="module")
def int4_data():
    return int4_probe.make_inputs(N, 3, "cpu")


def test_int4_topk_variants_give_the_flat_scan(int4_data):
    corpus, prep = int4_data
    want = flat_topk_int4_plain(*corpus, prep[0], int4_probe.K)
    for mode in ("full", "concat1mm", "prod"):
        got = int4_probe.probe(mode, corpus, prep)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_int4_folds_equal_independent_sums(int4_data):
    corpus, prep = int4_data
    nibbles, scales, penalty = corpus
    words = nibbles.numpy().view(np.uint32)
    assert int4_probe.probe("dma", corpus, prep) == int(
        np.bitwise_xor.reduce(words, axis=None))
    split = (words & 0x0F0F0F0F) ^ ((words >> 4) & 0x0F0F0F0F)
    assert int4_probe.probe("unpack", corpus, prep) == int(
        np.bitwise_xor.reduce(split, axis=None))
    q_i8 = prep[1].numpy().astype(np.int64)
    raw = nibbles.numpy().view(np.int8).astype(np.int64)
    want = (q_i8[: int4_probe.Q] @ raw.T).max(axis=1)
    got = int4_probe.probe("mm_only", corpus, prep)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    top1 = flat_topk_int4_plain(*corpus, prep[0], 1)[0][:, 0]
    got = int4_probe.probe("nomerge", corpus, prep)
    assert torch.equal(got * prep[3], top1)


def test_overhead_variants_equal_their_plain_versions():
    vectors, penalty, queries = scan_overhead_probe.make_inputs(N, 4, "cpu")
    assert vectors.dtype == torch.bfloat16 and queries.dtype == torch.bfloat16
    np.testing.assert_allclose(vectors.float().norm(dim=1).numpy(), 1.0,
                               atol=1e-2)
    want = flat_topk_plain(vectors, penalty, queries, scan_overhead_probe.K)
    for variant in ("prod", "slot2", "slot3", "slot4"):
        got = scan_overhead_probe.probe(variant, vectors, penalty, queries)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = scan_overhead_probe.probe("nomerge", vectors, penalty, queries)
    assert torch.equal(got, want[0][:, 0])
    assert set(scan_overhead_probe.check("cpu", n=1000).values()) == {0.0}
    assert set(int4_probe.check("cpu", n=1000).values()) == {0.0}


@pytest.mark.parametrize("module", [int4_probe, scan_overhead_probe])
def test_main_prints_one_json_line(module, capsys):
    module.main(["--device", "cpu", "--n", "512"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["device"] == "cpu"
    assert json.loads(lines[0])["n"] == 512


def test_main_scans_a_small_corpus_on_the_cpu_by_default(monkeypatch):
    seen = {}

    def fake_run(device, n, *args):
        seen["n"] = n
        return {"results": {}}

    monkeypatch.setattr(int4_probe, "run", fake_run)
    int4_probe.main(["--device", "cpu"])
    assert seen["n"] == int4_probe.CPU_ROWS
