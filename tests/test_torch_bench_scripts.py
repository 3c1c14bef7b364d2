"""The ported bulk-build benchmark scripts end to end on the CPU at tiny
sizes (``python -m tpu_search_torch.benchmarks.<name> --device cpu``):
each prints its JSON lines with the headline last, carrying the JAX
script's keys, and its self-check holds:

- ``scale_10m`` on two small chunks: the words adopted as they are and
  scanned in the word layout, recall@10 against the f32 truth >= 0.9, the
  word scan equal to the row scan on the same corpus;
- ``ivf_sweep``: recall 1.0 at nprobe = nlist;
- ``sharded_scan``: the sharded ids equal to one device's;
- ``int8_residual_ab``: both encodings measured, residual recall >= raw
  recall - 0.05;
- ``cross_encoder_bench``: both contenders' logits equal (both plain on
  the CPU);
- ``index_e2e``: every file indexed, no error.

Without ``--device cpu`` and with no card, every script raises before it
does any work (no quiet fallback to the CPU), and ``--out`` writes the
headline where it is asked to.
"""

import json

import pytest
import torch

from tpu_search_torch.benchmarks import (
    cross_encoder_bench,
    index_e2e,
    int8_residual_ab,
    ivf_sweep,
    scale_10m,
    sharded_scan,
)

SCALE_KEYS = {"what", "n", "dim", "gen_s", "adopt_s", "recall_at_10_vs_f32",
              "device_scan_ms_q8", "qps_b128_host_synced", "index_hbm_gb",
              "effective_gbps", "bound_ms", "peak_device_gb", "card"}
SWEEP_META_KEYS = {"n", "dim", "dtype", "platform", "queries", "k", "noise",
                   "flat_qps_batched", "train_s_nlist16", "add_s_nlist16",
                   "fill_fraction_nlist16"}
SWEEP_ROW_KEYS = {"nlist", "nprobe", "recall_at_10", "qps",
                  "speedup_vs_flat", "ms_q1", "speedup_vs_flat_q1", "ms_q8",
                  "speedup_vs_flat_q8"}
AB_KEYS = {"n", "dim", "nlist", "nprobe", "k", "recall_sample", "device",
           "recall_raw", "qps_b128_raw", "recall_residual",
           "qps_b128_residual"}
E2E_KEYS = {"device", "conversations", "files_processed", "chunks_indexed",
            "wall_s", "warmup_first_file_s", "s_per_1k_conversations",
            "chunks_per_s", "vs_ref_cpu", "vs_ref_cuda", "ref_rows",
            "peak_host_rss_gb", "ref_indexing_memory", "store_gb_per_1k_conv",
            "ref_storage", "errors", "phases"}


def lines_of(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out]


def test_scale_10m(capsys, tmp_path):
    path = tmp_path / "scale.json"
    scale_10m.main(["--device", "cpu", "--n", "8192", "--chunk", "4096",
                    "--dim", "64", "--against-rows", "--out", str(path)])
    (out,) = lines_of(capsys)
    assert SCALE_KEYS <= set(out)
    assert out["n"] == 8192 and out["recall_at_10_vs_f32"] >= 0.9
    assert out["zero_copy"]
    assert out["words_equal_rows"]
    assert json.loads(path.read_text()) == out


def test_ivf_sweep(capsys):
    ivf_sweep.main(["--device", "cpu", "--n", "2048", "--dim", "32",
                    "--queries", "16", "--clusters", "16", "--nlists", "16",
                    "--nprobes", "4,16", "--qbatches", "1,8",
                    "--train-sample", "1000"])
    *rows, out = lines_of(capsys)
    assert set(out) == {"meta", "sweep"} and out["sweep"] == rows
    assert SWEEP_META_KEYS <= set(out["meta"])
    assert [(r["nlist"], r["nprobe"]) for r in rows] == [(16, 4), (16, 16)]
    assert all(SWEEP_ROW_KEYS <= set(r) for r in rows)
    assert rows[-1]["recall_at_10"] == 1.0


def test_sharded_scan(capsys):
    sharded_scan.main(["--device", "cpu", "--devices", "4", "--n", "4096",
                       "--dim", "32"])
    (out,) = lines_of(capsys)
    assert out["exact_match_vs_single_device"] and out["shards"] == 4


def test_int8_residual_ab(capsys):
    int8_residual_ab.main(["--device", "cpu", "--n", "4096"])
    (out,) = lines_of(capsys)
    assert AB_KEYS <= set(out)
    assert out["nlist"] == 16 and out["nprobe"] == 16
    assert out["recall_residual"] >= out["recall_raw"] - 0.05
    assert out["recall_raw"] > 0.5


def test_cross_encoder_bench(capsys):
    cross_encoder_bench.main(["--device", "cpu", "--batch", "2", "--seqs",
                              "16", "--reps", "1"])
    plain, kernel, out = lines_of(capsys)
    assert out["rows"] == [plain, kernel]
    assert (plain["impl"], kernel["impl"]) == ("plain", "kernel")
    assert plain["logit"] == kernel["logit"]
    assert plain["pairs_per_s"] > 0 and kernel["pairs_per_s"] > 0


def test_index_e2e(capsys):
    index_e2e.main(["--device", "cpu", "--conversations", "4", "--width",
                    "tiny"])
    (out,) = lines_of(capsys)
    assert E2E_KEYS <= set(out)
    assert out["files_processed"] == out["conversations"] == 3
    assert out["errors"] == 0 and out["chunks_indexed"] > 0


@pytest.mark.parametrize("script", [scale_10m, ivf_sweep, sharded_scan,
                                    int8_residual_ab, cross_encoder_bench,
                                    index_e2e])
def test_no_card_no_quiet_cpu(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        script.main([])
