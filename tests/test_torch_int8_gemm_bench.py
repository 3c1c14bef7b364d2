"""The int8 GEMM bench (``python -m tpu_search_torch.benchmarks
.int8_gemm_bench``) end to end on the CPU at a small size: every contender
runs and times, and the int8 pair agrees with the bf16 FFN.  The times are
the host's, not a device's."""

import math

from tpu_search_torch.benchmarks import int8_gemm_bench

CONTENDERS = {"bf16_ffn", "int8_pair", "int8_fused", "int8_torch_ffn",
              "renorm", "int8_gemm_in", "int8_gemm_out"}


def test_bench_runs_every_contender_on_the_cpu():
    out = int8_gemm_bench.run(device="cpu", m=64, h=128, i=512, reps=2)
    assert out["device"] == "cpu"
    assert out["shape"] == {"m": 64, "h": 128, "i": 512}
    assert set(out["results"]) == CONTENDERS
    for name, r in out["results"].items():
        assert math.isfinite(r["ms"]) and r["ms"] > 0, name
    assert out["cos_int8_pair_vs_bf16"] >= 0.99


def test_bench_main_prints_one_json_line(capsys):
    int8_gemm_bench.main(["--device", "cpu", "--m", "32", "--h", "64",
                          "--i", "128", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"int8_fused"' in lines[0]
