"""The pieces of the GPU smoke run and the device profile that run on the
CPU: the synthetic conversation recipe, the device busy-time union, the
int8 FFN gates of ``chip_smoke.py``, which must fail a kernel that
rounds its half-step ties away from zero or divides by ``amax / 127``
where the contract multiplies by ``127 / amax``, the int8 GEMM family's
gates, which must fail an ``int8_ffn_out`` fed the bf16 ``h``'s row max
and a fused FFN that requantizes the bf16 ``h``, the attention gates,
which must fail a kernel that skips rounding P before P V, the
reranker's logit-order gate, and ``[cross_process]``'s launcher of ranks
(``spawn_ranks``) ending a job one of whose ranks fails or hangs.
"""

import contextlib
import io
import re
import time

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_search_torch.ingest.chunker import ConversationChunker
from tpu_search_torch.ingest.parser import JSONLParser
from tpu_search_torch.ops import int8_ffn
from tpu_search_torch.ops.mpnet_attention import mpnet_attention_bhsd_plain
from tpu_search_torch.utils.device_profile import busy_seconds
from tpu_search_torch.utils.synthetic import N_CONVERSATIONS, write_conversations


def test_synthetic_recipe_chunk_count(tmp_path):
    """1,000 conversations of the ``benchmarks/index_e2e.py`` recipe chunk
    into 20 chunks for the warm-up file and 16,913 for the rest, the
    counts that recipe gives."""
    files = write_conversations(tmp_path, N_CONVERSATIONS, 30522)
    chunker = ConversationChunker()
    counts = []
    with contextlib.redirect_stdout(io.StringIO()):  # parser warnings
        for path in files:
            conv = JSONLParser().parse_file(str(path))
            counts.append(len(chunker.chunk_conversation(conv)))
    assert counts[0] == 20
    assert sum(counts[1:]) == 16913


@pytest.mark.parametrize("intervals,want_us", [
    ([], 0.0),
    ([(0.0, 10.0)], 10.0),
    ([(5.0, 20.0), (0.0, 10.0), (30.0, 40.0)], 30.0),
    ([(0.0, 50.0), (10.0, 20.0), (50.0, 60.0)], 60.0),
])
def test_busy_seconds_is_the_union(intervals, want_us):
    assert busy_seconds(intervals) == pytest.approx(want_us / 1e6)


def ffn_args(kind, h=768, inter=3072, m=16):
    """Random weights, and random or planted inputs."""
    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, scale=0.02):
        return (scale * torch.randn(shape, generator=gen)).to(
            torch.bfloat16).float()

    w1q, s1 = int8_ffn.quantize_weight_columns(rnd(h, inter))
    w2q, s2 = int8_ffn.quantize_weight_columns(rnd(inter, h))
    if kind == "random":
        pre = rnd(4 * m, h, scale=1.0).to(torch.bfloat16)
        ln1_scale, ln1_bias = 1 + rnd(h, scale=0.1), rnd(h, scale=0.1)
    else:
        pre, ln1_scale, ln1_bias = chip_smoke.planted_ffn_inputs(
            kind, h, m, torch.device("cpu"))
    return (pre, w1q.T.contiguous(), s1, rnd(inter), w2q.T.contiguous(), s2,
            rnd(h), ln1_scale, ln1_bias, 1 + rnd(h, scale=0.1),
            rnd(h, scale=0.1))


def round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def quantize_rows_div(x):
    """The activation quantizer dividing by ``amax / 127``."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    xq = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    return xq.double(), scale


@pytest.mark.parametrize("kind,target,fault", [
    ("ties", torch, ("round", round_half_away)),
    ("mul_div", int8_ffn, ("_quantize_rows_mul", quantize_rows_div)),
    ("random", int8_ffn, ("_quantize_rows_mul", quantize_rows_div)),
])
def test_ffn_gates_fail_a_rounding_fault(monkeypatch, kind, target, fault):
    """A version with the fault passes the max-error gate alone but fails
    the gates ``chip_smoke.py`` holds the kernel to."""
    args = ffn_args(kind)
    ref = int8_ffn.int8_ffn_ln_plain(*args, eps=0.0)
    assert chip_smoke.ffn_ok(chip_smoke.bf16_errors(ref, ref))
    monkeypatch.setattr(target, *fault)
    bad = int8_ffn.int8_ffn_ln_plain(*args, eps=0.0)
    errors = chip_smoke.bf16_errors(bad, ref)
    assert errors["max_abs_err"] <= chip_smoke.TOL["int8_ffn_ln"]
    assert errors["mean_abs_err"] > chip_smoke.FFN_MEAN_TOL
    assert errors["over_1ulp_share"] > chip_smoke.FFN_ULP_SHARE_TOL
    assert not chip_smoke.ffn_ok(errors)


def int8_family(out=torch.bfloat16):
    """The smoke run's int8 family operands at a small size (CPU), and the
    bf16 gelu output of GEMM1 with its f32 row maxima."""
    from tpu_search_torch.ops import int8_gemm

    t = chip_smoke.int8_family_inputs(torch.Generator().manual_seed(16), 64,
                                      128, 512, torch.device("cpu"))
    h, amax = int8_gemm.int8_ffn_in_plain(t["x_q"], t["w1"], t["sx"],
                                          t["s1"], t["b1"], out)
    return t, h, amax


def test_int8_cases_pass_their_gates_on_the_plain_path():
    """Every case ``check_int8_gemm`` runs, on the CPU (where each wrapper
    is its plain version), is inside the gates, and the bounds at the
    bench's shape are the published-peak ones."""
    t, _, _ = int8_family()
    for out in (torch.bfloat16, torch.float32):
        for name, cases in chip_smoke.int8_family_cases(t, out).items():
            for _, kernel, plain in cases:
                got, ref = kernel(), plain()
                for g, r in zip(*((got, ref) if isinstance(got, tuple)
                                  else ((got,), (ref,)))):
                    assert chip_smoke.int8_ok(chip_smoke.ulp_errors(g, r))
    for kind in ("ties", "mul_div"):
        for kernel, plain in chip_smoke.int8_planted_cases(t, kind).values():
            assert torch.equal(kernel(), plain())
    m, h, i = 128 * 384, 768, 3072
    got = {n: chip_smoke.int8_family_bound(n, m, h, i)
           for n in chip_smoke.INT8_FAMILY}
    assert got["int8_gemm"][1] == got["int8_ffn_fused"][1] == "operations"
    assert got["int8_gemm"][0] == pytest.approx(0.1172, abs=1e-4)
    assert got["int8_ffn_out"] == (pytest.approx(0.136, abs=1e-3), "bytes")
    assert got["int8_ffn_fused"][0] == pytest.approx(0.2344, abs=1e-4)


def test_int8_gates_fail_amax_from_bf16_h():
    """``int8_ffn_out`` fed the row max of the bf16 ``h`` instead of the
    f32 ``y``'s (the trap of ``int8_ffn_in``) moves codes in most rows."""
    from tpu_search_torch.ops import int8_gemm

    t, h, amax = int8_family()
    args = (t["w2"], t["s2"], t["b2"], t["res"])
    ref = int8_gemm.int8_ffn_out_plain(h, amax, *args)
    bad_amax = h.float().abs().amax(dim=1, keepdim=True)
    assert not torch.equal(bad_amax, amax)
    bad = int8_gemm.int8_ffn_out_plain(h, bad_amax, *args)
    errors = chip_smoke.ulp_errors(bad, ref)
    assert errors["mean_ulps"] > chip_smoke.INT8_MEAN_ULPS
    assert errors["over_1ulp_share"] > chip_smoke.INT8_ULP_SHARE_TOL
    assert not chip_smoke.int8_ok(errors)


def test_int8_gates_fail_fused_requantized_from_bf16():
    """A fused FFN that quantizes the bf16-rounded ``h`` (what the pair
    does) instead of the f32 one fails the fused kernel's gates."""
    from tpu_search_torch.ops import int8_gemm

    t, h, _ = int8_family()
    fused = (t["x_q"], t["sx"], t["w1"], t["s1"], t["b1"], t["w2"], t["s2"],
             t["b2"], t["res"])
    ref = int8_gemm.int8_ffn_fused_plain(*fused)
    hb = h.float()
    bad = int8_gemm.int8_ffn_out_plain(hb, hb.abs().amax(dim=1), t["w2"],
                                       t["s2"], t["b2"], t["res"])
    errors = chip_smoke.ulp_errors(bad, ref)
    assert errors["mean_ulps"] > chip_smoke.INT8_MEAN_ULPS
    assert errors["over_1ulp_share"] > chip_smoke.INT8_ULP_SHARE_TOL
    assert not chip_smoke.int8_ok(errors)


@pytest.mark.parametrize("h,heads,s", [(312, 12, 128), (64, 2, 256)])
def test_attention_gates_fail_unrounded_probs(h, heads, s):
    """Leaving P in f32 before P V (an f32 ``v`` keeps it there) stays
    inside the max-error gate but fails the mean and ulp-share gates."""
    gen = torch.Generator().manual_seed(15)
    q, k, v, bias, mask = chip_smoke.attention_inputs(
        gen, (8, heads, s, h // heads), heads, s, torch.device("cpu"))
    scale = (h // heads) ** -0.5
    ref = mpnet_attention_bhsd_plain(q, k, v, bias, mask, scale)
    name = "mpnet_attention_bhsd"
    assert chip_smoke.attention_ok(chip_smoke.bf16_errors(ref, ref), name)
    bad = mpnet_attention_bhsd_plain(q, k, v.float(), bias, mask, scale)
    assert bad.dtype == torch.bfloat16
    errors = chip_smoke.bf16_errors(bad, ref)
    assert errors["max_abs_err"] <= chip_smoke.TOL[name]
    assert errors["mean_abs_err"] > chip_smoke.ATTN_MEAN_TOL
    assert errors["over_1ulp_share"] > chip_smoke.ATTN_ULP_SHARE_TOL
    assert not chip_smoke.attention_ok(errors, name)


def test_logit_order_gate():
    """Logits within ``RERANK_LOGIT_TOL`` pass, and so does a swap of two
    logits inside a tie; a swap of two apart, or one logit moved past the
    tolerance, fails."""
    tol = chip_smoke.RERANK_LOGIT_TOL
    cpu = np.array([11.0, 11.0 + tol / 2, -11.0, -11.0 - 8 * tol],
                   np.float32)
    moved = cpu.copy()
    moved[3] += 2 * tol
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.check_logit_order("t", "same", cpu + tol / 2, cpu)
        chip_smoke.check_logit_order("t", "tie", cpu[[1, 0, 2, 3]], cpu)
        for card in (cpu[[0, 1, 3, 2]], moved):
            with pytest.raises(SystemExit):
                chip_smoke.check_logit_order("t", "apart", card, cpu)


def test_logit_gate_against_plain_attention():
    """The kernels' logits are held to the card's plain-attention logits at
    ``RERANK_LOGIT_TOL`` with no allowance added: one logit past it fails,
    and so does a reranker that gives every pair one logit against plain
    logits spread beyond it; ``plain_attention`` routes the encoder layers
    through the plain versions and restores the kernels."""
    import tpu_search_torch.models.mpnet as M
    from tpu_search_torch.ops import mpnet_attention as A

    tol = chip_smoke.RERANK_LOGIT_TOL
    plain = np.array([0.1, 0.1 + tol / 4, 0.1 + 3 * tol], np.float32)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chip_smoke.check_logit_order("t", "near", plain + tol / 2, plain,
                                     "plain_attention")
        for card in (plain + 1.5 * tol,
                     np.full_like(plain, plain.mean())):
            with pytest.raises(SystemExit):
                chip_smoke.check_logit_order("t", "past", card, plain,
                                             "plain_attention")
    assert "plain_attention_logit_order=" in out.getvalue()
    kernels = M.mpnet_attention, M.mpnet_attention_bhsd
    with chip_smoke.plain_attention():
        assert M.mpnet_attention is A.mpnet_attention_plain
        assert M.mpnet_attention_bhsd is A.mpnet_attention_bhsd_plain
    assert (M.mpnet_attention, M.mpnet_attention_bhsd) == kernels


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN41_GLOBAL__N__9ffn_gemm2ILb1ELi256ELi128EEEvPKa
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   IGMMA.64x256x32.S8.S8 R24, gdesc[UR4], R24 ;
        /*0110*/                   IGMMA.64x256x32.S8.S8 R24, gdesc[UR8], R24 ;
\t\tFunction : _ZN41_GLOBAL__N__9ffn_gemm1ILb0EEEvPKa
        /*0100*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24 ;
\t\tFunction : _ZN41_GLOBAL__N__9ln1_quantILi768EEEvPK13__nv_bfloat16
        /*0100*/                   FADD R1, R2, R3 ;
"""


def test_sass_counts_by_function():
    """GMMA (any prefix), IMMA and HMMA are counted per ``Function :``
    section."""
    counts = chip_smoke.sass_counts(
        SASS + "        /*0120*/   IMMA.16816.S8.S8 R4, R8, R12, R4 ;\n"
        "        /*0130*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")
    assert list(counts.values()) == [(2, 0, 0), (1, 0, 0), (0, 1, 1)]
    assert "ffn_gemm1" in list(counts)[1]


@pytest.mark.parametrize("text,wanted,no_imma,faults", [
    (SASS, ("ffn_gemm1", "ffn_gemm2"), True, []),
    (SASS, ("ffn_gemm1", "ln1_quant"), True, ["holds no GMMA"]),
    (SASS, ("flash_kernel",), False, ["no kernel named flash_kernel"]),
    (SASS.replace("IGMMA.64x128x32", "IMMA.16832"), ("ffn_gemm2",), True,
     ["1 IMMA instructions"]),
    (SASS.replace("IGMMA.64x128x32", "IMMA.16832"), ("ffn_gemm2",), False,
     []),
])
def test_sass_rule(text, wanted, no_imma, faults):
    """A required kernel without GMMA, a missing one, or an IMMA where the
    rule refuses it breaks the rule; nothing else does."""
    got = chip_smoke.sass_faults(chip_smoke.sass_counts(text), wanted, no_imma)
    assert len(got) == len(faults)
    for fault, want in zip(got, faults):
        assert want in fault


def test_sass_rules_name_the_redesigned_kernels():
    """Every source with a SASS rule prints its ptxas report too, and the
    rules name kernels of their sources."""
    assert set(chip_smoke.SASS_RULES) <= set(chip_smoke.REDESIGNED)
    for name, (wanted, _) in chip_smoke.SASS_RULES.items():
        src = (chip_smoke.ROOT / "tpu_search_torch" / "csrc"
               / f"{name}.cu").read_text()
        for kernel in wanted:
            assert f"{kernel}(" in src


def test_int8_ffn_pieces_build_from_int8_ffn_ln():
    """``int8_ffn_in``, ``int8_ffn_out`` and ``int8_ffn_fused`` are exports
    of ``int8_ffn_ln.cu`` in the wrappers' library map, the smoke run's
    sources and its build report; no source of their own is built, and no
    file of the port names one."""
    from tpu_search_torch.ops import _build, int8_gemm

    pieces = ("int8_ffn_in", "int8_ffn_out", "int8_ffn_fused")
    for name in pieces:
        assert int8_gemm._LIBRARY[name] == "int8_ffn_ln"
        assert chip_smoke.library_of(name) == "int8_ffn_ln"
        assert chip_smoke.SOURCES[name][0] == (
            "tpu_search_torch/csrc/int8_ffn_ln.cu")
        assert name in chip_smoke.REDESIGNED
        assert name in _build.KERNELS
    assert "int8_ffn_ln" in _build.LIBRARIES
    own = {"int8_ffn_in", "int8_ffn_out"}
    assert not own & set(_build.LIBRARIES)
    gone = [f"{name}.cu" for name in sorted(own)]
    root = chip_smoke.ROOT
    files = [root / "chip_smoke.py", root / "README.md",
             *(root / "tpu_search_torch").rglob("*.py"),
             *(root / "tpu_search_torch" / "csrc").iterdir(),
             *(p for p in (root / "tests").glob("test_torch_*.py")
               if p.name != "test_torch_smoke_tools.py")]
    for path in files:
        text = path.read_text()
        assert not [g for g in gone if g in text], path


@pytest.mark.parametrize("kernel,want", [
    ("void <unnamed>::ffn_gemm2<(bool)1, (int)256, (int)128>(const signed "
     "char *, int)", "ffn_gemm2<1, 256, 128>"),
    ("void (anonymous namespace)::flash_kernel<(int)32, (bool)0>(int)",
     "flash_kernel<32, 0>"),
])
def test_short_name(kernel, want):
    assert chip_smoke.short_name(kernel) == want


def test_kernel_split_merges_instances():
    """The profiler's rows of one kernel's template instances merge into
    one row of its mean time a launch, largest first; a kernel whose first
    launch the profiler missed keeps its mean."""
    rows = [
        ("void (anonymous namespace)::ffn_gemm1<true>(signed char const*)",
         2.8, 4),
        ("void (anonymous namespace)::ffn_gemm2<true>(int)", 3.0, 3),
        ("void (anonymous namespace)::ffn_gemm2<false>(int)", 2.0, 2),
        ("Memset (Device)", 0.05, 5),
    ]
    split = chip_smoke.kernel_split(rows)
    assert [name for name, _, _ in split] == ["ffn_gemm2", "ffn_gemm1",
                                               "Memset"]
    assert split[0][1] == pytest.approx(1.0)
    assert split[0][2] == 5
    assert split[1][1] == pytest.approx(0.7)


DIGIT_SASS = """
\t\tFunction : _ZN41_GLOBAL__N__14ivf_digit_scanINS_8RowTilesELi32ENS_9IvfSourceEEEvPKh
        /*0100*/                   IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], R24 ;
\t\tFunction : _ZN41_GLOBAL__N__14ivf_digit_scanINS_8RowTilesELi8ENS_9IvfSourceEEEvPKh
        /*0100*/                   IMMA.16832.S8.S8 R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("text,faults", [
    (DIGIT_SASS, []),
    (DIGIT_SASS.replace("IGMMA.64x64x32", "IMMA.16832"), ["holds no GMMA"]),
    (DIGIT_SASS.replace("IMMA.16832.S8.S8 R4", "IADD3 R4"), ["holds no IMMA"]),
    (DIGIT_SASS.replace("Li8E", "Li16E"), ["no kernel named"]),
])
def test_digit_sass_rule(text, faults):
    """The digit scans' rule: wgmma in the QB 32 scan, mma.sync in the
    QB 8 one, by demangled name."""
    names = {
        "ivf_digit_scanINS_8RowTilesELi32E":
            "ivf_digit_scan<RowTiles, 32, IvfSource>",
        "ivf_digit_scanINS_8RowTilesELi8E":
            "ivf_digit_scan<RowTiles, 8, IvfSource>",
        "ivf_digit_scanINS_8RowTilesELi16E":
            "ivf_digit_scan<RowTiles, 16, IvfSource>",
    }
    counts = chip_smoke.sass_counts(text)
    by_name = {next(v for k, v in names.items() if k in n): c
               for n, c in counts.items()}
    got = chip_smoke.mma_faults(by_name,
                                chip_smoke.DIGIT_SASS_RULES["ivf_topk_int8"])
    assert len(got) == len(faults)
    for fault, want in zip(got, faults):
        assert want in fault


@pytest.mark.parametrize("drop,imma_free,faults", [
    (None, None, []),
    ("ivf_digit_scan<RowTiles, 32, FlatSource>", None, ["no kernel named"]),
    (None, "digit_partial<WordStage, 32>", ["holds no IMMA"]),
])
def test_flat_int8_sass_rule(drop, imma_free, faults):
    """The flat int8 scan's rule: wgmma in the row ring, mma.sync in each
    digit_partial instance of both layouts, by demangled name."""
    rule = chip_smoke.DIGIT_SASS_RULES["flat_topk_int8"]
    by_name = {name: (kind == "GMMA", kind == "IMMA" and name != imma_free,
                      False)
               for kind, names in rule.items() for name in names
               if name != drop}
    got = chip_smoke.mma_faults(by_name, rule)
    assert len(got) == len(faults)
    for fault, want in zip(got, faults):
        assert want in fault


FLOAT_SASS = """
\t\tFunction : _ZN41_GLOBAL__N__14ivf_float_scanINS_8Bf16RowsELi32ENS_SOURCEEEEvPKh
        /*0100*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], R24 ;
\t\tFunction : _ZN41_GLOBAL__N__14ivf_float_scanINS_8Bf16RowsELi16ENS_SOURCEEEEvPKh
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN41_GLOBAL__N__14ivf_float_scanINS_7F32RowsELi16ENS_SOURCEEEEvPKh
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("kernel,source", [("ivf_topk", "9IvfSource"),
                                           ("flat_topk", "10FlatSource")])
@pytest.mark.parametrize("text,faults", [
    (FLOAT_SASS, []),
    (FLOAT_SASS.replace("HGMMA.64x32x16", "HMMA.16816"), ["holds no GMMA"]),
    (FLOAT_SASS.replace("HMMA.16816.F32.BF16 R4", "FFMA R4"),
     ["holds no HMMA"]),
])
def test_float_sass_rule(text, faults, kernel, source):
    """The bf16 IVF and flat scans' rule (one kernel template over its
    source of tiles): wgmma at query block 32, mma.sync (HMMA) at 16; the
    f32 scan's FMAs need no rule."""
    counts = chip_smoke.sass_counts(text.replace("SOURCE", source))
    by_name = {}
    for mangled, c in counts.items():
        rows = "Bf16Rows" if "Bf16Rows" in mangled else "F32Rows"
        qb = re.search(r"ELi(\d+)E", mangled).group(1)
        src = re.search(r"ENS_\d+(\w+?Source)E", mangled).group(1)
        by_name[f"ivf_float_scan<{rows}, {qb}, {src}>"] = c
    got = chip_smoke.mma_faults(by_name,
                                chip_smoke.DIGIT_SASS_RULES[kernel])
    assert len(got) == len(faults)
    for fault, want in zip(got, faults):
        assert want in fault


def _tf32(a: np.ndarray) -> np.ndarray:
    """``a`` with each f32 rounded to TF32's 10 mantissa bits (to nearest,
    ties away from zero, as the tensor cores take f32 operands)."""
    bits = a.view(np.int32).astype(np.int64)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def test_ivf_f32_gate_separates_f32_from_tf32():
    """``IVF_F32_TOL`` passes f32 products summed in another order and
    fails TF32 operands, on 768-dim unit rows as the smoke's IVF corpus:
    the margin its ``[ivf_topk f32]`` line reads on the card."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((2048, 768)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rows[:16]
    exact = queries.astype(np.float64) @ rows.astype(np.float64).T
    f32 = (torch.from_numpy(queries) @ torch.from_numpy(rows).T).numpy()
    tf32 = (_tf32(queries).astype(np.float64)
            @ _tf32(rows).astype(np.float64).T)
    assert np.abs(f32 - exact).max() <= chip_smoke.IVF_F32_TOL / 4
    assert np.abs(tf32 - f32).max() > 2 * chip_smoke.IVF_F32_TOL


@pytest.mark.parametrize("mode,stop_on_failure", [
    ("failing", False), ("failing", True), ("hanging", True)])
def test_spawn_ranks_ends_a_job_whose_rank_fails(tmp_path, mode,
                                                 stop_on_failure):
    """``[cross_process]``'s worker launcher on the CPU (gloo, a
    ``file://`` rendezvous).  In the ``failing`` mode rank 1 exits with 3
    after a first collective: rank 0's next collective ends it with an
    error of its own (gloo sees the closed peer; ``stop_on_failure=False``)
    or the launcher kills it as soon as rank 1 has ended (what
    ``check_nccl_rules`` asks on the card).  In the ``hanging`` mode rank 1
    sleeps in place of its second collective: the launcher kills both at
    the job's time limit.  Either way no rank is left running and each
    rank's output comes back."""
    limit = 30 if mode == "hanging" else 120
    t0 = time.perf_counter()
    got = chip_smoke.spawn_ranks(
        mode, [[0], [1]], tmp_path, timeout=limit,
        stop_on_failure=stop_on_failure, platform="cpu",
        coordinator=f"file://{tmp_path / 'rendezvous'}")
    job_s = time.perf_counter() - t0
    (rc0, out0, end0), (rc1, out1, end1) = got
    assert rc0 not in (0, None), out0[-2000:]
    assert "every collective returned" not in out0
    if mode == "hanging":
        assert "rank 1 hangs in place of its second collective" in out1
        assert rc1 not in (0, None) and end0 is None and end1 is None
        assert limit <= job_s <= limit + chip_smoke.JOB_END_MARGIN_S
        return
    assert rc1 == 3 and end1 is not None
    assert "rank 1 exits after its first collective" in out1
    if stop_on_failure:
        assert job_s <= end1 + chip_smoke.JOB_END_MARGIN_S
    else:
        assert end0 is not None  # it ended on its own
