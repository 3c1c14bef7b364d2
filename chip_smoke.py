"""Smoke run of tpu_search_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on its own line:
  1. build the CUDA kernels from ``tpu_search_torch/csrc`` (one ``nvcc``
     per source, all started together), print the registers and spills
     ptxas reports for the sources of the kernels redesigned for Hopper
     (``REDESIGNED``), check in their SASS that the
     int8 products (``int8_gemm``, and ``int8_ffn_ln``'s GEMMs, which
     ``int8_ffn_in``, ``int8_ffn_out`` and ``int8_ffn_fused`` run too)
     are wgmma's alone and that
     ``flash_attention``'s and ``mpnet_attention_bhsd``'s q k^T issue
     wgmma, that the flash backward's passes (bf16 ``rows_wgmma``,
     ``cols_wgmma``; the tf32 ``rows_tf32``, ``cols_tf32``) and the flash
     f32 forward (``flash_tf32_fwd``) multiply with wgmma, that the IVF
     digit scans multiply with wgmma at Q > 8 and
     mma.sync at Q <= 8, that the dense attention backward's and f32
     forward's kernels and the flash bf16 forward above hd 128 multiply on
     the tensor cores (HMMA), and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (max error, kernel and plain times,
     the least time the card could take, and where one PyTorch call
     computes the same function, that call's time), the flat scan also at
     k > 128 and on the cases of ``tests/test_pallas_topk.py``, the int8
     scan in both corpus layouts; the three IVF probe scans at the size
     the JAX bench gives IVF (1M x 768 clustered unit rows, nlist 1024,
     trained by the port's balanced k-means on the card, 10 % tombstoned;
     the 4,096 cluster centres and row labels come from a numpy seed, the
     per-row noise from a torch generator seeded alike), nprobe 8 and 32,
     Q/k in (1, 10), (1, 128), (8, 10), (128, 10), (128, 128) and k = 200
     (scores mode), with the int8 / int4 scans' prologue kernel against its
     plain twin (``[ivf_prep]``) at every case and each scan's shared
     memory and CTAs a multiprocessor; and the IVF index against the flat
     exact scan at nprobe = nlist, and its ``tune_nprobe(0.95)``; then
     ``[pq]``, the PQ tier on the same corpus (no kernel of its own: plain
     PyTorch, as the JAX package scores pq outside its Pallas kernels):
     pq_m 192 indexes without OPQ, with it and with an int8 refine tier,
     each scan gated against a float64 table lookup on 8 queries
     (``PQ_TOL``), recall@10 against the exact f32 scan, and the scan's
     ms, device ms, launches and peak memory at Q 1, 8 and 128 beside the
     bytes bound of the probed codes; then ``[sharded]``, the sharded
     exact index (``parallel.ShardedFlatIndex``) over 4 shards that share
     the card (``build_mesh(n_data=4, devices=[cuda:0] * 4)``) at 1M x
     768 unit rows, 10 % tombstoned, bf16, f32, f32 l2, int8 and int4: each
     against the single-device ``FlatIndex`` on the same rows at Q 1, 8,
     128 and k 10, 128, 200 (scores within ``SHARDED_REL_TOL``, ids equal
     outside exact ties) and against its shards' plain versions and the
     same merge, the wrapper's ms, device ms, kernel calls and device
     launches a call, the merge's share and the single-device ms at k 10,
     beside the card's name and power limit; then a search under a
     one-rank NCCL group (``initialize_distributed``), which gathers and
     answers alike; then ``[sharded_ivf]``, the sharded IVF index
     (``parallel.ShardedIVFIndex``) over the same 4 shards at the IVF
     scans' size (1M x 768 clustered unit rows, nlist 1024, 10 %
     tombstoned) in bf16, f32, f32 l2, int8, int4, int4 with its int8
     refine tier and pq: each against a single-device ``IVFIndex`` with the
     same centroids (and books) at Q 1, 8, 128, k 10 and Q 8, k 128,
     nprobe 32, each shard's scan against its plain twin, the kernels' C
     calls (one a shard) and device launches a call, the wrapper's ms and
     device ms beside the single device's, the merge's and the rescore's
     ms; and a refined search under a one-rank NCCL group; then the bulk
     build: ``[adopt]`` (``check_adopt``), ``FlatIndex.from_device_vectors``
     on 1M x 768 unit rows made on the card, f32 and bf16 rows and int8 /
     int4 codes from f32 and bf16 sources, and 2^20 rows of int8 words
     adopted as they are, each against ``add`` of the same rows (capacity,
     stored bits, scales, ids and scores at Q 8), with the device memory
     each took above its source, and the fused window (a CUDA graph, a
     one-layer encoder) on the adopted bf16 and word indexes against the
     classic path; and ``[scale_10m]`` (``run_scale_10m``), the entry
     point ``benchmarks.scale_10m.run`` at 10,027,008 x 768 int8 words on
     the card: recall@10 against the f32 truth, the words scanned in their
     layout and equal to the row scan on the same corpus, the scan's ms
     and device ms at Q 8 beside its bytes bound;
  3. drive the main path at the full width of all-mpnet-base-v2 with
     random seeded weights, on six storage paths, each a fresh data
     directory: flat bf16 (1,000 conversations), flat
     ``CLAUDE_SEARCH_STORAGE_DTYPE=int8`` and ``=int4`` (200 each), then
     ``CLAUDE_SEARCH_INDEX_TYPE=ivf`` with bf16 (1,000), int8, int4 and pq
     (200 each; int4 and pq with their automatic int8 refine tier and
     deployed-recall calibration, pq after ``tune_pq_config``), and pq
     once more with ``CLAUDE_SEARCH_PQ_OPQ=1`` (index, search, the CLI).
     Each indexes synthetic conversations through
     ``SearchEngine.index_conversations``, searches in process (filtered
     too, and at ``top_k=200``) and through the CLI in a subprocess (the
     IVF paths but OPQ also run ``optimize`` through the CLI; a CLI check
     that nothing later in its path waits for runs on a thread beside the
     paths that follow, all of them joined at the end of the phase), and
     checks that its kernels were launched, with the launch counts set to 0 just before
     the path and read just after.  The IVF paths warm up on 10 files, not
     1, so that their first add trains the default 100 lists (the JAX
     package's rule: a first batch smaller than nlist shrinks nlist).
     Searches in process run the fused path (``api/fused.py``: one CUDA
     graph a window shape, replayed), whose replays count their kernels'
     launches.  After the flat bf16 path's CLI check comes ``[warm]``: an
     in-process ``QueryServer`` on its engine answers the 20 queries one
     at a time (each equal to the in-process answer: the same ids,
     similarities within ``WARM_EXACT``), then from 8 and 32 client
     threads (ids equal outside near-ties, similarities within
     ``WARM_TOL``), the 20 and the 16 unfiltered alone, printing p50, p90
     and queries/s; a window of 1 and of 9 queries captured anew, replayed
     and run eagerly (equal, and the device memory each capture
     reserved); a conversation indexed through the server's worker found
     at rank 1 through the socket, then removed and gone; a replay's
     device split (torch.profiler); the flat scan over the capacity
     against over the rows, and a capture's time.  Then
     ``[sharded_serving]``: the flat bf16 directory's index loaded with
     ``ShardedFlatIndex.load`` over the 4 co-located shards into the same
     engine, the 20 queries through the fused path (one graph a window
     shape, the 4 shard scans and the merge in it) and the classic path,
     the 16 unfiltered through the warm server, and the sharded index
     saved and loaded into a single-device ``FlatIndex``: every answer
     equal to the single-device one; the IVF int4 path does the same
     with its index (with its int8 refine tier) loaded by
     ``ShardedIVFIndex.load``, its fused replays running the 4 shard
     scans, the merge and the rescore.  Each then runs its 20 queries
     again under a one-rank NCCL group (``grouped_window``): the window
     takes the shards as a plan whose gather (and rescore sum) is a
     program step between graph replays, every answer equal to the
     ungrouped window's (ids, ``WARM_EXACT``), a replay equal to its
     eager run, the collectives a search and the p50 beside the
     ungrouped.  The flat int8 and the
     IVF int4 and pq paths end with their 16 probes one at a time through
     the warm server, each equal to the in-process answer.  After ``[warm]``
     the flat bf16 directory is served by the product's other entry
     points, each in its own process, with the launch counts that process
     writes at exit (``CLAUDE_SEARCH_LAUNCH_LOG``) and its CUDA context
     checked: ``[http]``, ``cli serve --port 0`` (its routes; the 16
     unfiltered probes one at a time, each equal to the in-process answer,
     then from 8 client threads within ``WARM_TOL``; a ``project``
     filter; p50 / p90, queries/s); ``[mcp]``, the MCP stdio server (the
     handshake, five tools, each probe's own text at Result 1 with
     similarity >= 0.999, ``related_to`` + ``same_session``, the other
     tools, -32601 for an unknown tool, a tool call's p50); ``[cli]``,
     ``search --chunk-id``, ``--related-to --same-session`` (the
     session's other chunks in time order), ``--related-to`` with a query
     (that session only) and ``stats --gpu`` (the card's name);
  4. the BERT family at full width with random seeded weights: an
     all-MiniLM-L6-v2 embedder (flat bf16, 200 conversations, the same
     searches and CLI check), then on its index three rerank paths through
     ``search_conversations(rerank=True)`` and the CLI's ``search --rerank
     --json`` (top_k 10, factor 5): the default ms-marco-MiniLM-L-6-v2
     cross-encoder (the ``[B, S, H]`` attention), ms-marco-TinyBERT-L-4 (H
     312, hd 26: the ``[B, heads, S, hd]`` kernel) and the checked-in
     trained tiny-overlap reranker (H 64, the same kernel), each against
     the same checkpoint on the CPU, the fixture also on the ordering cases
     of ``tests/test_rerank_quality.py``.
  5. the int8 GEMM bench (``tpu_search_torch.benchmarks.int8_gemm_bench``,
     all-mpnet-base-v2's FFN over M = 128 x 384 rows), the entry point of
     ``int8_gemm``, ``int8_ffn_in``, ``int8_ffn_out`` and
     ``int8_ffn_fused``: every contender timed, the int8 pair's cosine to
     the bf16 FFN at least 0.999;
  6. the two scan probes (``tpu_search_torch.benchmarks.int4_probe`` and
     ``.scan_overhead_probe``), the entry points of ``int4_probe`` and
     ``scan_overhead_probe``: every variant against its plain version at a
     small N, then every variant timed at 1M x 768;
  7. the watcher daemon: ``cli start --http-port P`` on the card watching
     an empty projects directory, 20 conversations copied in and indexed
     by the daemon, ``cli search --json`` answered through its warm server
     (run with a model name that does not exist, so no local engine could
     answer) and ``/v1/search`` through its HTTP front (``chunk_000003``
     at rank 1, 16 calls timed), ``cli stop`` and ``cli status``;
  8. ``[storage]``, on a copy of the flat int8 path's directory:
     ``delete_chunks_by_session`` gone from the next fused search,
     ``backup`` then ``restore`` into a fresh engine with the 16 probe
     answers unchanged, ``models/setup.py --from-dir`` on a small random
     HF-format MPNet verified on the card, and ``index --trace`` whose
     ``torch.profiler`` trace names kernels of ``mpnet_attention.cu`` and
     ``int8_ffn_ln.cu``;
  9. ``[train]`` (``check_train``): the training step at
     all-mpnet-base-v2's full width (seeded random weights, bf16 compute
     over f32 masters), 32 query/doc pairs at S 64 / 256: each parameter's
     gradient with the kernels against the plain attention's (cosine >=
     ``TRAIN_GRAD_COS``), 5 AdamW steps at ``TRAIN_LR`` on one fixed batch
     (the loss falling; ms a step, pairs/s, tokens/s, peak MB, the
     backward's 24 launches a step), 4 data shards on cuda:0 against one,
     save / load / resume, a profiled step (wall, device busy, the
     attention backward's device ms, the largest kernels), the fine-tuned
     checkpoint served by ``SearchEngine`` (8 self-searches at rank 1), a
     one-rank NCCL group giving the same step; ``[f32_encoder]``:
     ``EmbeddingGenerator`` at f32 compute on the card
     (``mpnet_attention_f32.cu``) against the CPU encoder, cosine >=
     ``F32_ENCODER_COS``; ``[flash_grad]`` (``check_flash_grad``): the
     flash mode under autograd at all-mpnet-base-v2's width, the
     trainer's InfoNCE over 32 pairs at S 128 / 256 in bf16 and f32, with
     the kernels against the plain forward and backward on the card (the
     loss, every gradient's cosine, 24 forward and 24 backward launches a
     step), its ms a step beside the dense mode's, and the f32 flash
     embeddings against the CPU's; ``[dryrun]``: the port's
     ``parallel.dryrun.dryrun_multichip(4)`` on 4 x cuda:0;
 10. the other ported bulk-build scripts through their entry points
     (``run_bench_scripts``): ``[ivf_sweep]``, ``[sharded_scan]``,
     ``[int8_residual_ab]``, ``[cross_encoder_bench]`` and
     ``[index_e2e]``, each line its JSON, its seconds and its launches.
Phase 3 ends on the flat bf16 path's encoder (all-mpnet-base-v2 at full
width, the int8 FFN through its gate) run through
``forward(attention_impl="flash")`` at B 128, S 384, the entry point of
``flash_attention``: its embeddings against the same weights on the CPU in
the flash mode (cosine > 0.999), its time beside the default mode's.
The ``[B, S, H]`` attention prints its shared memory and SDPA's time at
every shape, the flash and ``[B, heads, S, hd]`` kernels their shared
memory, CTAs a multiprocessor and SDPA's time; ``int8_gemm`` prints
TOP/s, ``torch._int_mm``'s time and both of its tiles' times at the
bench's two shapes, ``int8_ffn_in`` and ``int8_ffn_fused`` their TOP/s,
and these two and ``int8_ffn_out`` each of their launches' device time
(torch.profiler) at the bench's shape;
``int8_ffn_ln`` at H 768 prints its effective TOP/s, each of its
launches' device time and, as yardsticks it never calls, the port's bf16
FFN half on the same inputs and ``torch._int_mm`` of its two products.  The
rerank paths also hold the card's logits against the card's own with the
plain attention in place of the kernels, on the same pairs.
Phase 2 also holds the ``[B, heads, S, hd]`` kernel against its plain
version at B 128 over S 64-512 at H 312 / 12 heads and H 64 / 2 heads, the
``[B, S, H]`` kernel at S 512 / H 384, the int8 FFN at H 384 / I 1536,
H 312 / I 1200 and H 1024 / I 4096 (and a 312-wide embedder through the
int8 gate), and the four int8 GEMM kernels at the bench's shape, at M 512,
and at H 312 / I 1200 and H 1024 / I 4096 with a ragged M, bf16 and f32
outputs, and on planted requantization inputs; ``int8_ffn_ln`` at 0 ulps
from its plain version on ``planted_epilogue``'s inputs, whose LayerNorm
statistics are exact; the stock-flash kernel at ``FLASH_SHAPES`` (S 384
and 512, hd 64, 32 and 26) and ``FLASH_WIDE_SHAPES`` (hd 160 at S 128,
256 and 384 at S 256) with padded rows and a trained-scale bias, and at
the same shapes ``[flash_attention_bwd]``, its backward kernel
(``flash_attention_bwd.cu``) in bf16 and f32 against its plain version
from the forward's output and residuals (dQ, dK, dV and dab gated, and
the same bits from a second call; ms, device ms, launches, each launch's
device time, the bound and each pass's, SDPA's forward + backward, shared
memory, CTAs a multiprocessor, registers and spills of both passes), and
``[flash_attention_f32]``, its f32 forward (``flash_attention_f32.cu``)
with its residuals, beside SDPA f32, with its registers and spills;
``[attention_grad]``, the attention's backward kernel
(``mpnet_attention_bwd.cu``) against its plain twin and against autograd of
the plain forward at ``GRAD_SHAPES`` in bf16 and f32 (dQ, dK, dV and dBias
gated; ms, device ms, launches, each launch's device time, the bound and
SDPA's forward + backward; both kernels' SASS must hold HMMA, ``mma.sync``
on the tensor cores),
and ``[attention_f32]``, the f32 forward (``mpnet_attention_f32.cu``)
against its plain twin at ``F32_SHAPES``.
The second line from the end is the kernel summary JSON, with each
kernel's launch count from the path that runs it; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.

    python3 chip_smoke.py --cross-card

on a machine of two or more cards builds the kernels and runs only
``[cross_card]`` (``check_cross_card``): each card pair's peer access; an
engine with ``CLAUDE_SEARCH_SHARD_DEVICES`` unset, whose auto rule shards
its flat index over every card and whose fused window takes the shards
(one CUDA graph a card), answering as the classic path and as one card,
a replay equal to its eager run, an add and a remove seen, its warm
server equal to in process; the sharded index with one shard on each
card against one card (flat in five cases, and IVF int4 with its int8
refine tier); at 1M x 768 in bf16, int8 and IVF int4 + refine,
``[cross_card_fused]``: the fused window over the cards against the
classic path on the same cards and one card's fused window (p50, wall,
graph replays and kernel launches a search, equal answers); and a dp
train step with one data shard a card against one card.  Then
``[cross_process]`` (``check_cross_process``, four cards): NCCL across
processes, each rank a ``chip_smoke.py --cross-process-worker`` process
on cards of its own (``spawn_ranks``): two ranks on one card must both
fail, a job one of whose ranks exits must end at once and one whose rank
hangs at its time limit, no rank left running; then 4 ranks of 1 card and
2 of 2 (``cross_process_layout``): the sharded flat
index at 1M x 768 in the five cases and the sharded IVF int4 index with
its refine tier against one card, per-process save and load, an engine a
rank sharding over every card of every process whose fused window across
the processes answers as the classic path and one card, its p50 against
the classic path at 1M rows, the dp encode and two train steps against
one card, every answer alike on every rank and each layout's seconds.
The last line is the same ``{"ok": true, ...}``.  Both runs print
``[capability]``, the card's report (``devices.assess_gpu_capability``),
first.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# Tolerances of each kernel against its plain version on the card.
#  flat_topk: f32 sums of 768 bf16 products of unit vectors in another
#    order: score error ~1e-6; ids must agree outside near-ties.
#  mpnet_attention: bf16 output of O(1) magnitude; probs and outputs round
#    to bf16 at the same sites, sums differ in order -> a bf16 ulp or two.
#  int8_ffn_ln: bf16 LN2 output of O(1); f32 epilogues in another order can
#    move an activation across a rint tie (one int8 step) -> a few ulps.
#    A fault at a rounding site leaves that max where it was, so the mean
#    error and the share of outputs more than one bf16 ulp off are gated
#    too.  The kernel shows ~2e-6 and ~2e-4 on random inputs; dividing by
#    amax / 127 gives ~3e-4 and ~3 %, quantizing LN1's output before its
#    bf16 rounding ~4e-3 and ~37 %, and on the planted inputs (see
#    ``planted_ffn_inputs``) a fault at the planted site ~5e-3 and 30-57 %.
#  flat_topk_int8, flat_topk_int4: exact int32 dots, the same written-out
#    FMA, multiply and add as the plain version's float64 combine, and
#    first-index ties: scores and ids identical, gate 0.
#  ivf_topk: as flat_topk; ivf_topk_int8, ivf_topk_int4: as the flat
#    int8 / int4 scans, the per-probe bias one more written-out add.
#  mpnet_attention_bhsd: as mpnet_attention (the same two-pass loop).
#  flash_attention: as mpnet_attention: the same products, the same bf16
#    rounding of p at the same step (the stock kernel's 128-key blocks);
#    the running sum adds in another order.
#  Both attention kernels also gate the mean error and the share of outputs
#  more than one bf16 ulp off: the kernels show 2e-8 to 1.2e-7 and under
#  1e-4; leaving P unrounded before P V gives 2e-4 and 10 % with a max
#  (8e-3 to 1.6e-2) inside the max gate.
TOL = {"flat_topk": 1e-4, "mpnet_attention": 3e-2, "int8_ffn_ln": 6.25e-2,
       "flat_topk_int8": 0.0, "flat_topk_int4": 0.0, "ivf_topk": 1e-4,
       "ivf_topk_int8": 0.0, "ivf_topk_int4": 0.0,
       "mpnet_attention_bhsd": 3e-2, "flash_attention": 3e-2}
# ivf_topk on f32 blocks: exact f32 FMAs against the plain version's f32
# products differ only in the order of the sums.  TF32 operands (10
# mantissa bits) would pass the 1e-4 of the bf16 blocks, so the f32 case
# has its own gate, and its line reports the plain version's error with
# TF32 products beside it: the gate's margin is read, not assumed.
IVF_F32_TOL = 1e-5
ATTN_MEAN_TOL = 1e-5
ATTN_ULP_SHARE_TOL = 1e-3
# A reranker's logits (before the sigmoid, which saturates) on the card
# (bf16) against the same checkpoint on the CPU (f32) differ by at most
# this: read 1.26e-3 (MiniLM-L-6), 9.7e-4 (TinyBERT-L-4) and 3.0e-4 (the
# trained fixture).  Two logits closer than twice it on the CPU are a tie,
# whose order the card may flip; farther apart, their order must hold.
# Random-weight rerankers give every candidate about one logit (std near
# 1e-3), and their spread from the CPU is mostly not the attention
# kernels': the int8 FFN's requantization (a code that flips moves a whole
# row by a weight step) puts the card with the plain attention as far from
# the CPU on some candidate sets.  So on every rerank path the card's
# logits are held to this tolerance against the card's own logits with
# the plain attention in place of the kernels (``plain_attention``), on
# the same pairs, and the trained fixture's also against the CPU's.
RERANK_LOGIT_TOL = 2e-3
FFN_MEAN_TOL = 1e-4
FFN_ULP_SHARE_TOL = 0.01
# The int8 GEMM family (int8_gemm, int8_ffn_in, int8_ffn_out,
# int8_ffn_fused) against its plain versions on the card, in ulps of the
# output dtype (``ulp_errors``): both sides take exact int32 (float64)
# sums, the same f32 roundings and the same tanhf, and every kernel read 0
# ulps at every shape, dtype and planted input; the plain version's float64
# FMA rounds twice, which can move a result by one ulp.  An int8 code that
# moves shifts every output of its row by a weight step: ``int8_ffn_out``
# fed the bf16 h's row max, or a fused FFN quantizing the bf16 h, read mean
# 0.28-0.31 ulps and 1.7-2.4 % of outputs over one ulp (on the CPU,
# ``tests/test_torch_smoke_tools.py``).
INT8_MAX_ULPS = 1.0
INT8_MEAN_ULPS = 0.01
INT8_ULP_SHARE_TOL = 1e-3


SOURCES = {
    "flat_topk": ("tpu_search_torch/csrc/flat_topk.cu",
                  "tpu_search/ops/pallas_topk_dma.py:551"),
    "mpnet_attention": ("tpu_search_torch/csrc/mpnet_attention.cu",
                        "tpu_search/ops/pallas_mpnet_attention.py:165"),
    "int8_ffn_ln": ("tpu_search_torch/csrc/int8_ffn_ln.cu",
                    "tpu_search/ops/pallas_int8_gemm.py:417"),
    "flat_topk_int8": ("tpu_search_torch/csrc/flat_topk_int8.cu",
                       "tpu_search/ops/pallas_topk_dma.py:515 and :531"),
    "flat_topk_int4": ("tpu_search_torch/csrc/flat_topk_int4.cu",
                       "tpu_search/ops/pallas_topk_dma.py:358"),
    "ivf_topk": ("tpu_search_torch/csrc/ivf_topk.cu",
                 "tpu_search/ops/pallas_ivf_scan.py:213"),
    "ivf_topk_int8": ("tpu_search_torch/csrc/ivf_topk_int8.cu (body: "
                      "ivf_digit_scan.cuh, ivf_prep.cuh)",
                      "tpu_search/ops/pallas_ivf_scan.py:400"),
    "ivf_topk_int4": ("tpu_search_torch/csrc/ivf_topk_int4.cu (body: "
                      "ivf_digit_scan.cuh, ivf_prep.cuh)",
                      "tpu_search/ops/pallas_ivf_scan.py:632"),
    "mpnet_attention_bhsd": ("tpu_search_torch/csrc/mpnet_attention_bhsd.cu",
                             "tpu_search/ops/pallas_mpnet_attention.py:252"),
    "int8_gemm": ("tpu_search_torch/csrc/int8_gemm.cu",
                  "tpu_search/ops/pallas_int8_gemm.py:646"),
    "int8_ffn_in": ("tpu_search_torch/csrc/int8_ffn_ln.cu",
                    "tpu_search/ops/pallas_int8_gemm.py:158"),
    "int8_ffn_out": ("tpu_search_torch/csrc/int8_ffn_ln.cu",
                     "tpu_search/ops/pallas_int8_gemm.py:275"),
    "int8_ffn_fused": ("tpu_search_torch/csrc/int8_ffn_ln.cu",
                       "tpu_search/ops/pallas_int8_gemm.py:578"),
    "flash_attention": ("tpu_search_torch/csrc/flash_attention.cu",
                        "tpu_search/models/mpnet.py:262 (jax.experimental."
                        "pallas.ops.tpu.flash_attention)"),
    "int4_probe": ("tpu_search_torch/csrc/int4_probe.cu",
                   "benchmarks/int4_probe.py:199"),
    "scan_overhead_probe": ("tpu_search_torch/csrc/scan_overhead_probe.cu",
                            "benchmarks/scan_overhead_probe.py:136"),
    "mpnet_attention_f32": ("tpu_search_torch/csrc/mpnet_attention_f32.cu",
                            "none: the JAX package runs f32 attention "
                            "through its dense XLA graph, "
                            "tpu_search/models/mpnet.py:276-281"),
    "mpnet_attention_bwd": ("tpu_search_torch/csrc/mpnet_attention_bwd.cu",
                            "none: the JAX package trains through XLA's "
                            "differentiation of its dense attention, "
                            "tpu_search/models/mpnet.py:276-281"),
    "flash_attention_f32": ("tpu_search_torch/csrc/flash_attention_f32.cu",
                            "tpu_search/models/mpnet.py:262 at f32 compute "
                            "(jax.experimental.pallas.ops.tpu."
                            "flash_attention, pallas_call :758)"),
    "flash_attention_bwd": ("tpu_search_torch/csrc/flash_attention_bwd.cu",
                            "tpu_search/models/mpnet.py:262 under jax.grad "
                            "(jax.experimental.pallas.ops.tpu."
                            "flash_attention: _flash_attention_bwd_dkv :941, "
                            "pallas_call :1121; _flash_attention_bwd_dq "
                            ":1287, pallas_call :1456)"),
}
# The path whose run counts each kernel's launches ("rerank": the TinyBERT
# and the tiny-overlap rerank paths together).
PATH_OF = {"flat_topk": "bfloat16", "mpnet_attention": "bfloat16",
           "int8_ffn_ln": "bfloat16", "flat_topk_int8": "int8",
           "flat_topk_int4": "int4", "ivf_topk": "ivf_bfloat16",
           "ivf_topk_int8": "ivf_int8", "ivf_topk_int4": "ivf_int4",
           "mpnet_attention_bhsd": "rerank", "int8_gemm": "int8_bench",
           "int8_ffn_in": "int8_bench", "int8_ffn_out": "int8_bench",
           "int8_ffn_fused": "int8_bench", "flash_attention": "flash_encoder",
           "int4_probe": "probes", "scan_overhead_probe": "probes",
           "mpnet_attention_f32": "f32_encoder",
           "mpnet_attention_bwd": "train", "flash_attention_f32": "flash_grad",
           "flash_attention_bwd": "flash_grad"}
# The rerank paths: (tag, reranker, kernels it must launch).  All run on
# the all-MiniLM-L6-v2 index; the reranker sees top_k * factor candidates.
RERANK_PATHS = (
    ("rerank_minilm", "ms-marco-MiniLM-L-6-v2", ("mpnet_attention",)),
    ("rerank_tinybert", "ms-marco-TinyBERT-L-4", ("mpnet_attention_bhsd",)),
    ("rerank_fixture", "tiny-overlap", ("mpnet_attention_bhsd",)),
)
RERANK_TOP_K, RERANK_FACTOR = 10, 5
N_BERT_CONVERSATIONS = 200
# bf16 storage keeps 8 significant bits of each stored component: against
# a unit query, a stored unit row's score moves by less than 2^-8.
BF16_TIE = 2.0 ** -8
N_IVF_QUANT_CONVERSATIONS = 200
IVF_WARM_FILES = 10
# The H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): HBM
# bytes/s and tensor-core operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12,
                  "tf32": 495e12}
N_QUANT_CONVERSATIONS = 200
# The probes are drawn from the first PROBE_POOL chunk ids, which hold the
# same texts on every storage path (each indexes the same files first, the
# quantized paths about 3,400 chunks), so the three paths time the same
# queries.
PROBE_POOL = 3000
# A quantized row keeps each component to within half its scale step
# (int8: max|v| / 127, int4: max|v| / 7), uniformly: against a unit query
# its score moves with a standard deviation of scale / sqrt(12).  Two rows
# whose scores differ by less than QUANT_TIE_SIGMAS such deviations (of
# the difference) are a tie the tier cannot resolve.
QUANT_TIE_SIGMAS = 4.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int = 10):
    """Times in turns (plain, kernel, kernel, plain); means of each."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float, kind: str):
    """``(bound_ms, bound_by)``: the least time the card could take, the
    larger of the bytes over HBM bandwidth and the operations over the
    peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# Profiled windows in this run: how many, how many were profiled again for
# want of device events, and the most tries one took (printed at the end
# by ``print_profile_tries``, so a growing profiler flake shows).
PROFILE_TRIES = {"windows": 0, "profiled_again": 0, "most_tries": 0}


def print_profile_tries() -> None:
    print("[profile] " + " ".join(f"{k}={v}" for k, v in
                                  PROFILE_TRIES.items()), flush=True)


def profiled_events(tag: str, fn, calls: int):
    """The device events of ``calls`` calls of ``fn`` (torch.profiler) and
    the wall time a call.  A window in which the profiler recorded no
    device event (it happens now and then after many windows in one
    process, three windows in a row in one run) is profiled again, at
    most five times, each later window waiting a little longer after its
    calls before it closes; ``PROFILE_TRIES`` counts the tries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_search_torch.utils.device_profile import _device_events

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / calls
            time.sleep(0.1 * attempt)
        PROFILE_TRIES["most_tries"] = max(PROFILE_TRIES["most_tries"],
                                          attempt + 1)
        try:
            events = _device_events(prof)
        except RuntimeError:
            if attempt == 5:
                raise
            PROFILE_TRIES["profiled_again"] += 1
            print(f"[profile] {tag}: no device events, profiled again "
                  f"(try {attempt + 2} of 6)", flush=True)
            continue
        PROFILE_TRIES["windows"] += 1
        return events, wall


def device_breakdown(tag: str, fn, calls: int = 20):
    """Where one call of a scan wrapper spends the card's time: the device
    time per call of each kernel it launches (torch.profiler), against the
    wall time per call; the rest of the wall is the card waiting on the
    host's launches.  Returns ``(device busy ms, launches a call)``."""
    from tpu_search_torch.utils.device_profile import _by_kernel, busy_seconds

    events, wall = profiled_events(tag, fn, calls)
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in events) / calls
    kernels = _by_kernel(events)
    parts = [f"{short_kernel_name(name)}={ms / calls:.4f}"
             for name, ms, _ in kernels[:3]]
    rest = sum(ms for _, ms, _ in kernels[3:]) / calls
    print(f"[profile] {tag} wall_ms={wall * 1e3:.4f} "
          f"device_busy_ms={busy * 1e3:.4f} launches_per_call="
          f"{len(events) / calls:.1f} kernel_ms: {' '.join(parts)} "
          f"other={rest:.4f}", flush=True)
    return busy * 1e3, len(events) / calls


def check_launches(name: str, launches: float, most: float = 3.0) -> None:
    """A one-C-call scan makes its three launches (prologue, scan, merge)
    and no PyTorch kernel between them: at most ``most`` a call (the
    profiler may miss a window's first launch)."""
    if launches > most:
        fail(f"{name} made {launches:.1f} launches a call, more than {most}")


def short_kernel_name(name: str) -> str:
    """``void (anonymous namespace)::digit_partial<...>(...)`` ->
    ``digit_partial``."""
    head = re.split(r"[<(]", name.removeprefix("void ").replace(
        "(anonymous namespace)::", ""))[0]
    return head.split("::")[-1].strip().replace(" ", "_")


# -- phase 1: the build report of the kernels redesigned for Hopper ----------

# The kernels whose source's ptxas report (registers, spills) the build
# phase prints, and for each source the kernels (by name) whose SASS must
# multiply with wgmma (GMMA), and whether any mma.sync int8 product (IMMA)
# in the source fails the build: the int8 products must be wgmma's alone.
REDESIGNED = ("mpnet_attention", "mpnet_attention_bhsd", "int8_gemm",
              "int8_ffn_ln", "flash_attention", "flat_topk", "ivf_topk",
              "mpnet_attention_bwd", "mpnet_attention_f32", "ivf_topk_int8",
              "ivf_topk_int4", "flat_topk_int4", "flat_topk_int8",
              "int8_ffn_in", "int8_ffn_out", "int8_ffn_fused",
              "flash_attention_bwd", "flash_attention_f32")
SASS_RULES = {
    "mpnet_attention_bhsd": (("attention_bhsd_kernel",), False),
    "int8_gemm": (("gemm_kernel",), True),
    "int8_ffn_ln": (("ffn_gemm1", "ffn_gemm2", "ffn_out_cq"), True),
    "flash_attention": (("flash_kernel",), False),
    "flash_attention_bwd": (("rows_wgmma", "cols_wgmma", "rows_tf32",
                             "cols_tf32", "rows_pair", "cols_pair"), False),
    "flash_attention_f32": (("flash_tf32_fwd", "flash_pair_fwd"), False),
}
# Each redesigned kernel's ptxas report from the build: ``{"<source>
# <short name>": (registers, spill store bytes, spill load bytes)}``, for
# the phases that print them beside their times.
PTXAS: dict = {}


# The tensor-core row / column attention kernels (attention_tc.cuh; the
# flash mode's bf16 forward above hd 128 on it through flash_tc.cuh):
# every product is an mma.sync (bf16, or 3xTF32 in f32), so each kernel
# named here must hold HMMA instructions.  (The flash mode's f32 kernels
# multiply with tf32 wgmma: SASS_RULES.)
HMMA_SASS_RULES = {
    "mpnet_attention_bwd": ("bwd_rows", "bwd_cols"),
    "mpnet_attention_f32": ("attention_f32_tc",),
    "flash_attention": ("flash_wide_kernel",),
}


# The ring-fed scans, by demangled kernel name: the digit scans (bodies in
# csrc/ivf_digit_scan.cuh; the IVF int8 / int4 scans, and the flat int4
# and int8 row scans at Q > 8) multiply with wgmma (GMMA) at Q > 8 and with
# mma.sync (IMMA) at Q <= 8 (the flat scans there: digit_partial, which
# the int8 word layout also runs above); the bf16 IVF and flat scans
# (csrc/ivf_float_scan.cuh) with wgmma at their query block of 32 and with
# mma.sync (HMMA) at 16.
DIGIT_SASS_RULES = {
    name: {"GMMA": (f"ivf_digit_scan<{tiles}, 32, IvfSource>",),
           "IMMA": (f"ivf_digit_scan<{tiles}, 8, IvfSource>",)}
    for name, tiles in (("ivf_topk_int8", "RowTiles"),
                        ("ivf_topk_int4", "NibbleTiles"))
}
DIGIT_SASS_RULES["flat_topk_int4"] = {
    "GMMA": ("ivf_digit_scan<NibbleTiles, 32, FlatSource>",),
    "IMMA": ("digit_partial<NibbleStage, 8>",)}
DIGIT_SASS_RULES["flat_topk_int8"] = {
    "GMMA": ("ivf_digit_scan<RowTiles, 32, FlatSource>",),
    "IMMA": ("digit_partial<RowStage, 8>", "digit_partial<WordStage, 8>",
             "digit_partial<WordStage, 32>")}
DIGIT_SASS_RULES["ivf_topk"] = {
    "GMMA": ("ivf_float_scan<Bf16Rows, 32, IvfSource>",),
    "HMMA": ("ivf_float_scan<Bf16Rows, 16, IvfSource>",)}
DIGIT_SASS_RULES["flat_topk"] = {
    "GMMA": ("ivf_float_scan<Bf16Rows, 32, FlatSource>",),
    "HMMA": ("ivf_float_scan<Bf16Rows, 16, FlatSource>",)}
MMA_KINDS = ("GMMA", "IMMA", "HMMA")


def mma_faults(counts: dict, wanted: dict) -> list:
    """What breaks a ring scan's rule: a kernel named in ``wanted[kind]``
    (a part of its short name) that is missing or holds no instruction of
    that kind (``GMMA`` / ``IMMA`` / ``HMMA``); ``counts`` by short name."""
    faults = []
    for kind, parts in wanted.items():
        column = MMA_KINDS.index(kind)
        for part in parts:
            hits = {n: c for n, c in counts.items() if part in n}
            if not hits:
                faults.append(f"no kernel named {part}")
            faults += [f"{n} holds no {kind}" for n, c in hits.items()
                       if not c[column]]
    return faults


def ptxas_entries(log: str) -> list:
    """``(kernel, registers, spill store bytes, spill load bytes)`` of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    entries, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name, spills = found.group(1), (0, 0)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found:
            spills = (int(found.group(1)), int(found.group(2)))
            continue
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            entries.append((name, int(found.group(1)), *spills))
            name = None
    return entries


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program: on PATH or beside ``nvcc``."""
    from tpu_search_torch.ops import _build

    return shutil.which(name) or str(Path(_build._nvcc()).parent / name)


def demangle(names: list) -> list:
    try:
        out = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names


def sass_counts(sass: str) -> dict:
    """``{function: (GMMA count, IMMA count, HMMA count)}`` of a
    ``cuobjdump -sass`` listing, by the mangled name of each ``Function :``
    section."""
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = (0, 0, 0)
        elif name is not None:
            gmma, imma, hmma = counts[name]
            counts[name] = (gmma + len(re.findall(r"\b[A-Z]*GMMA\.", line)),
                            imma + len(re.findall(r"\bIMMA\.", line)),
                            hmma + len(re.findall(r"\bHMMA\.", line)))
    return counts


def sass_faults(counts: dict, wanted: tuple, no_imma: bool) -> list:
    """What breaks a source's SASS rule: a kernel named in ``wanted`` that
    is missing or holds no GMMA, or (``no_imma``) any IMMA at all."""
    faults = []
    for part in wanted:
        hits = {n: c for n, c in counts.items() if part in n}
        if not hits:
            faults.append(f"no kernel named {part}")
        faults += [f"{n} holds no GMMA" for n, (g, *_) in hits.items()
                   if not g]
    imma = sum(c[1] for c in counts.values())
    if no_imma and imma:
        faults.append(f"{imma} IMMA instructions")
    return faults


def short_name(kernel: str) -> str:
    """``void <unnamed>::k<(int)64, true>(...)`` -> ``k<64, true>``."""
    return re.sub(r"\((?:int|bool)\)|^void |(?:<unnamed>|"
                  r"\(anonymous namespace\))::", "", kernel).split("(")[0]


def library_of(name: str) -> str:
    """The source (library) of kernel ``name``: its own, but the int8 FFN's
    pieces are exports of ``int8_ffn_ln.cu``."""
    from tpu_search_torch.ops.int8_gemm import _LIBRARY

    return _LIBRARY.get(name, name)


def check_build(logs: dict) -> None:
    """Print registers and spills of the redesigned kernels, and fail
    unless their SASS keeps ``SASS_RULES``, ``HMMA_SASS_RULES`` and
    ``DIGIT_SASS_RULES``."""
    from tpu_search_torch.ops import _build

    for name in dict.fromkeys(library_of(n) for n in REDESIGNED):
        entries = ptxas_entries(logs.get(name, ""))
        if not entries:
            print(f"[build] ptxas {name}: not compiled in this run", flush=True)
        for (_, regs, stores, loads), kernel in zip(
                entries, demangle([e[0] for e in entries])):
            PTXAS[f"{name} {short_name(kernel)}"] = (regs, stores, loads)
            print(f"[build] ptxas {name} {short_name(kernel)} "
                  f"registers={regs} spill_stores={stores} "
                  f"spill_loads={loads}", flush=True)
    def sass_of(name: str) -> dict:
        return sass_counts(subprocess.run(
            [cuda_tool("cuobjdump"), "-sass", str(_build._target(name))],
            capture_output=True, text=True, check=True).stdout)

    for name, (wanted, no_imma) in SASS_RULES.items():
        counts = sass_of(name)
        names = demangle(list(counts))
        for (gmma, imma, _), kernel in zip(counts.values(), names):
            print(f"[build] sass {name} {short_name(kernel)} "
                  f"gmma_instructions={gmma} imma_instructions={imma}",
                  flush=True)
        faults = sass_faults(counts, wanted, no_imma)
        if faults:
            fail(f"{name}'s SASS breaks its rule: {'; '.join(faults)}")
    for name, wanted in HMMA_SASS_RULES.items():
        counts = sass_of(name)
        for (_, _, hmma), kernel in zip(counts.values(),
                                        demangle(list(counts))):
            print(f"[build] sass {name} {short_name(kernel)} "
                  f"hmma_instructions={hmma}", flush=True)
        faults = [f"no kernel named {part}" for part in wanted
                  if not any(part in n for n in counts)]
        faults += [f"{n} holds no HMMA" for n, (_, _, hmma) in counts.items()
                   if hmma == 0 and any(part in n for part in wanted)]
        if faults:
            fail(f"{name}'s SASS breaks its rule: {'; '.join(faults)}")
    for name, wanted in DIGIT_SASS_RULES.items():
        counts = sass_of(name)
        by_name = {short_name(kernel): c for kernel, c in
                   zip(demangle(list(counts)), counts.values())}
        for kernel, (gmma, imma, hmma) in by_name.items():
            print(f"[build] sass {name} {kernel} gmma_instructions={gmma} "
                  f"imma_instructions={imma} hmma_instructions={hmma}",
                  flush=True)
        faults = mma_faults(by_name, wanted)
        if faults:
            fail(f"{name}'s SASS breaks its rule: {'; '.join(faults)}")


# -- phase 2: kernels against their plain versions ---------------------------


def flat_bound(n: int, d: int, q: int, k: int, bf16: bool = True):
    """The flat bf16 / f32 scan's bound: the rows and penalties, the f32
    queries read once and the top k written, against its products."""
    return bound(n * (d * (2 if bf16 else 4) + 4) + q * d * 4 + q * k * 8,
                 2 * q * n * d, "bf16" if bf16 else "f32")


def unit_rows(gen, n: int, d: int):
    import torch

    v = torch.randn((n, d), generator=gen, device=gen.device)
    return v / v.norm(dim=1, keepdim=True)


def check_flat_case(tag: str, vecs, penalty, queries, k: int, alpha: float,
                    iters: int = 20):
    """The flat scan against its plain version on one case (scores within
    the tolerance, ids equal outside ties of it, every id scoring what the
    kernel says, no masked row), then both timed in turns.  Returns
    ``(max error, kernel ms, plain ms)``."""
    import torch

    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.topk_scan import flat_topk_plain

    tol = TOL["flat_topk"]
    ks, ki = flat_topk_scan(vecs, penalty, queries, k, alpha)
    ps, pi = flat_topk_plain(vecs, penalty, queries, k, alpha)
    torch.cuda.synchronize()
    err = float((ks - ps).abs().max())
    # ids: every kernel id must score what the kernel says it does
    full = alpha * (queries.to(vecs.dtype).float() @ vecs.float().T)
    got = (full - penalty[None, :]).gather(1, ki.long().clamp(min=0))
    id_err = float((got - ks).abs().max())
    if not bool(torch.isfinite(penalty[ki.long()]).all()):
        fail(f"flat_topk returned a masked row ({tag})")
    tie_ok = bool(((ki == pi) | ((ks - ps).abs() <= tol)).all())
    kms, pms = paired_ms(
        lambda: flat_topk_scan(vecs, penalty, queries, k, alpha),
        lambda: flat_topk_plain(vecs, penalty, queries, k, alpha),
        iters=iters)
    print(f"[flat_topk] {tag} max_abs_err={err:.3e} id_score_err={id_err:.3e} "
          f"id_agreement={float((ki == pi).float().mean()):.6f} "
          f"kernel_ms={kms:.4f} plain_ms={pms:.4f}", flush=True)
    if ks.shape != (queries.shape[0], k) or max(err, id_err) > tol \
            or not tie_ok:
        fail(f"flat_topk disagrees at {tag}")
    return max(err, id_err), kms, pms


def check_flat_topk(results: dict) -> None:
    """The flat bf16 / f32 scan against its plain version: at the fused
    path's shape (the smoke index's capacity, 32,768 x 768 bf16, its
    17,024 live rows and the +inf tail, Q 8 and 32, k 10), at 1M x 768
    (10 % masked; Q 1, 8, 128; k 10, 128, and the scores mode above), on
    the v1 cases; its prologue against its plain twin; at k <= 128 at most
    three launches a call."""
    import torch

    from tpu_search_torch.ops.flat_topk import (
        flat_float_prep,
        flat_float_prep_plain,
        flat_topk_scan,
    )
    from tpu_search_torch.ops.topk_scan import row_penalty

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    print_scan_config("flat_topk")
    d, worst = 768, 0.0
    for q in (1, 8, 33):
        queries = unit_rows(gen, q, d)
        for bf16 in (True, False):
            got, want = flat_float_prep(queries, bf16), \
                flat_float_prep_plain(queries, bf16)
            torch.cuda.synchronize()
            equal = all(torch.equal(got[key], want[key]) if bf16 or
                        key != "qcast" else got[key] is None for key in want)
            print(f"[flat_prep] float bf16={bf16} Q={q} equal={equal}",
                  flush=True)
            if not equal:
                fail("the flat float prologue differs from its plain twin")

    # The fused path's shape: the capacity scanned whole, dead slots +inf.
    cap, live = 32_768, 17_024
    vecs = unit_rows(gen, cap, d).to(torch.bfloat16)
    penalty = torch.full((cap,), float("inf"), device=dev)
    penalty[:live] = 0.0
    fused = {}
    for q in (8, 32):
        queries = unit_rows(gen, q, d)
        err, kms, pms = check_flat_case(
            f"fused N={cap} live={live} D={d} Q={q} k=10", vecs, penalty,
            queries, 10, 1.0, iters=50)
        worst = max(worst, err)
        dms, calls = device_breakdown(
            f"flat_topk fused N={cap} Q={q} k=10",
            lambda: flat_topk_scan(vecs, penalty, queries, 10))
        check_launches("flat_topk", calls)
        bound_ms, by = flat_bound(cap, d, q, 10)
        print(f"[flat_topk] fused N={cap} Q={q} k=10 device_ms_a_call="
              f"{dms:.4f} launches_a_call={calls:.1f} bound_ms={bound_ms:.4f} "
              f"({by}) wrapper_ms={kms:.4f}", flush=True)
        fused[f"Q{q}"] = {"ms": kms, "plain_ms": pms, "device_ms": dms,
                          "launches_a_call": calls, "bound_ms": bound_ms}
    del vecs, penalty

    n = 1_000_000
    vecs = unit_rows(gen, n, d).to(torch.bfloat16)
    mask = torch.rand((n,), generator=gen, device=dev) >= 0.10
    penalty, alpha = row_penalty(mask, "ip")
    for q in (1, 8, 128):
        queries = unit_rows(gen, q, d)
        for k in (10, 128):
            err, kms, pms = check_flat_case(f"N={n} D={d} Q={q} k={k}", vecs,
                                            penalty, queries, k, alpha)
            worst = max(worst, err)
            _, calls = device_breakdown(
                f"flat_topk N={n} Q={q} k={k}",
                lambda: flat_topk_scan(vecs, penalty, queries, k, alpha))
            check_launches("flat_topk", calls)
            if q == 1 and k == 10:
                bound_ms, by = flat_bound(n, d, q, k)
                # no single PyTorch call masks, scores and selects
                results["flat_topk"] = {"ms": kms, "plain_ms": pms,
                                        "bound_ms": bound_ms, "bound_by": by,
                                        "library_ms": None, "fused": fused}
    # k > 128: the scores-only mode, then a stable sort.
    for q, k in ((1, 200), (1, 1000), (8, 1000)):
        queries = unit_rows(gen, q, d)
        err, _, _ = check_flat_case(f"N={n} D={d} Q={q} k={k} (scores mode)",
                                    vecs, penalty, queries, k, alpha, iters=5)
        worst = max(worst, err)
    del vecs
    worst = max(worst, check_v1_cases())
    results["flat_topk"]["max_abs_err"] = worst


def v1_scan_inputs(case: str, dtype: str, q: int, device):
    """The numpy inputs of ``tests/test_pallas_topk.py`` (same seeds,
    shapes, masks and k) as ``(vectors, penalty 0 / +inf, queries, k)``
    tensors for ``flat_topk_scan``: ``matches`` is ``test_matches_xla_path``,
    ``masked_tile`` ``test_all_masked_tile_handled``."""
    import numpy as np
    import torch

    def normed(rng, n, d):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    if case == "matches":
        rng = np.random.default_rng(0)
        n, d, k = 4096, 128, 10
        vecs = normed(rng, n, d)
        mask = rng.random(n) < 0.6
    elif case == "masked_tile":
        rng = np.random.default_rng(1)
        n, d, k = 2048, 128, 5
        vecs = normed(rng, n, d)
        mask = np.ones(n, dtype=bool)
        mask[1024:] = False
    else:
        raise ValueError(case)
    queries = normed(rng, q, d)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pen = np.where(mask, 0.0, np.inf).astype(np.float32)
    return (torch.from_numpy(vecs).to(device=device, dtype=tdtype),
            torch.from_numpy(pen).to(device),
            torch.from_numpy(queries).to(device), k)


def check_v1_cases() -> float:
    """``flat_topk.cu`` on the cases of ``tests/test_pallas_topk.py``
    (the v1 ``pallas_flat_topk``'s tests) against the plain version."""
    import torch

    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.topk_scan import flat_topk_plain

    dev = torch.device("cuda")
    worst, same = 0.0, True
    for dtype in ("float32", "bfloat16"):
        for q in (8, 16):
            vecs, pen, queries, k = v1_scan_inputs("matches", dtype, q, dev)
            ks, ki = flat_topk_scan(vecs, pen, queries, k)
            ps, pi = flat_topk_plain(vecs, pen, queries, k)
            worst = max(worst, float((ks - ps).abs().max()))
            same = same and bool(torch.equal(ki, pi))
    vecs, pen, queries, k = v1_scan_inputs("masked_tile", "float32", 8, dev)
    _, ki = flat_topk_scan(vecs, pen, queries, k)
    masked_ok = bool(((ki >= 0) & (ki < 1024)).all())
    torch.cuda.synchronize()
    print(f"[flat_topk] v1 cases of tests/test_pallas_topk.py: "
          f"max_abs_err={worst:.3e} ids_equal={same} "
          f"masked_tile_ok={masked_ok}", flush=True)
    if worst > 1e-5 or not same or not masked_ok:
        fail("flat_topk disagrees on the v1 scan cases")
    return worst


def check_flat_prep(queries) -> None:
    """The flat int4 and int8 scans' prologue kernels against their plain
    twins on the same queries: digits, rho, qs1 and (int4) nibble offsets
    equal, bit for bit."""
    import torch

    from tpu_search_torch.ops.flat_topk_int4 import (
        flat_digit_prep,
        flat_digit_prep_plain,
    )
    from tpu_search_torch.ops.flat_topk_int8 import (
        flat_int8_prep,
        flat_int8_prep_plain,
    )

    twins = (("int4", flat_digit_prep, flat_digit_prep_plain),
             ("int8", flat_int8_prep, flat_int8_prep_plain))
    for tag, kernel, plain in twins:
        got, want = kernel(queries), plain(queries)
        torch.cuda.synchronize()
        bad = [key for key, value in want.items()
               if not torch.equal(got[key], value)]
        print(f"[flat_prep] {tag} Q={queries.shape[0]} equal={not bad}",
              flush=True)
        if bad:
            fail(f"the flat {tag} prologue differs from its plain twin in "
                 f"{bad}")


def check_quant_topk(results: dict) -> None:
    """The int8 scan (rows and words) and the int4 scan at the main path's
    shapes: 1M unit rows x 768 quantized by the index's quantizers, 10 %
    masked, against their plain versions (gate 0)."""
    import torch

    from tpu_search_torch.index.flat import quantize_rows_int8
    from tpu_search_torch.ops.flat_topk_int4 import flat_topk_int4_scan
    from tpu_search_torch.ops.flat_topk_int8 import flat_topk_int8_scan
    from tpu_search_torch.ops.int4_pack import (
        nibble_rows_to_bytes,
        quantize_rows_int4,
    )
    from tpu_search_torch.ops.int8_pack import pack_int8_rows
    from tpu_search_torch.ops.topk_scan import (
        flat_topk_int4_plain,
        flat_topk_int8_plain,
        quantize_queries,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    n, d = 1_000_000, 768
    v = torch.randn((n, d), generator=gen, device=dev)
    v = v / v.norm(dim=1, keepdim=True)
    # The quantizers give the CPU's bits (held there against the JAX
    # package's) on the card too.
    sample = v[:4096]
    for fn in (quantize_rows_int8, quantize_rows_int4, quantize_queries):
        for a, b in zip(fn(sample), fn(sample.cpu())):
            if not torch.equal(a.cpu(), b):
                fail(f"{fn.__name__} on the card differs from the CPU")
    print("[quantizers] int8 rows, int4 rows, query digits: "
          "cuda == cpu bit for bit", flush=True)
    rows, scales = quantize_rows_int8(v)
    words = pack_int8_rows(rows)
    u, scales4 = quantize_rows_int4(v)
    nib = nibble_rows_to_bytes(u)
    del v, u
    live = torch.rand((n,), generator=gen, device=dev) >= 0.10
    pen = torch.where(live, 0.0, float("-inf"))
    cases = {
        "flat_topk_int8 rows": (
            "flat_topk_int8",
            lambda qs, k: flat_topk_int8_scan(rows, scales, pen, qs, k),
            lambda qs, k: flat_topk_int8_plain(rows, scales, pen, qs, k)),
        "flat_topk_int8 words": (
            "flat_topk_int8",
            lambda qs, k: flat_topk_int8_scan(words, scales, pen, qs, k,
                                              words=True),
            lambda qs, k: flat_topk_int8_plain(rows, scales, pen, qs, k)),
        "flat_topk_int4": (
            "flat_topk_int4",
            lambda qs, k: flat_topk_int4_scan(nib, scales4, pen, qs, k),
            lambda qs, k: flat_topk_int4_plain(nib, scales4, pen, qs, k)),
    }
    for q in (1, 8, 128):
        queries = torch.randn((q, d), generator=gen, device=dev)
        queries = queries / queries.norm(dim=1, keepdim=True)
        check_flat_prep(queries)
        for k in (10, 128, 200):
            for tag, (name, kernel, plain) in cases.items():
                if k > 128 and q > 8:
                    continue  # the scores mode: one query block is enough
                ks, ki = kernel(queries, k)
                ps, pi = plain(queries, k)
                torch.cuda.synchronize()
                fin = torch.isfinite(ps)
                same_fin = bool(torch.equal(torch.isfinite(ks), fin))
                err = (float((ks[fin] - ps[fin]).abs().max())
                       if same_fin else float("inf"))
                agree = float((ki == pi).float().mean())
                if not bool(live[ki[ki >= 0].long()].all()):
                    fail(f"{tag} returned a masked row")
                kms, pms = paired_ms(lambda: kernel(queries, k),
                                     lambda: plain(queries, k), iters=20)
                print(f"[{tag}] N={n} D={d} Q={q} k={k} max_abs_err={err:.3e} "
                      f"id_agreement={agree:.6f} kernel_ms={kms:.4f} "
                      f"plain_ms={pms:.4f}", flush=True)
                if err > TOL[name] or agree < 1.0:
                    fail(f"{tag} disagrees with its plain version at "
                         f"Q={q} k={k}")
                entry = results.setdefault(name, {"max_abs_err": 0.0})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                if q == 1 and k <= 128:
                    # the device split a launch, at k 10 and k 128
                    _, calls = device_breakdown(f"{tag} N={n} Q=1 k={k}",
                                                lambda: kernel(queries, k))
                    check_launches(tag, calls)
                if q == 1 and k == 10:
                    row_bytes = d if name == "flat_topk_int8" else d // 2
                    bound_ms, by = bound(
                        n * (row_bytes + 8) + 2 * q * d + q * k * 8,
                        4 * q * n * d, "int8")
                    # the word layout's numbers ride in the entry's "words"
                    timed = (entry.setdefault("words", {})
                             if tag == "flat_topk_int8 words" else entry)
                    timed.update(ms=kms, plain_ms=pms, bound_ms=bound_ms,
                                 bound_by=by, library_ms=None)


def attention_inputs(gen, shape, nh, s, dev):
    """Random bf16 q, k, v of ``shape``, a ``[nh, S, S]`` bias, and a key
    mask with random lengths (row 0 full) and row 1 fully padded."""
    import torch

    b = shape[0]
    neg = torch.finfo(torch.float32).min
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    bias = 0.5 * torch.randn((nh, s, s), generator=gen, device=dev)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    lengths[0] = s
    live = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    mask = (1.0 - live.float()) * neg
    mask[1] = neg  # one fully padded row: the no-NaN guard
    return q, k, v, bias, mask.contiguous()


def check_attention(results: dict) -> None:
    """The ``[B, S, H]`` kernel at all-mpnet-base-v2's width for every
    embedder bucket, and at the MiniLM reranker's (H 384) at S 512: errors,
    kernel, plain and SDPA times, the bound, and the kernel's shared memory
    (the same at every S: its scores stay in registers)."""
    import torch

    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention,
        mpnet_attention_plain,
        mpnet_attention_smem_bytes,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    b, nh = 128, 12
    worst = 0.0
    for h, s in ((768, 64), (768, 128), (768, 256), (768, 384), (384, 512)):
        q, k, v, bias, mask = attention_inputs(gen, (b, s, h), nh, s, dev)
        scale = 1.0 / math.sqrt(h // nh)
        out = mpnet_attention(q, k, v, bias, mask, nh, scale)
        ref = mpnet_attention_plain(q, k, v, bias, mask, nh, scale)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            fail("mpnet_attention produced non-finite values")
        errors = bf16_errors(out, ref)
        kms, pms = paired_ms(
            lambda: mpnet_attention(q, k, v, bias, mask, nh, scale),
            lambda: mpnet_attention_plain(q, k, v, bias, mask, nh, scale),
        )
        lib = sdpa_ms(heads_of(q, nh), heads_of(k, nh), heads_of(v, nh),
                      bias, mask, scale)
        bound_ms, by = bound(4 * b * s * h * 2 + nh * s * s * 4 + b * s * 4,
                             4 * b * s * s * h, "bf16")
        print(f"[mpnet_attention] B={b} S={s} H={h} heads={nh} "
              f"{format_errors(errors)} kernel_ms={kms:.4f} "
              f"plain_ms={pms:.4f} sdpa_ms={lib:.4f} bound_ms={bound_ms:.4f} "
              f"smem_bytes={mpnet_attention_smem_bytes(h, nh)}", flush=True)
        if not attention_ok(errors, "mpnet_attention"):
            fail(f"mpnet_attention disagrees at S={s} H={h}")
        worst = max(worst, errors["max_abs_err"])
        if (h, s) == (768, 384):
            results["mpnet_attention"] = {
                "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": lib}
        del q, k, v, bias, mask, out, ref
    results["mpnet_attention"]["max_abs_err"] = worst


def heads_of(t, nh):
    """``[B, S, H]`` -> contiguous ``[B, nh, S, H / nh]``."""
    b, s, h = t.shape
    return t.reshape(b, s, nh, h // nh).transpose(1, 2).contiguous()


def check_attention_bhsd(results: dict) -> None:
    """The ``[B, heads, S, hd]`` kernel at B 128 over the reranker's
    buckets, at the TinyBERT-L-4 cross-encoder's width (H 312, 12 heads of
    26: padded head columns) and the tiny-overlap reranker's (H 64, 2 heads
    of 32), with its shared memory and CTAs a multiprocessor (the same at
    every S: its scores stay in registers)."""
    import torch

    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention_bhsd,
        mpnet_attention_bhsd_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    b, worst = 128, 0.0
    for h, nh in ((312, 12), (64, 2)):
        hd = h // nh
        for s in (64, 128, 256, 384, 512):
            q, k, v, bias, mask = attention_inputs(gen, (b, nh, s, hd), nh, s,
                                                   dev)
            scale = 1.0 / math.sqrt(hd)

            def kernel():
                return mpnet_attention_bhsd(q, k, v, bias, mask, scale)

            def plain():
                return mpnet_attention_bhsd_plain(q, k, v, bias, mask, scale)

            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out.float()).all()):
                fail(f"mpnet_attention_bhsd produced non-finite values at "
                     f"S={s} H={h}")
            errors = bf16_errors(out, ref)
            kms, pms = paired_ms(kernel, plain)
            lib = sdpa_ms(q, k, v, bias, mask, scale)
            print(f"[mpnet_attention_bhsd] B={b} S={s} H={h} heads={nh} "
                  f"hd={hd} {format_errors(errors)} kernel_ms={kms:.4f} "
                  f"plain_ms={pms:.4f} sdpa_ms={lib:.4f} "
                  f"{occupancy('mpnet_attention_bhsd', hd)}", flush=True)
            if not attention_ok(errors, "mpnet_attention_bhsd"):
                fail(f"mpnet_attention_bhsd disagrees at S={s} H={h}")
            worst = max(worst, errors["max_abs_err"])
            if (h, s) == (312, 512):
                # q, k, v read and out written once, the shared bias and
                # the mask read once; QK^T and PV at the unpadded hd
                bound_ms, by = bound(
                    4 * b * s * h * 2 + nh * s * s * 4 + b * s * 4,
                    4 * b * nh * s * s * hd, "bf16")
                results["mpnet_attention_bhsd"] = {
                    "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib}
            del q, k, v, bias, mask, out, ref
    results["mpnet_attention_bhsd"]["max_abs_err"] = worst


# The flash mode's shapes (B, S, H, heads): all-mpnet-base-v2's indexing
# wave, the MiniLM cross-encoder's rerank bucket, TinyBERT-312's (hd 26).
FLASH_SHAPES = ((128, 384, 768, 12), (128, 512, 384, 12), (128, 512, 312, 12))
# Head sizes above 128, as the stock kernel takes them, at a small B: hd
# 160 (S 128 only: above 128 a head size must be a multiple of 128 at S >
# 128), hd 256 and hd 384 (above 256: the score products over head
# chunks).
FLASH_WIDE_SHAPES = ((16, 128, 320, 2), (16, 256, 512, 2), (16, 256, 768, 2))


def flash_inputs(gen, b, s, h, nh, dev):
    """bf16 q, k, v ``[B, heads, S, hd]``, a bf16 bias of trained scale
    (N(0, 4)) ``[heads, S, S]``, and segment ids with a padded tail in
    every batch row but row 0 (lengths from 1 to S)."""
    import torch

    hd = h // nh
    q, k, v = (torch.randn((b, nh, s, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ab = (2.0 * torch.randn((nh, s, s), generator=gen, device=dev)).to(
        torch.bfloat16)
    lengths = torch.randint(1, s, (b,), generator=gen, device=dev)
    lengths[0] = s
    seg = (torch.arange(s, device=dev)[None, :] < lengths[:, None]).to(
        torch.int32).contiguous()
    return q, k, v, ab, seg


def flash_sdpa_ms(q, k, v, ab, seg, scale) -> float:
    """The flash mode's function through ``F.scaled_dot_product_attention``
    (a yardstick only: the port never calls it): ``attn_mask = ab * scale
    + segment mask``, built in q's dtype outside the timed call, so that
    ``q k^T * scale + mask = (q k^T + ab) * scale`` on the live pairs."""
    import torch
    import torch.nn.functional as F

    same = seg[:, None, :, None] == seg[:, None, None, :]
    add = torch.where(same, (ab.float() * scale)[None], -1e30).to(q.dtype)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=add, scale=scale))


def occupancy(name: str, hd: int) -> str:
    """The dynamic shared memory and CTAs a multiprocessor of attention
    kernel ``name`` (``flash_attention`` or ``mpnet_attention_bhsd``) at
    head size ``hd``, from its ``<name>_occupancy`` export."""
    import ctypes

    from tpu_search_torch.ops import _build

    fn = getattr(_build.library(name), f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    nbytes = ctypes.c_int(0)
    ctas = fn(hd, ctypes.byref(nbytes))
    if ctas <= 0:
        fail(f"{name} cannot run at hd={hd}: code {-ctas}")
    return f"smem_bytes={nbytes.value} ctas_per_sm={ctas}"


def check_flash_attention(results: dict) -> None:
    """The stock-flash kernel against its plain version at the three
    ``FLASH_SHAPES`` and the ``FLASH_WIDE_SHAPES``, with padded rows
    and a trained-scale bias."""
    import torch

    from tpu_search_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = 0.0
    for b, s, h, nh in FLASH_SHAPES + FLASH_WIDE_SHAPES:
        hd = h // nh
        q, k, v, ab, seg = flash_inputs(gen, b, s, h, nh, dev)
        scale = 1.0 / math.sqrt(hd)

        def kernel():
            return flash_attention(q, k, v, ab, seg, seg, scale)

        def plain():
            return flash_attention_plain(q, k, v, ab, seg, seg, scale)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            fail(f"flash_attention produced non-finite values at S={s} H={h}")
        errors = bf16_errors(out, ref)
        kms, pms = paired_ms(kernel, plain)
        lib = flash_sdpa_ms(q, k, v, ab, seg, scale)
        # q, k, v read and out written once, the shared bias and the
        # segment ids read once; QK^T and PV at the unpadded hd
        bound_ms, by = bound(4 * b * s * h * 2 + nh * s * s * 2 + 2 * b * s * 4,
                             4 * b * nh * s * s * hd, "bf16")
        print(f"[flash_attention] B={b} S={s} H={h} heads={nh} hd={hd} "
              f"{format_errors(errors)} kernel_ms={kms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={bound_ms:.4f} ({by}) "
              f"sdpa_ms={lib:.4f} {occupancy('flash_attention', hd)}",
              flush=True)
        if not attention_ok(errors, "flash_attention"):
            fail(f"flash_attention disagrees at S={s} H={h}")
        worst = max(worst, errors["max_abs_err"])
        if (s, h) == FLASH_SHAPES[0][1:3]:
            results["flash_attention"] = {
                "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": lib}
        del q, k, v, ab, seg, out, ref
    results["flash_attention"]["max_abs_err"] = worst


def flash_sdpa_grad_ms(q, k, v, ab, seg, grad, scale) -> float:
    """The flash mode's forward and backward through SDPA (a yardstick
    only: the port never calls it): ``attn_mask = ab * scale + segment
    mask`` of q's dtype, ``[B, heads, S, S]``, requiring grad as ``ab``
    does on the path, built outside the timed call."""
    import torch
    import torch.nn.functional as F

    same = seg[:, None, :, None] == seg[:, None, None, :]
    add = torch.where(same, (ab.float() * scale)[None], -1e30).to(q.dtype)
    add = add.contiguous().requires_grad_()
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def call():
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=add,
                                             scale=scale)
        out.backward(grad)

    return cuda_ms(call, 5)


# The flash backward (``flash_attention_bwd.cu``) against its plain version
# (``flash_attention_bwd_plain``) on the card, each output's max |error|
# over its largest |value|: the same f32 arithmetic at the same rounding
# sites (p and dS rounded to the compute dtype before the products), sums
# in another order.  f32: ``ATTN_GRAD_F32_TOL``.  bf16 (dQ, dK, dV and
# dab all bf16): ``ATTN_GRAD_BF16_TOL`` and at most ``ATTN_GRAD_ULP_SHARE``
# of entries more than one bf16 ulp off (an f32 value, or a dS, that
# rounds to bf16 one ulp apart).
def flash_bwd_errors(got, want, dtype: str) -> dict:
    errors = rel_errors(got, want)
    if dtype == "bfloat16":
        errors["over_1ulp_share"] = bf16_ulp_share(got, want)
    return errors


def flash_bwd_ok(errors: dict, dtype: str) -> bool:
    if dtype == "float32":
        return errors["max_rel_err"] <= ATTN_GRAD_F32_TOL
    return (errors["max_rel_err"] <= ATTN_GRAD_BF16_TOL
            and errors["over_1ulp_share"] <= ATTN_GRAD_ULP_SHARE)


def bwd_kernels(hd: int, bf16: bool) -> tuple:
    """The flash backward's row- and column-pass kernels at head size
    ``hd`` (their ptxas names): bf16 up to a row of 256 (hd rounded up to
    8) ``rows_wgmma`` / ``cols_wgmma`` at the width their templates round
    it up to; f32, and bf16 above, the tf32 passes: up to hd 64 in f32
    the two-warpgroup rows_pair and cols_pair."""
    ld = -(-hd // 8) * 8
    if bf16 and ld <= 256:
        width = next(w for w in (32, 64, 128, 256) if ld <= w)
        return f"rows_wgmma<{width}, 1>", f"cols_wgmma<{width}>"
    kind = "__nv_bfloat16" if bf16 else "float"
    blocks = -(-hd // 32)
    if not bf16 and blocks <= 2:  # two warpgroups a CTA
        return f"rows_pair<{blocks}>", f"cols_pair<{blocks}>"
    return f"rows_tf32<{kind}>", f"cols_tf32<{kind}>"


def bwd_occupancy(hd: int, s: int, b: int, nh: int, bf16: bool) -> str:
    """The dynamic shared memory, CTAs a multiprocessor, registers and
    spill bytes (ptxas, from the build) of the flash backward's row and
    column passes at head size ``hd``, sequence length ``s``, batch ``b``
    and ``nh`` heads (the row pass's tile of the bias's gradient grows with
    its keys: s in bf16, the plan's key split in the tf32 passes)."""
    import ctypes

    from tpu_search_torch.ops import _build

    fn = _build.library("flash_attention_bwd").flash_attention_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    parts = []
    for pass_, name in ((0, "rows"), (1, "cols")):
        nbytes = ctypes.c_int(0)
        ctas = fn(hd, s, b, nh, int(bf16), pass_, ctypes.byref(nbytes))
        if ctas <= 0:
            fail(f"flash_attention_bwd {name} cannot run at hd={hd}: "
                 f"code {-ctas}")
        key = bwd_kernels(hd, bf16)[pass_]
        regs, stores, loads = PTXAS.get(f"flash_attention_bwd {key}",
                                        ("not_built_here",) * 3)
        parts.append(f"{name}_smem_bytes={nbytes.value} "
                     f"{name}_ctas_per_sm={ctas} {name}_registers={regs} "
                     f"{name}_spill_stores={stores} "
                     f"{name}_spill_loads={loads}")
    return " ".join(parts)


def bwd_pass_bounds(b: int, s: int, h: int, nh: int, size: int,
                    bf16: bool) -> str:
    """Each backward pass's bound (``bound``): the row pass reads q, k, v,
    dO, ab, the rows' statistics and segment ids and writes dQ and the
    bias's gradient, for three products (s, dP, dQ); the column pass reads
    q, k, v, dO, ab, the statistics and segment ids and writes dK and dV,
    for four (s^T, dP^T, dV, dK); 2 B heads S^2 hd flops each, bf16 at
    989 TFLOP/s, f32 as the 3xTF32 products run."""
    hd = h // nh
    shared = (4 * b * s * h + nh * s * s) * size + b * nh * s * 16 + b * s * 8
    parts = []
    for name, nbytes, products in (
            ("rows", shared + b * s * h * size + nh * s * s * size, 3),
            ("cols", shared + 2 * b * s * h * size, 4)):
        flops = products * 2 * b * nh * s * s * hd
        ms, by = (bound(nbytes, flops, "bf16") if bf16
                  else bound(nbytes, 3 * flops, "tf32"))
        parts.append(f"{name}_bound_ms={ms:.4f} {name}_bound_by={by}")
    return " ".join(parts)


def check_flash_attention_bwd(results: dict) -> None:
    """``[flash_attention_bwd]``: the flash backward kernel against its
    plain version on the card at ``FLASH_SHAPES`` and
    ``FLASH_WIDE_SHAPES``, bf16 and f32, from the forward kernel's output
    and residuals, with padded rows and a trained-scale bias that needs a
    gradient: dQ, dK, dV and dab gated (``flash_bwd_ok``), and a second
    call's bits equal to the first's; ms in turns with the plain version,
    device ms and launches a call and each launch's (each pass's) device
    time, the bound (q, k, v, o and dO read and dQ, dK, dV written, ab
    read and dab written, the segment ids and (m, l) read; or five
    products of 2 B heads S^2 hd flops: bf16 at 989 TFLOP/s, f32 as the
    3xTF32 products the kernel runs, three tf32 products each at 495
    TFLOP/s), SDPA's forward + backward with a float mask that requires
    grad, the passes' shared memory, CTAs a multiprocessor, registers and
    spills, and the seconds each case took."""
    import torch

    from tpu_search_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    worst = 0.0
    for b, s, h, nh in FLASH_SHAPES + FLASH_WIDE_SHAPES:
        hd = h // nh
        scale = 1.0 / math.sqrt(hd)
        for dtype in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            tdt = getattr(torch, dtype)
            q, k, v, ab, seg = flash_inputs(gen, b, s, h, nh, dev)
            q, k, v, ab = (t.to(tdt) for t in (q, k, v, ab))
            grad = torch.randn(q.shape, generator=gen, device=dev).to(tdt)
            out, m, l = flash_attention_fwd(q, k, v, ab, seg, seg, scale)
            tag = (f"B={b} S={s} H={h} heads={nh} hd={hd} dtype={dtype}")

            def kernel():
                return flash_attention_bwd(q, k, v, ab, seg, seg, out, grad,
                                           m, l, scale)

            def plain():
                return flash_attention_bwd_plain(q, k, v, ab, seg, seg, out,
                                                 grad, m, l, scale)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            parts = []
            for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
                if not bool(torch.isfinite(g.float()).all()):
                    fail(f"flash_attention_bwd {name} non-finite at {tag}")
                errors = flash_bwd_errors(g, w, dtype)
                parts.append(f"{name}_rel={errors['max_rel_err']:.3e}")
                if dtype == "bfloat16":
                    parts.append(f"{name}_over_1ulp="
                                 f"{errors['over_1ulp_share']:.2e}")
                if not flash_bwd_ok(errors, dtype):
                    fail(f"flash_attention_bwd {name} disagrees with its "
                         f"plain version at {tag}: {errors}")
                worst = max(worst, errors["max_abs_err"])
            again = kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"flash_attention_bwd gave other bits on a second call "
                     f"at {tag}")
            del got, want, again
            kms, pms = paired_ms(kernel, plain, 5)
            dev_ms, launches = device_breakdown(
                f"flash_attention_bwd {tag}", kernel, 3)
            launch_split("flash_attention_bwd", tag, kernel, 3)
            lib = flash_sdpa_grad_ms(q, k, v, ab, seg, grad, scale)
            bf16 = dtype == "bfloat16"
            size = 2 if bf16 else 4
            nbytes = (8 * b * s * h * size + 2 * nh * s * s * size
                      + 2 * b * s * 4 + 2 * b * nh * s * 4)
            flops = 10 * b * nh * s * s * hd
            bound_ms, by = (bound(nbytes, flops, "bf16") if bf16
                            else bound(nbytes, 3 * flops, "tf32"))
            print(f"[flash_attention_bwd] {tag} {' '.join(parts)} "
                  f"kernel_ms={kms:.4f} plain_ms={pms:.4f} "
                  f"device_ms={dev_ms:.4f} launches_per_call={launches:.1f} "
                  f"bound_ms={bound_ms:.4f} bound_by={by} "
                  f"sdpa_fwd_bwd_ms={lib:.4f} "
                  f"{bwd_pass_bounds(b, s, h, nh, size, bf16)} "
                  f"{bwd_occupancy(hd, s, b, nh, bf16)} "
                  f"repeats=True seconds={time.perf_counter() - t0:.2f}",
                  flush=True)
            if (s, h) == FLASH_SHAPES[0][1:3] and bf16:
                results["flash_attention_bwd"] = {
                    "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib}
            del q, k, v, ab, seg, grad, out, m, l
            torch.cuda.empty_cache()
    results["flash_attention_bwd"]["max_abs_err"] = worst


def check_flash_attention_f32(results: dict) -> None:
    """``[flash_attention_f32]``: the flash mode's f32 forward kernel
    against its plain version at ``FLASH_SHAPES`` and
    ``FLASH_WIDE_SHAPES`` (f32 q, k, v and ab,
    padded rows, a trained-scale bias): the output within
    ``ATTN_F32_TOL``, each row's ``(m, l)`` within it relative to the
    plain ones, one launch a call; ms in turns with the plain version,
    SDPA f32, the bound (q, k, v and ab read and out written, or 4 B heads
    S^2 hd flops as the 3xTF32 products the kernel runs), shared memory and
    CTAs a multiprocessor."""
    import torch

    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    worst = 0.0
    for b, s, h, nh in FLASH_SHAPES + FLASH_WIDE_SHAPES:
        t0 = time.perf_counter()
        hd = h // nh
        q, k, v, ab, seg = flash_inputs(gen, b, s, h, nh, dev)
        q, k, v, ab = (t.float() for t in (q, k, v, ab))
        scale = 1.0 / math.sqrt(hd)
        tag = f"B={b} S={s} H={h} heads={nh} hd={hd}"

        def kernel():
            return flash_attention(q, k, v, ab, seg, seg, scale)

        def plain():
            return flash_attention_plain(q, k, v, ab, seg, seg, scale)

        before = _build.LAUNCHES["flash_attention_f32"]
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if _build.LAUNCHES["flash_attention_f32"] != before + 1:
            fail(f"the f32 flash forward did not launch its kernel at {tag}")
        if not bool(torch.isfinite(out).all()):
            fail(f"flash_attention_f32 produced non-finite values at {tag}")
        err = float((out - ref).abs().max())
        _, m, l = flash_attention_fwd(q, k, v, ab, seg, seg, scale)
        _, pm, pl = flash_attention_fwd_plain(q, k, v, ab, seg, seg, scale)
        res_err = max(float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                      for g, w in ((m, pm), (l, pl)))
        del m, l, pm, pl
        kms, pms = paired_ms(kernel, plain)
        lib = flash_sdpa_ms(q, k, v, ab, seg, scale)
        nbytes = 4 * b * s * h * 4 + nh * s * s * 4 + 2 * b * s * 4
        bound_ms, by = bound(nbytes, 3 * 4 * b * nh * s * s * hd, "tf32")
        # two warpgroups up to hd 64, else one
        blocks = -(-hd // 32)
        kernel_name = (f"flash_pair_fwd<{blocks}>" if blocks <= 2
                       else "flash_tf32_fwd")
        regs, stores, loads = PTXAS.get(
            f"flash_attention_f32 {kernel_name}", ("not_built_here",) * 3)
        print(f"[flash_attention_f32] {tag} max_abs_err={err:.3e} "
              f"residual_rel_err={res_err:.3e} kernel_ms={kms:.4f} "
              f"plain_ms={pms:.4f} sdpa_ms={lib:.4f} bound_ms={bound_ms:.4f} "
              f"bound_by={by} {occupancy('flash_attention_f32', hd)} "
              f"registers={regs} spill_stores={stores} spill_loads={loads} "
              f"seconds={time.perf_counter() - t0:.2f}", flush=True)
        if not (err <= ATTN_F32_TOL and res_err <= ATTN_F32_TOL):
            fail(f"flash_attention_f32 disagrees at {tag}: {err}, {res_err}")
        worst = max(worst, err)
        if (s, h) == FLASH_SHAPES[0][1:3]:
            results["flash_attention_f32"] = {
                "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": lib}
        del q, k, v, ab, seg, out, ref
        torch.cuda.empty_cache()
    results["flash_attention_f32"]["max_abs_err"] = worst


# The attention's gradient kernel (``mpnet_attention_bwd.cu``) and the f32
# forward (``mpnet_attention_f32.cu``) at the trainer's shapes: all-mpnet-
# base-v2's [B, S, H] at a chunk bucket (B 32, S 256, H 768, 12 heads) and
# the TinyBERT width's [B, heads, S, hd] at S 512 (12 heads of 26).
GRAD_SHAPES = (("bsh", 32, 256, 768, 12), ("bhsd", 32, 512, 312, 12))
# The backward kernel against its plain twin (``mpnet_attention_bwd_plain``)
# on the card, each output's max |error| over its largest |value|:
#  f32: the same f32 arithmetic in another order of sums: 1e-5.
#  bf16: the same f32 arithmetic on the same bf16 inputs, P rounded to
#    bf16 for dV at the same site; an output rounded to bf16 may land one
#    ulp apart (2^-8 of its magnitude), so 2^-7 of the largest, and at most
#    ATTN_GRAD_ULP_SHARE of outputs more than one bf16 ulp off.  dBias is
#    f32 in both dtypes: 1e-5.  Against autograd dBias takes its dtype's
#    gate: the rounded dP reaches it through dS.
# Against torch autograd of the plain forward, which rounds dP to bf16 where
# the contract keeps it in f32 (as tests/test_torch_attention_grad.py
# gates the same pair on the CPU): 2^-5 of the largest |value| in bf16, and
# at most 1 % of outputs more than 2^-7 of it off; 1e-5 in f32.
ATTN_GRAD_F32_TOL = 1e-5
ATTN_GRAD_BF16_TOL = 2.0 ** -7
ATTN_GRAD_ULP_SHARE = 1e-3
ATTN_GRAD_AUTO_BF16_TOL = 2.0 ** -5
ATTN_GRAD_AUTO_SHARE = 0.01
# The f32 forward against its plain twin: O(1) outputs, f32 sums in another
# order.
ATTN_F32_TOL = 1e-5


def rel_errors(got, want) -> dict:
    """Max |error| over the largest |reference|, and the share of elements
    more than ``ATTN_GRAD_BF16_TOL`` of that scale off."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max().clamp(min=1e-30))
    err = (got - want).abs() / scale
    return {"max_rel_err": float(err.max()),
            "over_tol_share": float((err > ATTN_GRAD_BF16_TOL).float().mean()),
            "max_abs_err": float((got - want).abs().max())}


def grad_gate(errors: dict, dtype: str, auto: bool) -> bool:
    if dtype == "float32":
        return errors["max_rel_err"] <= ATTN_GRAD_F32_TOL
    if auto:
        return (errors["max_rel_err"] <= ATTN_GRAD_AUTO_BF16_TOL
                and errors["over_tol_share"] <= ATTN_GRAD_AUTO_SHARE)
    return errors["max_rel_err"] <= ATTN_GRAD_BF16_TOL


def sdpa_grad_ms(q, k, v, bias, mask, grad, scale, nh, layout) -> tuple:
    """SDPA forward and backward on the same inputs (a yardstick only: the
    port never calls it), the bias and key mask as one float ``attn_mask``
    of q's dtype that requires grad; also whether SDPA gave that mask a
    gradient."""
    import torch
    import torch.nn.functional as F

    def heads(t):
        return heads_of(t, nh) if layout == "bsh" else t

    qq, kk, vv = (heads(t).detach().requires_grad_() for t in (q, k, v))
    gg = heads(grad)
    add = (bias[None] + mask[:, None, None, :]).to(q.dtype)
    add = add.expand(q.shape[0], -1, -1, -1).contiguous().requires_grad_()

    def call():
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=add,
                                             scale=scale)
        out.backward(gg)

    ms = cuda_ms(call, 5)
    return ms, add.grad is not None


def check_attention_grad(results: dict) -> None:
    """``[attention_grad]``: the backward kernel against its plain twin and
    against torch autograd of the plain forward, on the card, at
    ``GRAD_SHAPES`` in bf16 and f32 (a batch row fully padded, others with
    random lengths, the bias trained-scale): each of dQ, dK, dV and dBias
    gated; ms in turns with the plain version, device ms and launches a
    call and each launch's device time (``launch_split``), the bound
    (bytes of q, k, v, dO and the bias read and dQ, dK, dV and dBias
    written, or 10 B heads S^2 hd flops with the scores recomputed: bf16
    at 989 TFLOP/s, f32 as the 3xTF32 products the kernel runs, three
    tf32 products each at 495 TFLOP/s) and SDPA's forward + backward."""
    import torch

    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.mpnet_attention import (
        MPNetAttention,
        mpnet_attention_bhsd_plain,
        mpnet_attention_bwd,
        mpnet_attention_bwd_plain,
        mpnet_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    worst = 0.0
    for layout, b, s, h, nh in GRAD_SHAPES:
        hd = h // nh
        shape = (b, s, h) if layout == "bsh" else (b, nh, s, hd)
        heads_arg = nh if layout == "bsh" else None
        scale = 1.0 / math.sqrt(hd)
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            q, k, v, bias, mask = attention_inputs(gen, shape, nh, s, dev)
            q, k, v = (t.to(tdt) for t in (q, k, v))
            grad = torch.randn(shape, generator=gen, device=dev).to(tdt)
            tag = f"layout={layout} B={b} S={s} H={h} heads={nh} hd={hd} dtype={dtype}"

            def kernel():
                return mpnet_attention_bwd(q, k, v, grad, bias, mask, scale,
                                           heads_arg)

            def plain():
                return mpnet_attention_bwd_plain(q, k, v, grad, bias, mask,
                                                 scale, heads_arg)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            # torch autograd of the plain forward on the same inputs
            leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
            if layout == "bsh":
                out = mpnet_attention_plain(*leaves, mask, nh, scale)
            else:
                out = mpnet_attention_bhsd_plain(*leaves, mask, scale)
            out.backward(grad)
            auto = [t.grad for t in leaves]
            parts = []
            for name, g, w, a in zip(("dq", "dk", "dv", "dbias"), got, want,
                                     auto):
                if not bool(torch.isfinite(g.float()).all()):
                    fail(f"mpnet_attention_bwd {name} non-finite at {tag}")
                e_plain, e_auto = rel_errors(g, w), rel_errors(g, a)
                gate_dtype = "float32" if name == "dbias" else dtype
                if name != "dbias" and dtype == "bfloat16":
                    e_plain["over_1ulp_share"] = bf16_ulp_share(g, w)
                parts.append(
                    f"{name}_rel={e_plain['max_rel_err']:.3e} "
                    f"{name}_auto_rel={e_auto['max_rel_err']:.3e} "
                    f"{name}_auto_share={e_auto['over_tol_share']:.2e}")
                if not grad_gate(e_plain, gate_dtype, auto=False) or (
                        e_plain.get("over_1ulp_share", 0.0)
                        > ATTN_GRAD_ULP_SHARE):
                    fail(f"mpnet_attention_bwd {name} disagrees with its "
                         f"plain twin at {tag}: {e_plain}")
                if not grad_gate(e_auto, dtype, auto=True):
                    fail(f"mpnet_attention_bwd {name} disagrees with autograd "
                         f"of the plain forward at {tag}: {e_auto}")
                worst = max(worst, e_plain["max_abs_err"])
            del out, leaves, auto
            kms, pms = paired_ms(kernel, plain, 5)
            dev_ms, launches = device_breakdown(
                f"mpnet_attention_bwd {tag}", kernel, 5)
            launch_split("mpnet_attention_bwd", tag, kernel)
            lib, lib_bias = sdpa_grad_ms(q, k, v, bias, mask, grad, scale,
                                         nh, layout)
            size = 2 if dtype == "bfloat16" else 4
            nbytes = 7 * b * s * h * size + 2 * nh * s * s * 4 + b * s * 4
            flops = 10 * b * nh * s * s * hd
            bound_ms, by = (bound(nbytes, flops, "bf16")
                            if dtype == "bfloat16"
                            else bound(nbytes, 3 * flops, "tf32"))
            print(f"[attention_grad] {tag} {' '.join(parts)} "
                  f"kernel_ms={kms:.4f} plain_ms={pms:.4f} "
                  f"device_ms={dev_ms:.4f} launches_per_call={launches:.1f} "
                  f"bound_ms={bound_ms:.4f} bound_by={by} "
                  f"sdpa_fwd_bwd_ms={lib:.4f} sdpa_bias_grad={lib_bias}",
                  flush=True)
            if (layout, dtype) == ("bsh", "bfloat16"):
                results["mpnet_attention_bwd"] = {
                    "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib}
            del q, k, v, bias, mask, grad, got, want
    results["mpnet_attention_bwd"]["max_abs_err"] = worst
    # With grad, the wrappers' Function runs the same kernels.
    x = torch.randn((2, 64, 128), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    zb = torch.zeros((2, 64, 64), device=dev)
    zm = torch.zeros((2, 64), device=dev)
    before = dict(_build.LAUNCHES)
    MPNetAttention.apply(x, x, x, zb, zm, 0.125, 2).sum().backward()
    torch.cuda.synchronize()
    if (_build.LAUNCHES["mpnet_attention"] - before["mpnet_attention"],
            _build.LAUNCHES["mpnet_attention_bwd"]
            - before["mpnet_attention_bwd"]) != (1, 1):
        fail("MPNetAttention did not launch the forward and backward kernels")


# The f32 forward's shapes: the f32 encoder's bucket ([f32_encoder], B 32 at
# S 128), a chunk bucket and the TinyBERT width at S 512.
F32_SHAPES = (("bsh", 32, 128, 768, 12), ("bsh", 32, 256, 768, 12),
              ("bhsd", 32, 512, 312, 12))


def check_attention_f32(results: dict) -> None:
    """``[attention_f32]``: ``mpnet_attention_f32.cu`` through the wrappers
    (f32 q, k, v) against the plain versions at ``F32_SHAPES`` (a padded
    and a fully padded row): max error within ``ATTN_F32_TOL``, one launch
    a call, ms in turns with the plain version, SDPA in f32, the bound
    (4 B heads S^2 hd flops as the 3xTF32 products the kernel runs, three
    tf32 products each at 495 TFLOP/s, or the bytes)."""
    import torch

    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention,
        mpnet_attention_bhsd,
        mpnet_attention_bhsd_plain,
        mpnet_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0
    for layout, b, s, h, nh in F32_SHAPES:
        hd = h // nh
        shape = (b, s, h) if layout == "bsh" else (b, nh, s, hd)
        q, k, v, bias, mask = attention_inputs(gen, shape, nh, s, dev)
        q, k, v = (t.float() for t in (q, k, v))
        scale = 1.0 / math.sqrt(hd)
        if layout == "bsh":
            def kernel():
                return mpnet_attention(q, k, v, bias, mask, nh, scale)

            def plain():
                return mpnet_attention_plain(q, k, v, bias, mask, nh, scale)
        else:
            def kernel():
                return mpnet_attention_bhsd(q, k, v, bias, mask, scale)

            def plain():
                return mpnet_attention_bhsd_plain(q, k, v, bias, mask, scale)

        before = _build.LAUNCHES["mpnet_attention_f32"]
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        tag = f"layout={layout} B={b} S={s} H={h} heads={nh} hd={hd}"
        if _build.LAUNCHES["mpnet_attention_f32"] != before + 1:
            fail(f"the f32 forward did not launch its kernel at {tag}")
        if not bool(torch.isfinite(out).all()):
            fail(f"mpnet_attention_f32 produced non-finite values at {tag}")
        err = float((out - ref).abs().max())
        kms, pms = paired_ms(kernel, plain)
        lib = sdpa_ms(*(heads_of(t, nh) if layout == "bsh" else t
                        for t in (q, k, v)), bias, mask, scale)
        bound_ms, by = bound(4 * b * s * h * 4 + nh * s * s * 4 + b * s * 4,
                             3 * 4 * b * nh * s * s * hd, "tf32")
        print(f"[attention_f32] {tag} max_abs_err={err:.3e} "
              f"kernel_ms={kms:.4f} plain_ms={pms:.4f} sdpa_ms={lib:.4f} "
              f"bound_ms={bound_ms:.4f} bound_by={by}", flush=True)
        if not err <= ATTN_F32_TOL:
            fail(f"mpnet_attention_f32 disagrees at {tag}: {err}")
        worst = max(worst, err)
        if s == 128:
            results["mpnet_attention_f32"] = {
                "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": lib}
        del q, k, v, bias, mask, out, ref
    results["mpnet_attention_f32"]["max_abs_err"] = worst


def sdpa_ms(q, k, v, bias, mask, scale) -> float:
    """The same attention on ``[B, heads, S, hd]`` inputs through
    ``F.scaled_dot_product_attention`` (a yardstick only: the port never
    calls it), with the bias and the key mask folded into one additive
    mask of q's dtype outside the timed call."""
    import torch.nn.functional as F

    add = (bias[None] + mask[:, None, None, :]).to(q.dtype)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=add, scale=scale))


def bf16_ulp_share(out, ref) -> float:
    """Share of ``out`` more than one bf16 ulp (of ``ref``) from ``ref``."""
    import torch

    ref = ref.float()
    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
    return float(((out.float() - ref).abs() > ulp).float().mean())


def bf16_errors(out, ref) -> dict:
    """Max and mean error of a bf16 kernel output, and its share of outputs
    more than one bf16 ulp off."""
    err = (out.float() - ref.float()).abs()
    return {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "over_1ulp_share": bf16_ulp_share(out, ref)}


def format_errors(errors: dict) -> str:
    return " ".join(f"{key}={value:.3e}" for key, value in errors.items())


def attention_ok(errors: dict, name: str) -> bool:
    """An attention kernel's tolerance against its plain version."""
    return (errors["max_abs_err"] <= TOL[name]
            and errors["mean_abs_err"] <= ATTN_MEAN_TOL
            and errors["over_1ulp_share"] <= ATTN_ULP_SHARE_TOL)


def ffn_ok(errors: dict) -> bool:
    """The int8 FFN's tolerance against its plain version (see ``TOL``)."""
    return (errors["max_abs_err"] <= TOL["int8_ffn_ln"]
            and errors["mean_abs_err"] <= FFN_MEAN_TOL
            and errors["over_1ulp_share"] <= FFN_ULP_SHARE_TOL)


def ulp_errors(out, ref) -> dict:
    """Errors of a kernel output against its plain version, in units of the
    output dtype's ulp at the plain value (bf16: 2^(e-8), f32: 2^(e-24)):
    the max absolute error, the max and mean in ulps, and the share of
    outputs more than one ulp off."""
    import torch

    ref = ref.float()
    bits = 8 if out.dtype == torch.bfloat16 else 24
    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - bits)
    err = (out.float() - ref).abs()
    ulps = err / ulp
    return {"max_abs_err": float(err.max()), "max_ulps": float(ulps.max()),
            "mean_ulps": float(ulps.mean()),
            "over_1ulp_share": float((ulps > 1).float().mean())}


def int8_ok(errors: dict) -> bool:
    """The int8 GEMM family's tolerance against the plain versions (see
    ``INT8_MAX_ULPS``)."""
    return (errors["max_ulps"] <= INT8_MAX_ULPS
            and errors["mean_ulps"] <= INT8_MEAN_ULPS
            and errors["over_1ulp_share"] <= INT8_ULP_SHARE_TOL)


def planted_rows(kind: str, width: int, rows: int, device):
    """``[rows, width]`` f32 rows, each a permutation of one set of values
    of at least 6 (where the f32 tanh-gelu returns its input exactly, as
    tanh rounds to 1), on which one rounding fault moves most int8 codes:

    - ``ties``: amax 127/8, so ``x * (127 / amax)`` is ``x * 8``, which lands
      on k + 0.5 in half of the columns: round half to even and half away
      from zero differ;
    - ``mul_div``: amax A = 18.375 and the other columns A/2 (16 times the
      ``planted_ffn_inputs`` values): multiplying by the f32 quotient
      ``127 / A`` gives 63.5 -> 64, dividing by ``A / 127`` gives 63.

    They are ``h`` for ``int8_ffn_out``; one row is the GEMM1 bias of
    ``int8_ffn_fused`` over an all-zero ``x_q``, whose gelu output it then
    is."""
    import torch

    gen = torch.Generator().manual_seed(9)
    if kind == "ties":
        steps = torch.tensor([80.5, 81.5, 82.5, 83.5, 100.5, 101.5, 126.5,
                              127.0])
        base = steps.repeat(width // 8) / 8.0
    elif kind == "mul_div":
        base = torch.full((width,), 18.375 / 2)
        base[0] = 18.375
    else:
        raise ValueError(kind)
    return torch.stack([base[torch.randperm(width, generator=gen)]
                        for _ in range(rows)]).to(device)


def planted_ffn_inputs(kind: str, h: int, rows: int, device):
    """LN1 inputs on which one rounding fault moves every row's int8 codes.
    Rows of +-1, as many of each, with eps = 0 make LN1's output its scale
    exactly, so ``x_q`` is planted through the LN1 scale:

    - ``ties``: amax is 127/64, so ``x * (127 / amax)`` is exactly k + 0.5
      in most columns: round half to even and half away from zero differ;
    - ``mul_div``: amax is A = 1.1484375 and the other columns are +-A/2,
      so ``x * 127 / A`` is 63.5 in exact arithmetic.  Multiplying by the
      f32 quotient ``127 / A`` gives 63.5 -> 64; dividing by ``A / 127``,
      or multiplying by ``127 * (1 / A)``, gives just under 63.5 -> 63.

    Returns ``(pre [rows, h] bf16, ln1_scale [h], ln1_bias [h])``."""
    import torch

    gen = torch.Generator().manual_seed(9)
    signs = torch.stack([
        torch.where(torch.randperm(h, generator=gen) < h // 2, 1.0, -1.0)
        for _ in range(rows)
    ])
    if kind == "ties":
        steps = torch.tensor([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 126.5, 127.0])
        scale = steps.repeat(h // 8) / 64.0
    elif kind == "mul_div":
        scale = torch.full((h,), 1.1484375 / 2)
        scale[0] = 1.1484375
    else:
        raise ValueError(kind)
    return (signs.to(torch.bfloat16).to(device), scale.to(device),
            torch.zeros((h,), device=device))


def planted_epilogue(site: str):
    """``int8_ffn_ln`` inputs on which its dequantize epilogue ``(acc *
    s_row) * s_col + bias`` gives one result rounded once (an FMA, as XLA
    compiles the JAX kernel) and another rounded after the product and
    again after the bias, and on which that difference reaches the bf16
    output; every other rounding is exact, so the output has one right
    value bit for bit.

    Rows of +-1 (column 0 always +1), LN1 scale 2^-30 and eps 0 make the
    residual x = +-2^-30 exactly (absorbed where it is added), ``x_q`` =
    +-127 and ``sx = 2^-30 * f32(1/127)``.  GEMM1 column 0 is zero with bias
    127, so gelu gives h = 127 (tanh rounds to 1), ``127 / amax_h = 1`` and
    ``scale_h = 1``.

    - ``y`` (GEMM1): column 1 has code 77 in row 0 and scale s1 such that
      t = round(acc1 * sx * s1) lies below the exact product, and bias b1 =
      20.5 + 2^-20 - t.  Rounded twice, y is the tie 20.5 + 2^-20 -> 20.5
      and h_q = rint(20.5) = 20; rounded once, y = 20.5 + 2^-19 and h_q =
      21.  GEMM2 writes [127, h_q, 64, 64] across the columns (three values,
      so LN2 does not normalize the change away; every sum is exact).
    - ``ff`` (GEMM2): columns 4j have code 109 against h = 127 and scale s2
      with t = round(acc2 * s2) below the exact product, and b2 = M + 2^-24
      - t for the bf16 midpoint M = 1 + 81/256.  Rounded twice, ff is the
      f32 tie M + 2^-24 -> M, which rounds to the even bf16 1 + 40/128;
      rounded once, M + 2^-23, which rounds up to 1 + 41/128.  The other
      columns hold 1 and 4 (bias only).

    Returns numpy operands in the JAX kernel's order and layouts (``pre [16,
    128]``, ``w1_q [128, 256]``, ``s1``, ``b1``, ``w2_q [256, 128]``, ``s2``,
    ``b2``, the four LN vectors), and the planted site's value rounded
    twice and once."""
    import numpy as np

    f32 = np.float32
    h, inter, rows = 128, 256, 16
    cols = np.arange(h)
    rng = np.random.default_rng(5)
    pre = np.stack([rng.permutation(np.r_[np.ones(h // 2), -np.ones(h // 2)])
                    for _ in range(rows)]).astype(f32)
    for r in pre:
        if r[0] < 0:
            j = np.nonzero(r > 0)[0][0]
            r[0], r[j] = 1.0, -1.0
    ln = [np.full(h, 2.0 ** -30, f32), np.zeros(h, f32), np.ones(h, f32),
          np.zeros(h, f32)]
    w1q, s1 = np.zeros((h, inter), np.int8), np.ones(inter, f32)
    b1 = np.zeros(inter, f32)
    w2q, s2, b2 = np.zeros((inter, h), np.int8), np.ones(h, f32), np.zeros(h, f32)
    b1[0] = 127.0
    inv127 = f32(1.0) / f32(127.0)
    if site == "y":
        code, scale, target = 77, f32(81439560.0), 20.5
        acc_s = f32(f32(127 * code) * f32(f32(2.0 ** -30) * inv127))
        half_ulp = 2.0 ** -20
        w1q[0, 1], s1[1] = code, scale
        w2q[0, cols % 4 == 0] = 1
        w2q[1, cols % 4 == 1] = 1
        b2[cols % 4 >= 2] = 64.0
    elif site == "ff":
        code, scale, target = 109, f32(3.1237007e-05), 1 + 81 / 256
        acc_s = f32(127 * code)
        half_ulp = 2.0 ** -24
        w2q[0, cols % 4 == 0], s2[cols % 4 == 0] = code, scale
        b2[cols % 4 == 1], b2[cols % 4 >= 2] = 1.0, 4.0
    else:
        raise ValueError(site)
    t = f32(acc_s * scale)
    assert float(acc_s) * float(scale) > float(t)  # the product rounded down
    bias = f32(target + half_ulp - float(t))
    assert float(bias) == target + half_ulp - float(t)
    if site == "y":
        b1[1] = bias
    else:
        b2[cols % 4 == 0] = bias
    twice = f32(t + bias)
    once = f32(float(acc_s) * float(scale) + float(bias))  # exact in f64
    return (pre, w1q, s1, b1, w2q, s2, b2, ln), (twice, once)


def kernel_split(rows) -> list:
    """``[(kernel, device ms a launch, launches)]`` from the profiler's
    ``(name, device ms, count)`` rows, the template instances of one kernel
    merged, largest first.  A mean over the launches recorded, not a sum
    over calls: the profiler can miss a window's first launches."""
    ms, count = {}, {}
    for name, total, n in rows:
        key = short_kernel_name(name)
        ms[key] = ms.get(key, 0.0) + total
        count[key] = count.get(key, 0) + n
    return sorted(((k, ms[k] / count[k], count[k]) for k in ms),
                  key=lambda r: -r[1])


def launch_split(name: str, tag: str, call, calls: int = 5) -> None:
    """The device time of each launch of ``call()``, a call of kernel
    ``name``'s wrapper (torch.profiler, as ``device_breakdown``), over
    ``calls`` calls: each kernel's mean, its share of their sum (one call:
    each kernel launches once) and the launches recorded."""
    from tpu_search_torch.utils.device_profile import _by_kernel

    events, _ = profiled_events(f"{name} {tag}", call, calls)
    split = kernel_split(_by_kernel(events))
    total = sum(ms for _, ms, _ in split)
    print(f"[{name}] launches {tag} calls={calls} device_ms={total:.4f} "
          + " ".join(f"{kernel}={ms:.4f}({ms / total:.1%},n={n})"
                     for kernel, ms, n in split), flush=True)


def ffn_yardsticks(args, w1, w2) -> str:
    """Yardsticks the port never calls, on the same inputs: the port's
    bf16 layer half (``int8_ffn=False``: cuBLAS products, gelu, LN) from
    the unquantized weights, and ``torch._int_mm`` of the two int8
    products alone."""
    import torch
    import torch.nn.functional as F

    from tpu_search_torch.models.mpnet import layer_norm

    pre, w1t, _, b1, w2t, _, b2, l1s, l1b, l2s, l2b = args
    bf = torch.bfloat16
    w1o, w2o = w1.T.contiguous().to(bf), w2.T.contiguous().to(bf)
    b1b, b2b = b1.to(bf), b2.to(bf)

    def bf16_half():
        x = layer_norm(pre, l1s, l1b, 1e-5)
        ff = F.linear(F.gelu(F.linear(x, w1o, b1b), approximate="tanh"), w2o,
                      b2b)
        return layer_norm(ff + x, l2s, l2b, 1e-5)

    m, h = pre.shape
    inter = w1t.shape[0]
    x_q = torch.randint(-127, 128, (m, h), dtype=torch.int8, device=pre.device)
    h_q = torch.randint(-127, 128, (m, inter), dtype=torch.int8,
                        device=pre.device)
    mm1 = cuda_ms(lambda: torch._int_mm(x_q, w1t.t()), 5)
    mm2 = cuda_ms(lambda: torch._int_mm(h_q, w2t.t()), 5)
    return (f"bf16_ffn_ms={cuda_ms(bf16_half, 5):.4f} int_mm_in_ms={mm1:.4f} "
            f"int_mm_out_ms={mm2:.4f} int_mm_pair_ms={mm1 + mm2:.4f}")


def check_int8_ffn(results: dict) -> None:
    """The W8A8 FFN at all-mpnet-base-v2's width (H 768, I 3072), at
    all-MiniLM-L6-v2's (H 384, I 1536), at TinyBERT-312's (H 312, I 1200)
    and at BERT-large's (H 1024, I 4096): random inputs at an indexing
    wave's and a query's row count, then the planted rounding inputs; then
    a random-weight 312-wide embedder through the int8 gate."""
    import torch

    from tpu_search_torch.ops.int8_ffn import (
        int8_ffn_ln,
        int8_ffn_ln_plain,
        quantize_weight_columns,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)

    def bf(t):
        return t.to(torch.bfloat16).float()

    def gate(tag, out, ref):
        errors = bf16_errors(out, ref)
        ulps = ulp_errors(out, ref)
        line = f"[int8_ffn_ln] {tag} " + " ".join(
            f"{k}={v:.3e}" for k, v in {**errors, **ulps}.items())
        if not ffn_ok(errors):
            fail(f"int8_ffn_ln disagrees: {line}")
        return errors["max_abs_err"], line

    worst = 0.0
    for h, inter in ((768, 3072), (384, 1536), (312, 1200), (1024, 4096)):
        w1 = bf(0.02 * torch.randn((h, inter), generator=gen, device=dev))
        w2 = bf(0.02 * torch.randn((inter, h), generator=gen, device=dev))
        w1q, s1 = quantize_weight_columns(w1)
        w2q, s2 = quantize_weight_columns(w2)
        w1t, w2t = w1q.T.contiguous(), w2q.T.contiguous()
        b1 = bf(0.02 * torch.randn((inter,), generator=gen, device=dev))
        b2 = bf(0.02 * torch.randn((h,), generator=gen, device=dev))
        ln = [bf(1.0 + 0.1 * torch.randn((h,), generator=gen, device=dev))
              if i % 2 == 0 else
              bf(0.1 * torch.randn((h,), generator=gen, device=dev))
              for i in range(4)]
        for m in (128 * 384, 8 * 64):
            pre = torch.randn((m, h), generator=gen, device=dev).to(
                torch.bfloat16)
            pre[0] = 0  # an all-zero row (its LN output is the LN bias)
            args = (pre, w1t, s1, b1, w2t, s2, b2, *ln)
            out = int8_ffn_ln(*args)
            ref = int8_ffn_ln_plain(*args)
            torch.cuda.synchronize()
            err, line = gate(f"M={m} H={h} I={inter}", out, ref)
            kms, pms = paired_ms(lambda: int8_ffn_ln(*args),
                                 lambda: int8_ffn_ln_plain(*args), iters=5)
            ops = 4 * m * h * inter
            print(f"{line} kernel_ms={kms:.4f} plain_ms={pms:.4f} "
                  f"effective_tops={ops / kms / 1e9:.1f}", flush=True)
            worst = max(worst, err)
            if h == 768:
                print(f"[int8_ffn_ln] M={m} H={h} I={inter} yardsticks: "
                      f"{ffn_yardsticks(args, w1, w2)}", flush=True)
                launch_split("int8_ffn_ln", f"M={m} H={h} I={inter}",
                             lambda: int8_ffn_ln(*args))
            if (m, h) == (128 * 384, 768):
                # input and output rows, int8 weights and their scales read
                # once; the two W8A8 products at the int8 rate
                bound_ms, by = bound(
                    2 * m * h * 2 + 2 * h * inter + 4 * (inter + h),
                    2 * 2 * m * h * inter, "int8")
                # no single PyTorch call: W8A8 GEMMs, GELU, requantize, LN
                results["int8_ffn_ln"] = {"ms": kms, "plain_ms": pms,
                                          "bound_ms": bound_ms, "bound_by": by,
                                          "library_ms": None}

        for kind in ("ties", "mul_div"):
            pre, ln1_scale, ln1_bias = planted_ffn_inputs(kind, h, 64, dev)
            args = (pre, w1t, s1, b1, w2t, s2, b2, ln1_scale, ln1_bias,
                    *ln[2:])
            out = int8_ffn_ln(*args, eps=0.0)
            ref = int8_ffn_ln_plain(*args, eps=0.0)
            torch.cuda.synchronize()
            err, line = gate(f"M=64 H={h} I={inter} planted={kind}", out, ref)
            print(line, flush=True)
            worst = max(worst, err)
    for site in ("y", "ff"):
        # exact LayerNorm statistics: one right output, bit for bit
        ops, _ = planted_epilogue(site)
        t = [torch.from_numpy(x).to(dev) for x in (*ops[:7], *ops[7])]
        args = (t[0].to(torch.bfloat16), t[1].T.contiguous(), t[2], t[3],
                t[4].T.contiguous(), *t[5:])
        out = int8_ffn_ln(*args, eps=0.0)
        ref = int8_ffn_ln_plain(*args, eps=0.0)
        torch.cuda.synchronize()
        ulps = ulp_errors(out, ref)
        print(f"[int8_ffn_ln] planted_epilogue={site} max_ulps="
              f"{ulps['max_ulps']:.3e}", flush=True)
        if ulps["max_ulps"] != 0.0:
            fail(f"int8_ffn_ln rounds its {site} epilogue otherwise: {ulps}")
    results["int8_ffn_ln"]["max_abs_err"] = worst
    check_int8_gate_312()


def check_int8_gate_312() -> None:
    """A random-weight TinyBERT_General_4L_312D embedder (H 312, I 1200)
    loaded through ``EmbeddingGenerator`` on the card: the int8 gate runs
    the widened FFN kernel and passes or fails by its cosine; the model
    then encodes."""
    import numpy as np

    from tpu_search_torch.models.encoder import (
        EmbeddingConfig,
        EmbeddingGenerator,
    )
    from tpu_search_torch.ops import _build
    from tpu_search_torch.utils.synthetic import write_bert_model

    name = "TinyBERT_General_4L_312D"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_312_") as tmp:
        write_bert_model(Path(tmp) / name, name, 40)
        before = _build.LAUNCHES["int8_ffn_ln"]
        gen = EmbeddingGenerator(EmbeddingConfig(
            model_name=name, cache_dir=tmp, device="cuda",
            auto_batch_size=False, show_progress=False))
        gen.load_model()
        emb = gen._encode_texts([f"tok{i} tok{i + 1} tok{i + 7}"
                                 for i in range(8)])
    gate = gen.int8_gate
    print(f"[int8_gate] model={name} hidden=312 intermediate=1200 "
          f"min_cosine={gate.get('min_cosine')} ok={gate.get('ok')} "
          f"int8_ffn={gen._int8_ffn} ffn_launches="
          f"{_build.LAUNCHES['int8_ffn_ln'] - before} "
          f"embeddings={list(emb.shape)} finite={bool(np.isfinite(emb).all())}",
          flush=True)
    if gate.get("min_cosine") is None or not np.isfinite(emb).all():
        fail(f"the 312-wide embedder did not pass through the int8 gate: {gate}")


INT8_FAMILY = ("int8_gemm", "int8_ffn_in", "int8_ffn_out", "int8_ffn_fused")
# The int8 GEMM family's shapes (M, H, I): the bench's (all-mpnet-base-v2's
# FFN over an indexing wave, 128 x 384 rows), a query's row count, and
# ragged row counts at TinyBERT-312's and BERT-large's widths.
INT8_FAMILY_SHAPES = ((128 * 384, 768, 3072), (512, 768, 3072),
                      (12289, 312, 1200), (12289, 1024, 4096))


def int8_family_inputs(gen, m, h, inter, dev):
    """The bench's operands: rows of 0.5 N(0, 1) quantized by
    ``quantize_rows`` (row 0 all zero), weights of 0.02 N(0, 1) quantized
    per output column, biases of 0.01 N(0, 1), a bf16 residual."""
    import torch

    from tpu_search_torch.ops.int8_ffn import quantize_weight_columns
    from tpu_search_torch.ops.int8_gemm import quantize_rows

    x = 0.5 * torch.randn((m, h), generator=gen, device=dev)
    x[0] = 0
    x_q, sx = quantize_rows(x)
    w1q, s1 = quantize_weight_columns(
        0.02 * torch.randn((h, inter), generator=gen, device=dev))
    w2q, s2 = quantize_weight_columns(
        0.02 * torch.randn((inter, h), generator=gen, device=dev))
    return {"x_q": x_q, "sx": sx, "w1": w1q.T.contiguous(), "s1": s1,
            "b1": 0.01 * torch.randn((inter,), generator=gen, device=dev),
            "w2": w2q.T.contiguous(), "s2": s2,
            "b2": 0.01 * torch.randn((h,), generator=gen, device=dev),
            "res": (0.5 * torch.randn((m, h), generator=gen, device=dev)
                    ).to(torch.bfloat16)}


def int8_family_cases(t, out):
    """``{kernel: [(tag, kernel call, plain call)]}`` for the operands ``t``
    and the output dtype ``out`` (``int8_ffn_in`` returns ``(h, amax)``)."""
    import torch

    from tpu_search_torch.ops import int8_gemm as G

    h_in, amax = G.int8_ffn_in_plain(t["x_q"], t["w1"], t["sx"], t["s1"],
                                     t["b1"], out)
    h_q, sh = G.quantize_rows(h_in)
    res = t["res"].to(out)
    gemm_in = (t["x_q"], t["w1"], t["sx"], t["s1"], t["b1"])
    gemm_out = (h_q, t["w2"], sh, t["s2"], t["b2"])
    fused = (t["x_q"], t["sx"], t["w1"], t["s1"], t["b1"], t["w2"], t["s2"],
             t["b2"], res)

    return {
        "int8_gemm": [
            ("ffn_in shape gelu",
             lambda: G.int8_gemm(*gemm_in, fuse_gelu=True, out_dtype=out),
             lambda: G.int8_gemm_plain(*gemm_in, fuse_gelu=True,
                                       out_dtype=out)),
            ("ffn_out shape",
             lambda: G.int8_gemm(*gemm_out, out_dtype=out),
             lambda: G.int8_gemm_plain(*gemm_out, out_dtype=out))],
        "int8_ffn_in": [
            ("", lambda: G.int8_ffn_in(*gemm_in, out_dtype=out),
             lambda: G.int8_ffn_in_plain(*gemm_in, out_dtype=out))],
        "int8_ffn_out": [
            ("", lambda: G.int8_ffn_out(h_in, amax, t["w2"], t["s2"], t["b2"],
                                        res, out_dtype=out),
             lambda: G.int8_ffn_out_plain(h_in, amax, t["w2"], t["s2"],
                                          t["b2"], res, out_dtype=out))],
        "int8_ffn_fused": [
            ("", lambda: G.int8_ffn_fused(*fused, out_dtype=out),
             lambda: G.int8_ffn_fused_plain(*fused, out_dtype=out))],
    }


def int8_planted_cases(t, kind):
    """``int8_ffn_out`` on planted ``h`` rows and ``int8_ffn_fused`` with
    an all-zero x_q and a planted GEMM1 bias (see ``planted_rows``), 64
    rows, f32 output."""
    import torch

    from tpu_search_torch.ops import int8_gemm as G

    dev, inter = t["w1"].device, t["w1"].shape[0]
    f32 = torch.float32
    h = planted_rows(kind, inter, 64, dev)
    amax = h.amax(dim=1, keepdim=True)
    res = t["res"][:64].float()
    out = (h, amax, t["w2"], t["s2"], t["b2"], res)
    fused = [torch.zeros_like(t["x_q"][:64]), t["sx"][:64], t["w1"], t["s1"],
             planted_rows(kind, inter, 1, dev)[0], t["w2"], t["s2"], t["b2"],
             res]
    return {
        "int8_ffn_out": (lambda: G.int8_ffn_out(*out, out_dtype=f32),
                         lambda: G.int8_ffn_out_plain(*out, out_dtype=f32)),
        "int8_ffn_fused": (lambda: G.int8_ffn_fused(*fused, out_dtype=f32),
                           lambda: G.int8_ffn_fused_plain(*fused,
                                                          out_dtype=f32)),
    }


def int8_family_bound(name, m, h, inter):
    """``(bound_ms, bound_by)`` of one call at (M, H, I) with bf16 output
    and residual: each input read once, each output written once; the
    products' operations (for the fused FFN, both GEMMs)."""
    ops = 2 * m * h * inter
    if name in ("int8_gemm", "int8_ffn_in"):  # ffn_in's shape
        nbytes = m * h + inter * h + 4 * (m + 2 * inter) + 2 * m * inter
        nbytes += 4 * m if name == "int8_ffn_in" else 0
    elif name == "int8_ffn_out":  # bf16 h [M, I] in, [M, H] out
        nbytes = 2 * m * inter + 4 * m + h * inter + 8 * h + 2 * 2 * m * h
    else:
        nbytes = m * h + 4 * m + 2 * h * inter + 8 * (h + inter) + 2 * 2 * m * h
        ops *= 2
    return bound(nbytes, ops, "int8")


def gemm_out_operands(t):
    """``int8_gemm``'s operands at the bench's second row (K 3,072, N 768):
    the requantized gelu output of the first GEMM against ``w2``, its row
    scales, ``s2`` and ``b2``."""
    from tpu_search_torch.ops import int8_gemm as G

    h_in, _ = G.int8_ffn_in_plain(t["x_q"], t["w1"], t["sx"], t["s1"],
                                  t["b1"])
    h_q, sh = G.quantize_rows(h_in)
    return h_q, t["w2"], sh, t["s2"], t["b2"]


def int8_gemm_timing(kernel, m, k, n, operands) -> str:
    """``kernel_ms``, TOP/s, and ``torch._int_mm``'s time and TOP/s on the
    same int8 product (no epilogue; a yardstick the port never calls)."""
    import torch

    x_q, w = operands
    wt = w.t()
    kms = cuda_ms(kernel, iters=5)
    lib = cuda_ms(lambda: torch._int_mm(x_q, wt), iters=5)
    ops = 2 * m * k * n
    return (f" kernel_ms={kms:.4f} tops={ops / kms / 1e9:.1f} "
            f"int_mm_ms={lib:.4f} int_mm_tops={ops / lib / 1e9:.1f}")


def int8_tile_ms(x_q, w, sx, sw, bias, gelu: bool, ref) -> str:
    """``int8_gemm.cu``'s two tiles (``int8_gemm_tile``: 128 x 256 fed by
    a producer warpgroup, 128 x 128 by two producer warps) on the same
    bf16-output call, each held to 0 ulps of ``ref``: the times behind
    ``int8_gemm``'s choice of tile by epilogue."""
    import ctypes

    import torch

    from tpu_search_torch.ops import _build

    fn = _build.library("int8_gemm").int8_gemm_tile
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    m, k = x_q.shape
    n = w.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
    parts = []
    for wide, tag in ((1, "tile256"), (0, "tile128")):
        def call():
            _build.check(fn(x_q.data_ptr(), w.data_ptr(), sx.data_ptr(),
                            sw.data_ptr(), bias.data_ptr(), y.data_ptr(), m,
                            n, k, int(gelu), 1, wide,
                            _build.stream_ptr(x_q.device)), "int8_gemm_tile")

        call()
        torch.cuda.synchronize()
        if ulp_errors(y, ref)["max_ulps"] != 0:
            fail(f"int8_gemm's {tag} differs from its plain version")
        parts.append(f"{tag}_ms={cuda_ms(call, iters=5):.4f}")
    return " " + " ".join(parts)


def check_int8_gemm(results: dict) -> None:
    """The int8 GEMM family against its plain versions at
    ``INT8_FAMILY_SHAPES``, bf16 and f32 outputs, then the planted
    requantization inputs; times at the bench's shape (bf16), beside the
    bound and, for ``int8_gemm``, ``torch._int_mm`` of the same int8
    product (no epilogue) as the library yardstick."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = {name: 0.0 for name in INT8_FAMILY}

    def gate(name, tag, kernel, plain):
        """Every output of ``kernel()`` (``int8_ffn_in``: h, then amax)
        against ``plain()``'s; returns the line of their errors."""
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, ref = (got,), (ref,)
        lines = []
        for g, r in zip(got, ref):
            errors = ulp_errors(g, r)
            lines.append(format_errors(errors))
            if not bool(torch.isfinite(g.float()).all()) or not int8_ok(errors):
                fail(f"{name} disagrees with its plain version: [{name}] "
                     f"{tag} {lines[-1]}")
            worst[name] = max(worst[name], errors["max_abs_err"])
        return f"[{name}] {tag} " + " | amax ".join(lines)

    planted = set()
    for m, h, inter in INT8_FAMILY_SHAPES:
        t = int8_family_inputs(gen, m, h, inter, dev)
        for out in (torch.bfloat16, torch.float32):
            dt = "bf16" if out == torch.bfloat16 else "f32"
            for name, cases in int8_family_cases(t, out).items():
                for tag, kernel, plain in cases:
                    line = gate(name, f"M={m} H={h} I={inter} out={dt} {tag}",
                                kernel, plain)
                    bench = (m, h, out) == (128 * 384, 768, torch.bfloat16)
                    if bench and name == "int8_gemm":
                        gelu = "gelu" in tag
                        ops = ((t["x_q"], t["w1"], t["sx"], t["s1"], t["b1"])
                               if gelu else gemm_out_operands(t))
                        line += int8_tile_ms(*ops, gelu, plain())
                    if bench and "ffn_out shape" in tag:
                        # the bench's second row: timed, not the summary's
                        line += int8_gemm_timing(kernel, m, inter, h,
                                                 gemm_out_operands(t)[:2])
                    elif bench:
                        kms, pms = paired_ms(kernel, plain, iters=5)
                        bound_ms, by = int8_family_bound(name, m, h, inter)
                        lib = None
                        if name == "int8_gemm":
                            w1t = t["w1"].t()
                            lib = cuda_ms(lambda: torch._int_mm(t["x_q"], w1t))
                            line += (f" tops={2 * m * h * inter / kms / 1e9:.1f}"
                                     f" int_mm_tops="
                                     f"{2 * m * h * inter / lib / 1e9:.1f}")
                        if name == "int8_ffn_fused":
                            line += f" tops={4 * m * h * inter / kms / 1e9:.1f}"
                        if name == "int8_ffn_in":
                            line += f" tops={2 * m * h * inter / kms / 1e9:.1f}"
                        if name != "int8_gemm":
                            launch_split(name, f"M={m} H={h} I={inter}",
                                         kernel)
                        results[name] = {"ms": kms, "plain_ms": pms,
                                         "bound_ms": bound_ms, "bound_by": by,
                                         "library_ms": lib}
                        line += (f" kernel_ms={kms:.4f} plain_ms={pms:.4f} "
                                 f"bound_ms={bound_ms:.4f} bound_by={by}"
                                 + ("" if lib is None else
                                    f" int_mm_ms={lib:.4f}"))
                    print(line, flush=True)
        for kind in ("ties", "mul_div"):
            if (h, inter, kind) in planted:
                continue
            planted.add((h, inter, kind))
            for name, (kernel, plain) in int8_planted_cases(t, kind).items():
                print(gate(name, f"M=64 H={h} I={inter} out=f32 "
                                 f"planted={kind}", kernel, plain), flush=True)
        del t
    for name in INT8_FAMILY:
        results[name]["max_abs_err"] = worst[name]


IVF_N, IVF_NLIST, IVF_CENTRES = 1_000_000, 1024, 4096
IVF_CASES = ((1, 10), (1, 128), (8, 10), (128, 10), (128, 128), (1, 200))
# Bytes a scheduled row brings: the row, then its penalty (bf16) or its
# scale and penalty (int8, int4).
IVF_ROW_BYTES = {"bfloat16": 768 * 2 + 4, "float32": 768 * 4 + 4,
                 "int8": 768 + 8, "int4": 384 + 8}


def ivf_corpus(dev):
    """1M x 768 clustered unit rows: 4,096 centres drawn in a 32-dim
    subspace (neighbouring clusters overlap, as topics of one corpus do)
    and each row's label from numpy seed 21, the per-row noise (|noise|
    about 3 times a centre's norm, so that a row's neighbours span several
    lists: at 60k rows and 64 lists the tuned nprobe is 8-32, on the CPU)
    from a torch generator seeded 21 on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)
    basis = rng.standard_normal((32, 768)).astype(np.float32)
    centres = rng.standard_normal((IVF_CENTRES, 32)).astype(np.float32) @ basis
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    labels = torch.from_numpy(rng.integers(0, IVF_CENTRES, IVF_N)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = torch.from_numpy(centres).to(dev)[labels]
    rows += 0.11 * torch.randn((IVF_N, 768), generator=gen, device=dev)
    return rows / rows.norm(dim=1, keepdim=True)


def build_ivf_indexes(rows, dead):
    """bf16 (trained by the port's balanced k-means), f32, int8 and int4
    IVF indexes over ``rows`` at nlist 1024, sharing the bf16 index's
    centroids, with ``dead`` ids tombstoned."""
    import torch

    from tpu_search_torch.index.ivf import IVFIndex

    indexes = {}
    for dtype in ("bfloat16", "float32", "int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = IVFIndex(768, dtype=dtype, nlist=IVF_NLIST,
                         device=rows.device)
        if indexes:
            index.centroids = indexes["bfloat16"].centroids
        index.add(rows)
        index.remove(dead)
        torch.cuda.synchronize()
        print(f"[ivf_build] dtype={dtype} rows={index.ntotal} live="
              f"{index.live} trained={'here' if not indexes else 'shared'} "
              f"seconds={time.perf_counter() - t0:.2f} cap="
              f"{index._cluster_capacity} padding="
              f"{json.dumps(index.padding_stats())}", flush=True)
        indexes[dtype] = index
    return indexes


def print_scan_config(name: str) -> None:
    """Shared memory and CTAs a multiprocessor of a ring scan's scan CTA
    at each query block and k: the digit scans at 8 (mma.sync) and 32
    (wgmma); the bf16 scans (IVF and flat) at 16 (mma.sync) and 32
    (wgmma), the f32 scans at 16."""
    from tpu_search_torch.ops.ring_scan import scan_config

    floats = name in ("ivf_topk", "flat_topk")
    blocks = [(True, 16), (True, 32), (False, 16)] if floats else (
        {"flat_topk_int4": [(True, 32)]}.get(name, [(True, 8), (True, 32)]))
    for bf16, qb in blocks:
        head = (int(bf16),) if floats else ()
        for k in (10, 128, 200):
            smem, ctas = scan_config(name, qb, k, *head)
            kind = "" if not floats else (" bf16" if bf16 else " f32")
            print(f"[{name}] scan{kind} QB={qb} k={k} shared_memory_bytes="
                  f"{smem} ctas_per_multiprocessor={ctas}", flush=True)


def check_ivf_prep(dtype, probe, fills, queries, cbias, cap, nprobe) -> None:
    """The scan's prologue kernel against its plain twin on the same
    inputs (the digit scans' for int8 / int4, the float scan's for bf16 /
    f32): every output equal, bit for bit."""
    import torch

    from tpu_search_torch.ops import ivf_scan

    if dtype in ("bfloat16", "float32"):
        bf16 = dtype == "bfloat16"
        got = ivf_scan.ivf_float_prep(probe, fills, queries, cap, bf16)
        want = ivf_scan.ivf_float_prep_plain(probe, fills, queries, cap, bf16)
    else:
        int4 = dtype == "int4"
        got = ivf_scan.ivf_digit_prep(probe, fills, queries, cbias, cap, int4)
        want = ivf_scan.ivf_digit_prep_plain(probe, fills, queries, cbias,
                                             cap, int4)
    torch.cuda.synchronize()
    bad = [key for key, value in want.items()
           if (got[key] is None) != (value is None)
           or (value is not None and not torch.equal(got[key], value))]
    print(f"[ivf_prep] dtype={dtype} nprobe={nprobe} Q={queries.shape[0]} "
          f"n_sched={int(want['n_sched'])} member_count="
          f"{want['member_count'].tolist()} equal={not bad}", flush=True)
    if bad:
        fail(f"the {dtype} prologue differs from its plain twin in {bad}")


def check_ivf(results: dict) -> None:
    """The three IVF probe scans against their plain versions at 1M x 768,
    nlist 1024 (int8 / int4 exact; bf16 blocks scores within 1e-4, f32
    blocks (an f32 index of the same rows) within ``IVF_F32_TOL``, ids
    equal outside near-ties), each
    scan's prologue against its plain twin and its launches a call (at
    most 3 at k <= 128) at every case, then the IVF index against the flat
    exact scan at nprobe = nlist and its ``tune_nprobe(0.95)``."""
    import numpy as np
    import torch

    from tpu_search_torch.index.flat import FlatIndex
    from tpu_search_torch.index.ivf import probe_clusters
    from tpu_search_torch.ops import ivf_scan

    dev = torch.device("cuda")
    rows = ivf_corpus(dev)
    dead = np.random.default_rng(22).choice(IVF_N, IVF_N // 10, replace=False)
    indexes = build_ivf_indexes(rows, dead)
    qrng = np.random.default_rng(23)
    scans = {
        "bfloat16": ("ivf_topk", ivf_scan.ivf_topk_scan,
                     ivf_scan.ivf_topk_plain, "bf16"),
        "float32": ("ivf_topk", ivf_scan.ivf_topk_scan,
                    ivf_scan.ivf_topk_plain, "f32"),
        "int8": ("ivf_topk_int8", ivf_scan.ivf_topk_int8_scan,
                 ivf_scan.ivf_topk_int8_plain, "int8"),
        "int4": ("ivf_topk_int4", ivf_scan.ivf_topk_int4_scan,
                 ivf_scan.ivf_topk_int4_plain, "int8"),
    }
    for dtype in ("bfloat16", "float32", "int8", "int4"):
        index = indexes[dtype]
        name, scan, plain, kind = scans[dtype]
        pen, fills = index._penalty(None), index._device_fills()
        cap = index._cluster_capacity
        float_rows = dtype in ("bfloat16", "float32")
        blocks = index._dblocks
        f32 = dtype == "float32"
        tol = IVF_F32_TOL if f32 else TOL[name]
        worst = 0.0 if f32 else results.get(name, {}).get("max_abs_err", 0.0)
        tf32_err = None
        if not f32:
            print_scan_config(name)
        for nprobe in (8, 32):
            for q, k in IVF_CASES:
                queries = rows[torch.from_numpy(
                    qrng.choice(IVF_N, q, replace=False)).to(dev)]
                cs, probe = probe_clusters(queries, index._dcent, "ip", nprobe)
                cbias = None
                if float_rows:
                    args = (blocks, pen, fills, probe, queries, k)
                else:
                    cbias = torch.gather(cs, 1, probe.long())
                    args = (blocks, index._dscale, pen, fills, probe,
                            queries, k, cbias)
                check_ivf_prep(dtype, probe, fills, queries, cbias, cap,
                               nprobe)
                ks, ki = scan(*args)
                ps, pi = plain(*args)
                torch.cuda.synchronize()
                fin = torch.isfinite(ps)
                same_fin = bool(torch.equal(torch.isfinite(ks), fin))
                err = (float((ks[fin] - ps[fin]).abs().max())
                       if same_fin and bool(fin.any()) else
                       (0.0 if same_fin else float("inf")))
                if float_rows:
                    ok = err <= tol and bool(
                        ((ki == pi) | ((ks - ps).abs() <= tol)).all())
                else:
                    ok = bool(torch.equal(ks, ps)) and bool(torch.equal(ki, pi))
                live = index._dvalid.reshape(-1)[ki[ki >= 0].long()]
                if not bool(live.all()):
                    fail(f"{name} returned a tombstoned slot")
                tile_idx, clusters, n_sched = ivf_scan.build_probe_schedule(
                    probe, fills, cap, ivf_scan.IVF_TILE)
                n_sched = int(n_sched)
                pos = ivf_scan.probe_positions(probe, IVF_NLIST)
                members = int((pos[:, clusters[:n_sched].long()] >= 0).sum())
                sched_bytes = n_sched * ivf_scan.IVF_TILE * IVF_ROW_BYTES[dtype]
                digits = 1 if float_rows else 2
                bound_ms, by = bound(
                    sched_bytes + q * 768 * 4 + q * k * 8,
                    2 * digits * members * ivf_scan.IVF_TILE * 768, kind)
                kms, pms = paired_ms(lambda: scan(*args), lambda: plain(*args),
                                     iters=5)
                label = name + (" f32" if dtype == "float32" else "")
                dms, calls = device_breakdown(
                    f"{label} nprobe={nprobe} Q={q} k={k}",
                    lambda: scan(*args), calls=10)
                if k <= 128:
                    check_launches(label, calls)
                print(f"[{label}] N={IVF_N} nlist={IVF_NLIST} cap={cap} "
                      f"nprobe={nprobe} Q={q} k={k} max_abs_err={err:.3e} "
                      f"id_agreement={float((ki == pi).float().mean()):.6f} "
                      f"wrapper_ms={kms:.4f} plain_ms={pms:.4f} "
                      f"device_ms={dms:.4f} scheduled_tiles={n_sched} "
                      f"scheduled_bytes={sched_bytes} bound_ms={bound_ms:.4f} "
                      f"bound_by={by} ok={ok}", flush=True)
                if not ok:
                    fail(f"{name} disagrees with its plain version at "
                         f"nprobe={nprobe} Q={q} k={k}")
                worst = max(worst, err)
                if f32 and nprobe == 32 and q == 128 and k == 10:
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        ts, _ = plain(*args)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                    tf32_err = float((ts[fin] - ps[fin]).abs().max())
                if nprobe == 32 and q == 1 and k == 10 and not f32:
                    results[name] = {"ms": kms, "plain_ms": pms,
                                     "device_ms": dms, "bound_ms": bound_ms,
                                     "bound_by": by, "library_ms": None}
        if f32:
            print(f"[ivf_topk f32] cases={2 * len(IVF_CASES)} "
                  f"max_abs_err={worst:.3e} tol={IVF_F32_TOL:.0e} "
                  f"tf32_plain_err={tf32_err:.3e} ok={worst <= tol}",
                  flush=True)
            if worst > tol:
                fail(f"ivf_topk on f32 blocks errs {worst:.3e}")
        else:
            results[name]["max_abs_err"] = worst
        del blocks

    # The index: every list probed equals the flat exact scan; the tuned
    # nprobe meets its recall target.
    ivf = indexes["bfloat16"]
    del indexes
    flat = FlatIndex(768, dtype="bfloat16", device=dev)
    flat.add(rows)
    flat.remove(dead)
    qs = rows[torch.from_numpy(qrng.choice(IVF_N, 8, replace=False)).to(dev)]
    qs = qs.cpu().numpy()
    del rows
    fs, fi = flat.search(qs, 10)
    vs, vi = ivf.search(qs, 10, nprobe=IVF_NLIST)
    err = float(np.abs(fs - vs).max())
    same = bool(((fi == vi) | (np.abs(fs - vs) <= TOL["ivf_topk"])).all())
    print(f"[ivf_index] nprobe=nlist={IVF_NLIST} vs flat exact scan: "
          f"max_abs_err={err:.3e} id_agreement={float((fi == vi).mean()):.4f} "
          f"ids_equal_outside_near_ties={same}", flush=True)
    if err > TOL["ivf_topk"] or not same:
        fail("the IVF index at nprobe = nlist disagrees with the flat scan")
    del flat
    t0 = time.perf_counter()
    report = ivf.tune_nprobe(0.95)
    print(f"[ivf_index] tune_nprobe(0.95) {json.dumps(report)} seconds="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    if not report["tuned"] or report["recall"] < 0.95:
        fail(f"tune_nprobe did not reach recall 0.95: {report}")


PQ_M, PQ_NPROBE, PQ_CASES = 192, 32, (1, 8, 128)
# The [pq] scan against its float64 table lookup: f32 entries summed in
# another order (192 of them, each under 0.1) and f32 centroid scores.
PQ_TOL = 1e-4


def pq_table_lookup(index, queries, probe, k: int):
    """An independent reference of the pq probe scan: for each query, the
    float64 ADC table lookup ``sum_m LUT[m, code[n, m]]`` (the tables from
    ``q``, ``q @ R`` under OPQ, and the books in float64) over the rows of
    its probed clusters, plus the query's float64 centroid score, live
    rows only; ``(scores [Q, k] f64, ids [Q, k])``."""
    import torch

    m, _, dsub = index._pq_books.shape
    cap = index._cluster_capacity
    q64 = queries.double()
    cs = q64 @ index._dcent.double().T
    qr = q64 @ index._pq_rot.double() if index._pq_rot is not None else q64
    lut = torch.einsum("qmd,mkd->qmk", qr.reshape(-1, m, dsub),
                       index._pq_books.double())
    sub = torch.arange(m, device=queries.device)
    out_s, out_i = [], []
    for i in range(queries.shape[0]):
        cl = probe[i].long()
        b = index._dblocks[cl]  # [nprobe, cap/2, M]
        codes = torch.stack([b & 0x0F, b >> 4], dim=2).reshape(
            cl.shape[0], cap, m).long()
        scores = lut[i][sub, codes].sum(dim=-1) + cs[i, cl][:, None]
        scores = torch.where(index._dvalid[cl], scores,
                             torch.full_like(scores, float("-inf")))
        top, pos = torch.topk(scores.reshape(-1), k)
        slot = cl[pos // cap] * cap + pos % cap
        out_s.append(top)
        out_i.append(torch.where(torch.isfinite(top),
                                 index._dids.reshape(-1)[slot].long(),
                                 torch.full_like(slot, -1)))
    return torch.stack(out_s), torch.stack(out_i)


def check_pq() -> None:
    """The PQ tier at the IVF kernels' shape (``ivf_corpus``: 1M x 768
    clustered unit rows, nlist 1024, 10 % tombstoned): pq_m 192 indexes
    trained through ``IVFIndex.add`` (the coarse quantizer, then the books
    at the default sample; without OPQ, with it, and with an int8 refine
    tier at factor 4), each scan gated against :func:`pq_table_lookup` on
    8 queries (scores within ``PQ_TOL``, ids equal outside ties), recall@10
    against the exact f32 flat scan at nprobe 32 and 256 beside the share of
    the true top 10 in the probed lists (reported, not gated), and the scan's
    CUDA-event ms, device ms, launches a call and peak memory at Q 1, 8 and
    128, k 10, nprobe 32, beside the bytes bound (the probed codes)."""
    import numpy as np
    import torch

    from tpu_search_torch.index.ivf import IVFIndex, ivf_scan, probe_clusters

    dev = torch.device("cuda")
    rows = ivf_corpus(dev)
    dead = np.random.default_rng(22).choice(IVF_N, IVF_N // 10, replace=False)
    indexes = {}
    for tag, kwargs in (("pq", {}), ("pq_opq", {"opq": True}),
                        ("pq_refine", {"refine_dtype": "int8",
                                       "refine_factor": 4})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = IVFIndex(768, dtype="pq", nlist=IVF_NLIST, pq_m=PQ_M,
                         device=dev, **kwargs)
        index.add(rows)
        index.remove(dead)
        torch.cuda.synchronize()
        print(f"[pq_build] {tag} rows={index.ntotal} live={index.live} "
              f"pq_m={index.pq_m} opq={index._pq_rot is not None} "
              f"refine={index.refine_dtype} seconds="
              f"{time.perf_counter() - t0:.2f} cap={index._cluster_capacity} "
              f"bytes_per_row={index.pq_m // 2} padding="
              f"{json.dumps(index.padding_stats())}", flush=True)
        indexes[tag] = index
    qrng = np.random.default_rng(24)
    live = np.setdiff1d(np.arange(IVF_N), dead)

    # The gate: each codec's scan against the float64 table lookup.
    for tag in ("pq", "pq_opq"):
        index = indexes[tag]
        queries = rows[torch.from_numpy(qrng.choice(live, 8, replace=False))
                       .to(dev)]
        for k in (10, 128):
            _, probe = probe_clusters(queries, index._dcent, "ip", PQ_NPROBE)
            ks, ki = index._scan(queries, PQ_NPROBE, k, index._penalty(None))
            rs, ri = pq_table_lookup(index, queries, probe, k)
            torch.cuda.synchronize()
            fin = torch.isfinite(rs)
            same_fin = bool(torch.equal(torch.isfinite(ks), fin))
            err = float((ks[fin].double() - rs[fin]).abs().max()) if (
                same_fin) else float("inf")
            ties = bool(((ki.long() == ri)
                         | ((ks.double() - rs).abs() <= PQ_TOL)).all())
            ok = same_fin and err <= PQ_TOL and ties
            print(f"[pq] gate {tag} Q=8 k={k} nprobe={PQ_NPROBE} vs the "
                  f"float64 table lookup: max_abs_err={err:.3e} "
                  f"id_agreement={float((ki.long() == ri).float().mean()):.4f}"
                  f" ids_equal_outside_ties={ties} ok={ok}", flush=True)
            if not ok:
                fail(f"the {tag} scan disagrees with the float64 table "
                     f"lookup at k={k}")

    # Recall@10 against the exact f32 flat scan of the live rows.
    qs = rows[torch.from_numpy(qrng.choice(live, 64, replace=False)).to(dev)]
    alive = torch.ones(IVF_N, dtype=torch.bool, device=dev)
    alive[torch.from_numpy(dead).to(dev)] = False
    exact = torch.cat([qs @ rows[c0: c0 + 262144].T
                       for c0 in range(0, IVF_N, 262144)], dim=1)
    exact = torch.where(alive[None], exact, float("-inf"))
    truth = torch.topk(exact, 10, dim=1).indices.cpu().numpy()
    del exact
    qs_host = qs.cpu().numpy()
    for nprobe in (PQ_NPROBE, 8 * PQ_NPROBE):
        for tag, index in indexes.items():
            # The probe loss alone: the share of the true top 10 that lies
            # in the probed lists.
            _, probe = probe_clusters(qs, index._dcent, "ip", nprobe)
            home = index._slot_cluster[truth]
            ceiling = float(np.mean([np.isin(h, p).mean() for h, p in
                                     zip(home, probe.cpu().numpy())]))
            _, got = index.search(qs_host, 10, nprobe=nprobe)
            recall = float(np.mean([len(set(g) & set(t)) / 10
                                    for g, t in zip(got, truth)]))
            print(f"[pq] recall@10 {tag} nprobe={nprobe} refine_factor="
                  f"{index.refine_factor if index._refine else 0} vs exact "
                  f"f32 flat scan: {recall:.4f} (probed lists hold "
                  f"{ceiling:.4f} of the true top 10)", flush=True)

    # The scan's times on the plain codec: the whole device search
    # (centroid scan, tables, probe scan, slot -> id map).
    index = indexes["pq"]
    del indexes, rows
    scan_key, buffers = index.make_scan_fn(PQ_NPROBE)
    staged = index.scan_staged(None)
    cap = index._cluster_capacity
    for q in PQ_CASES:
        queries = torch.from_numpy(qs_host[np.arange(q) % 64]).to(dev)

        def call():
            return ivf_scan(scan_key, buffers, staged, queries, 10)

        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = cuda_ms(call, iters=10)
        dms, launches = device_breakdown(f"pq Q={q} k=10", call, calls=5)
        bound_ms, by = bound(q * PQ_NPROBE * cap * PQ_M / 2, 0, "f32")
        print(f"[pq] scan N={IVF_N} nlist={IVF_NLIST} cap={cap} pq_m={PQ_M} "
              f"nprobe={PQ_NPROBE} Q={q} k=10 ms={ms:.4f} device_ms={dms:.4f} "
              f"launches_per_call={launches:.1f} peak_mb={peak_mb:.1f} "
              f"bound_ms={bound_ms:.5f} bound_by={by}", flush=True)


# -- [sharded]: the sharded exact index, its shards co-located on the card --

# 1M unit rows over 4 shards on cuda:0 (250,000 rows a shard), 10 %
# tombstoned; the dtype / metric cases and the (Q, k) grid.  A row's score
# is one dot product in the same kernel on a shard and on one device, so
# scores are expected bit for bit; SHARDED_REL_TOL holds them where not.
SHARDED_N, SHARDED_SHARDS = 1_000_000, 4
SHARDED_CASES = (("bfloat16", "ip"), ("float32", "ip"), ("float32", "l2"),
                 ("int8", "ip"), ("int4", "ip"))
SHARDED_QS, SHARDED_KS = (1, 8, 128), (10, 128, 200)
SHARDED_REL_TOL = 1e-6


# The wrapper whose C calls a shard's scan counts, by storage dtype.
KERNEL_OF = {"bfloat16": "flat_topk", "float32": "flat_topk",
             "int8": "flat_topk_int8", "int4": "flat_topk_int4"}
# The scan kernel of each path [sharded_serving] loads over 4 shards.
PATH_KERNEL = {"bfloat16": "flat_topk", "ivf_int4": "ivf_topk_int4"}


def free_port() -> int:
    """A free local TCP port (its socket closed before the group binds)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def topk_error(got, want, rel_tol: float):
    """``(max abs error, max relative error, None or a fault)`` of
    ``(scores, ids)`` against ``want``: ids equal outside exact ties, i.e.
    a differing id must score, in ``want``, what ``got`` says (within
    ``rel_tol``; past ``want``'s k, ``want``'s last score)."""
    import numpy as np

    (gs, gi), (ws, wi) = got, want
    fin = np.isfinite(ws)
    if not np.array_equal(np.isfinite(gs), fin):
        return 0.0, 0.0, "a different number of live results"
    diff = np.abs(np.where(fin, gs - ws, 0.0))
    rel = diff / np.maximum(np.abs(np.where(fin, ws, 1.0)), 1e-30)
    for r in range(gi.shape[0]):
        scored = dict(zip(wi[r].tolist(), ws[r].tolist()))
        for j in np.nonzero(gi[r] != wi[r])[0]:
            other = scored.get(int(gi[r, j]), ws[r, -1])
            if abs(other - gs[r, j]) > rel_tol * max(abs(gs[r, j]), 1e-30):
                return float(diff.max()), float(rel.max()), (
                    f"query {r} rank {j}: id {gi[r, j]} against {wi[r, j]}, "
                    f"not a tie")
    return float(diff.max()), float(rel.max()), None


def sharded_plain(index, queries, k: int):
    """The 4-shard scan with every shard's plain version in place of its
    kernel, on the card, then the same merge."""
    import torch

    from tpu_search_torch.ops.topk_scan import (
        flat_topk_int4_plain,
        flat_topk_int8_plain,
        flat_topk_plain,
    )
    from tpu_search_torch.ops.int8_pack import unpack_int8_rows
    from tpu_search_torch.parallel.sharded_index import merge_shards

    penalties = index.device_mask(None)
    scores, ids = [], []
    for shard, penalty in zip(index._shards.values(), penalties):
        if index.dtype == "int8":
            ps, pi = flat_topk_int8_plain(unpack_int8_rows(shard._vectors),
                                          shard._scales, penalty, queries, k)
        elif index.dtype == "int4":
            ps, pi = flat_topk_int4_plain(shard._vectors, shard._scales,
                                          penalty, queries, k)
        else:
            ps, pi = flat_topk_plain(shard._vectors, penalty, queries, k,
                                     2.0 if index.metric == "l2" else 1.0)
        scores.append(ps)
        ids.append(pi)
    return merge_shards(scores, ids, k, index.n_shards)


def check_sharded() -> None:
    """``[sharded]``: a ``ShardedFlatIndex`` over ``build_mesh(n_data=4,
    devices=[cuda:0] * 4)`` at 1M x 768 (10 % tombstoned) in each of
    ``SHARDED_CASES``, held against the single-device ``FlatIndex`` on the
    same rows at Q 1, 8, 128 and k 10, 128, 200 (scores within
    ``SHARDED_REL_TOL`` relative, ids equal outside exact ties) and
    against its shards' plain versions and the same merge at Q 8, k 10
    and Q 128, k 200; per case and Q at k 10: the wrapper's ms and device
    ms, its kernels' C calls (one a shard) and device launches a call, the
    merge's ms and share, and the single-device index's ms.  Then a
    one-rank NCCL group (``initialize_distributed``): a search with it up
    gathers (``all_gather`` runs) and answers as without it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_search_torch.index.flat import FlatIndex, flat_scan
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import (
        ShardedFlatIndex,
        build_mesh,
        initialize_distributed,
        process_count,
    )
    from tpu_search_torch.parallel.sharded_index import (
        merge_shards,
        sharded_scan,
    )

    dev = torch.device("cuda")
    card = card_name()
    mesh = build_mesh(n_data=SHARDED_SHARDS, devices=[dev] * SHARDED_SHARDS)
    gen = torch.Generator(device=dev).manual_seed(31)
    rows = unit_rows(gen, SHARDED_N, 768)
    dead = np.random.default_rng(32).choice(SHARDED_N, SHARDED_N // 10,
                                            replace=False)
    queries = {q: unit_rows(gen, q, 768) for q in SHARDED_QS}
    kept = {}
    for dtype, metric in SHARDED_CASES:
        tag = f"{dtype}_{metric}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = ShardedFlatIndex.from_device_vectors(
            rows, mesh, metric=metric, dtype=dtype)
        sharded.remove(dead)
        single = FlatIndex(768, metric=metric, dtype=dtype, device=dev)
        single.add(rows)
        single.remove(dead)
        torch.cuda.synchronize()
        print(f"[sharded_build] case={tag} rows={sharded.ntotal} "
              f"live={sharded.live} shards={sharded.n_shards} "
              f"local_capacity={sharded._local_capacity} "
              f"seconds={time.perf_counter() - t0:.2f}", flush=True)
        if sharded.live != single.live:
            fail(f"[sharded] {tag}: {sharded.live} live rows, one device "
                 f"{single.live}")
        worst_abs = worst_rel = 0.0
        for q, k in itertools.product(SHARDED_QS, SHARDED_KS):
            qs = queries[q].cpu().numpy()
            got, want = sharded.search(qs, k), single.search(qs, k)
            err, rel, fault = topk_error(got, want, SHARDED_REL_TOL)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if fault or rel > SHARDED_REL_TOL:
                fail(f"[sharded] {tag} Q={q} k={k} disagrees with one "
                     f"device: {fault or f'relative error {rel:.3e}'}")
            if dtype == "bfloat16" and (q, k) == (8, 10):
                kept = {"index": sharded, "queries": qs, "answer": got}
        scores = "bit for bit" if worst_abs == 0.0 else "within tolerance"
        print(f"[sharded] case={tag} against_one_device "
              f"max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} "
              f"scores={scores} (Q {SHARDED_QS}, k {SHARDED_KS})",
              flush=True)
        for q, k in ((8, 10), (128, 200)):
            scan_key, buffers = sharded.make_scan_fn()
            staged = sharded.device_mask(None)
            ks, ki = sharded_scan(scan_key, buffers, staged, queries[q], k)
            ps, pi = sharded_plain(sharded, queries[q], k)
            torch.cuda.synchronize()
            exact = dtype in ("int8", "int4")
            tol = 0.0 if exact else TOL["flat_topk"]
            err, _, fault = topk_error(
                (ks.cpu().numpy(), ki.cpu().numpy()),
                (ps.cpu().numpy(), pi.cpu().numpy()), 1e-5 if not exact
                else 0.0)
            print(f"[sharded] case={tag} Q={q} k={k} against_plain "
                  f"max_abs_err={err:.3e} tol={tol:.1e}", flush=True)
            if fault or err > tol:
                fail(f"[sharded] {tag} Q={q} k={k} disagrees with its "
                     f"plain version: {fault or err}")
        scan_key, buffers = sharded.make_scan_fn()
        staged = sharded.device_mask(None)
        skey, sbuf = single.make_scan_fn()
        sstaged = single.scan_staged(None)
        for q in SHARDED_QS:
            qt = queries[q]

            def call():
                return sharded_scan(scan_key, buffers, staged, qt, 10)

            def one():
                return flat_scan(skey, sbuf, sstaged, qt, 10)

            parts = [flat_scan(("flat", dtype, metric),
                               buffers[2 * i: 2 * i + 2], (staged[i],), qt,
                               10) for i in range(SHARDED_SHARDS)]
            part_s = [p[0] for p in parts]
            part_i = [p[1] for p in parts]

            def merge():
                return merge_shards(part_s, part_i, 10, SHARDED_SHARDS)

            before = _build.LAUNCHES[KERNEL_OF[dtype]]
            call()
            calls_per = _build.LAUNCHES[KERNEL_OF[dtype]] - before
            ms, single_ms = paired_ms(call, one)
            merge_ms = cuda_ms(merge)
            dms, launches = device_breakdown(f"sharded {tag} Q={q} k=10",
                                             call, calls=10)
            print(f"[sharded] case={tag} shards={SHARDED_SHARDS} "
                  f"rows={SHARDED_N} Q={q} k=10 wrapper_ms={ms:.4f} "
                  f"device_ms={dms:.4f} kernel_calls_per_call={calls_per} "
                  f"device_launches_per_call={launches:.1f} "
                  f"merge_ms={merge_ms:.4f} merge_share="
                  f"{merge_ms / ms:.3f} single_device_ms={single_ms:.4f} "
                  f"card=\"{card}\"", flush=True)
            if calls_per != SHARDED_SHARDS:
                fail(f"[sharded] {tag}: {calls_per} kernel calls a search, "
                     f"want one a shard")
        del sharded, single
        torch.cuda.empty_cache()

    # The process group: one rank, NCCL, a free local port.
    t0 = time.perf_counter()
    initialize_distributed(coordinator_address=f"localhost:{free_port()}",
                           num_processes=1, process_id=0)
    init_s = time.perf_counter() - t0
    try:
        if dist.get_backend() != "nccl" or process_count() != 1:
            fail(f"[sharded] the group is {dist.get_backend()} with "
                 f"{process_count()} ranks")
        with counted_collectives() as calls:
            got = kept["index"].search(kept["queries"], 10)
        gathers = calls.get("all_gather", 0)
        same = all(np.array_equal(a, b) for a, b in zip(got, kept["answer"]))
        print(f"[sharded] process_group backend={dist.get_backend()} "
              f"ranks={process_count()} init_seconds={init_s:.3f} "
              f"all_gather_calls={gathers} same_answer={same}",
              flush=True)
        if not gathers or not same:
            fail("[sharded] the search under the one-rank group did not "
                 "gather, or answered otherwise")
    finally:
        dist.destroy_process_group()
    kept.clear()
    torch.cuda.empty_cache()


# -- [sharded_ivf]: the sharded IVF index, its shards co-located on the card --

# The [ivf] phase's corpus and lists over 4 shards on cuda:0; the dtype /
# metric / refine cases (pq at the [pq] phase's pq_m), the Q grid at k 10
# and nprobe 32.  A row's score comes from the same kernel on a shard and
# on one device; SHARDED_REL_TOL holds the scores where they differ.
SIVF_CASES = (("bfloat16", "ip", {}), ("float32", "ip", {}),
              ("float32", "l2", {}), ("int8", "ip", {}), ("int4", "ip", {}),
              ("int4", "ip", {"refine_dtype": "int8", "refine_factor": 4}),
              ("pq", "ip", {"pq_m": PQ_M}))
SIVF_QS, SIVF_NPROBE = (1, 8, 128), 32
# The wrapper whose C calls a shard's IVF scan counts (pq: none, plain).
IVF_KERNEL_OF = {"bfloat16": "ivf_topk", "float32": "ivf_topk",
                 "int8": "ivf_topk_int8", "int4": "ivf_topk_int4"}


def sivf_tag(dtype: str, metric: str, extra: dict) -> str:
    return f"{dtype}_{metric}" + ("_refine" if extra.get("refine_dtype")
                                  else "")


def shard_scan_against_plain(index, queries, k: int, tag: str) -> float:
    """Each shard's probe scan (the kernel's wrapper, one C call) against
    its plain twin on the same inputs: int8 / int4 exact, bf16 blocks
    within ``TOL["ivf_topk"]``, f32 within ``IVF_F32_TOL`` (ids equal
    outside near-ties); pq's plain scan against its float64 table lookup
    within ``PQ_TOL``.  Returns the worst error."""
    import torch

    from tpu_search_torch.index.ivf import probe_clusters
    from tpu_search_torch.ops import ivf_scan

    worst = 0.0
    staged = index.scan_staged(None)
    for i, shard in enumerate(index._shards.values()):
        penalty, fills = staged[2 * i], staged[2 * i + 1]
        cs, probe = probe_clusters(queries, shard._dcent, index.metric,
                                   SIVF_NPROBE)
        cbias = torch.gather(cs, 1, probe.long()) if index.by_residual else (
            None)
        if index.dtype == "pq":
            _, books = shard._codec()
            from tpu_search_torch.ops.pq import ivf_pq_topk, pq_query_lut

            ks, ki = ivf_pq_topk(shard._dblocks, penalty, probe,
                                 pq_query_lut(queries, *books), k, cbias)
            ki = shard._dids.reshape(-1)[ki.clamp(min=0).long()]
            rs, ri = pq_table_lookup(shard, queries, probe, k)
            fin = torch.isfinite(rs)
            err = float((ks[fin].double() - rs[fin]).abs().max())
            ok = bool(torch.equal(torch.isfinite(ks), fin)) and (
                err <= PQ_TOL) and bool(
                    ((ki.long() == ri) | ((ks.double() - rs).abs()
                                          <= PQ_TOL)).all())
        else:
            if index.dtype in ("bfloat16", "float32"):
                args = (shard._dblocks, penalty, fills, probe, queries, k,
                        2.0 if index.metric == "l2" else 1.0)
                scan, plain = ivf_scan.ivf_topk_scan, ivf_scan.ivf_topk_plain
            else:
                args = (shard._dblocks, shard._dscale, penalty, fills, probe,
                        queries, k, cbias)
                scan, plain = ((ivf_scan.ivf_topk_int8_scan,
                                ivf_scan.ivf_topk_int8_plain)
                               if index.dtype == "int8" else
                               (ivf_scan.ivf_topk_int4_scan,
                                ivf_scan.ivf_topk_int4_plain))
            ks, ki = scan(*args)
            ps, pi = plain(*args)
            torch.cuda.synchronize()
            fin = torch.isfinite(ps)
            same_fin = bool(torch.equal(torch.isfinite(ks), fin))
            err = (float((ks[fin] - ps[fin]).abs().max())
                   if same_fin and bool(fin.any()) else
                   (0.0 if same_fin else float("inf")))
            if index.dtype in ("int8", "int4"):
                ok = bool(torch.equal(ks, ps)) and bool(torch.equal(ki, pi))
            else:
                tol = (IVF_F32_TOL if index.dtype == "float32"
                       else TOL["ivf_topk"])
                ok = err <= tol and bool(
                    ((ki == pi) | ((ks - ps).abs() <= tol)).all())
        worst = max(worst, err)
        if not ok:
            fail(f"[sharded_ivf] {tag} shard {i} Q={queries.shape[0]} k={k}: "
                 f"the scan disagrees with its plain version ({err:.3e})")
    return worst


def check_sharded_ivf() -> None:
    """``[sharded_ivf]``: a ``ShardedIVFIndex`` over ``build_mesh(n_data=4,
    devices=[cuda:0] * 4)`` at the ``[ivf]`` phase's size (1M x 768
    clustered unit rows, nlist 1024, 10 % tombstoned) in each of
    ``SIVF_CASES``, sharing one set of centroids (and pq books) with a
    single-device ``IVFIndex`` on the same rows: the two against each other
    at Q 1, 8, 128, k 10 and Q 8, k 128, nprobe 32 (scores within
    ``SHARDED_REL_TOL`` relative, reported bit for bit where they are; ids
    equal outside exact ties); each shard's scan against its plain twin at
    Q 8 and 128 (:func:`shard_scan_against_plain`); per case and Q at k 10:
    the kernels' C calls a search (one a shard), the wrapper's ms and
    device ms and device launches a call beside the single-device index's
    ms, the merge's ms and, with the refine tier, the rescore's.  Then a
    one-rank NCCL group: a search with it up gathers and answers alike."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_search_torch.index.ivf import IVFIndex, ivf_scan
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.pq import train_pq_for_ivf
    from tpu_search_torch.parallel import (
        ShardedIVFIndex,
        build_mesh,
        initialize_distributed,
    )
    from tpu_search_torch.parallel.sharded_index import run_stage
    from tpu_search_torch.parallel.sharded_ivf import (
        card_plan,
        merge_global,
        sharded_ivf_scan,
    )

    dev = torch.device("cuda")
    card = card_name()
    mesh = build_mesh(n_data=SHARDED_SHARDS, devices=[dev] * SHARDED_SHARDS)
    rows = ivf_corpus(dev)
    dead = np.random.default_rng(22).choice(IVF_N, IVF_N // 10, replace=False)
    live = np.setdiff1d(np.arange(IVF_N), dead)
    qrng = np.random.default_rng(25)
    queries = {q: rows[torch.from_numpy(qrng.choice(live, q, replace=False))
                       .to(dev)] for q in SIVF_QS}
    t0 = time.perf_counter()
    trainer = IVFIndex(768, nlist=IVF_NLIST, device=dev)
    trainer.train(rows[:500_000])
    centroids = trainer.centroids
    books = train_pq_for_ivf(rows[:500_000], trainer._dcent, "ip", PQ_M,
                             by_residual=True, seed=0)
    del trainer
    torch.cuda.synchronize()
    print(f"[sharded_ivf] trained nlist={IVF_NLIST} books pq_m={PQ_M} "
          f"seconds={time.perf_counter() - t0:.2f}", flush=True)
    kept = {}
    for dtype, metric, extra in SIVF_CASES:
        tag = sivf_tag(dtype, metric, extra)
        built = []
        for make in (
                lambda: IVFIndex(768, metric=metric, dtype=dtype,
                                 nlist=IVF_NLIST, device=dev, **extra),
                lambda: ShardedIVFIndex(768, mesh, metric=metric, dtype=dtype,
                                        nlist=IVF_NLIST, **extra)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = make()
            index.centroids = centroids
            if dtype == "pq":
                index._pq_books = books
            index.add(rows)
            index.remove(dead)
            torch.cuda.synchronize()
            built.append(time.perf_counter() - t0)
            if isinstance(index, ShardedIVFIndex):
                sharded = index
            else:
                single = index
        print(f"[sharded_ivf_build] case={tag} rows={sharded.ntotal} "
              f"live={sharded.live} shards={sharded.n_shards} "
              f"local_capacity={sharded._local_capacity} one_device_cap="
              f"{single._cluster_capacity} seconds={built[1]:.2f} "
              f"one_device_seconds={built[0]:.2f} max_shard_fill="
              f"{sharded.padding_stats()['max_shard_fill']}", flush=True)
        if sharded.live != single.live:
            fail(f"[sharded_ivf] {tag}: {sharded.live} live rows, one "
                 f"device {single.live}")
        worst_abs = worst_rel = 0.0
        for q, k in [(q, 10) for q in SIVF_QS] + [(8, 128)]:
            qs = queries[q].cpu().numpy()
            got = sharded.search(qs, k, nprobe=SIVF_NPROBE)
            want = single.search(qs, k, nprobe=SIVF_NPROBE)
            err, rel, fault = topk_error(got, want, SHARDED_REL_TOL)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if fault or rel > SHARDED_REL_TOL:
                fail(f"[sharded_ivf] {tag} Q={q} k={k} disagrees with one "
                     f"device: {fault or f'relative error {rel:.3e}'}")
            if tag == "int4_ip_refine" and (q, k) == (8, 10):
                kept = {"index": sharded, "queries": qs, "answer": got}
        scores = "bit for bit" if worst_abs == 0.0 else "within tolerance"
        print(f"[sharded_ivf] case={tag} against_one_device "
              f"max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} "
              f"scores={scores} (Q {SIVF_QS} k 10, Q 8 k 128, nprobe "
              f"{SIVF_NPROBE})", flush=True)
        plain_err = max(shard_scan_against_plain(sharded, queries[q], 10, tag)
                        for q in (8, 128))
        print(f"[sharded_ivf] case={tag} shard scans against their plain "
              f"versions (Q 8, 128, k 10): max_abs_err={plain_err:.3e}",
              flush=True)
        scan_key, buffers = sharded.make_scan_fn(SIVF_NPROBE)
        staged = sharded.scan_staged(None)
        skey, sbuf = single.make_scan_fn(SIVF_NPROBE)
        sstaged = single.scan_staged(None)
        kernel = IVF_KERNEL_OF.get(dtype)
        for q in SIVF_QS:
            qt = queries[q]

            def call():
                return sharded_ivf_scan(scan_key, buffers, staged, qt, 10)

            def one():
                return ivf_scan(skey, sbuf, sstaged, qt, 10)

            coarse = scan_key[:8] + (0,) + scan_key[9:]
            k_coarse = 10 if not scan_key[8] else max(10, min(
                10 * scan_key[8], SIVF_NPROBE * sharded._local_capacity))
            stride = 6 if dtype == "pq" else 4
            parts = [sharded_ivf_scan(
                coarse[:2] + ((s,),) + coarse[3:],
                buffers[stride * i: stride * (i + 1)],
                staged[2 * i: 2 * i + 2], qt, k_coarse)
                for i, s in enumerate(sharded._shards)]
            part_s = [p[0] for p in parts]
            part_i = [p[1] for p in parts]

            def merge():
                return merge_global(part_s, part_i, k_coarse)

            merge_ms = cuda_ms(merge)
            rescore = ""
            if scan_key[8]:
                merged = merge()[1]
                plan = card_plan(scan_key, buffers, staged, 10)

                def rescore_call():  # the search's rescore stage
                    return run_stage(plan, plan.stages[1], (qt, merged))

                r_ms = cuda_ms(rescore_call)
                rescore = f"rescore_ms={r_ms:.4f} "
            before = dict(_build.LAUNCHES)
            call()
            calls_per = (_build.LAUNCHES[kernel] - before[kernel]
                         if kernel else 0)
            ms, single_ms = paired_ms(call, one)
            dms, launches = device_breakdown(f"sharded_ivf {tag} Q={q} k=10",
                                             call, calls=10)
            print(f"[sharded_ivf] case={tag} shards={SHARDED_SHARDS} "
                  f"rows={IVF_N} nlist={IVF_NLIST} nprobe={SIVF_NPROBE} "
                  f"Q={q} k=10 wrapper_ms={ms:.4f} device_ms={dms:.4f} "
                  f"kernel={kernel} kernel_calls_per_call={calls_per} "
                  f"device_launches_per_call={launches:.1f} merge_ms="
                  f"{merge_ms:.4f} merge_share={merge_ms / ms:.3f} {rescore}"
                  f"single_device_ms={single_ms:.4f} card=\"{card}\"",
                  flush=True)
            if kernel and calls_per != SHARDED_SHARDS:
                fail(f"[sharded_ivf] {tag}: {calls_per} kernel calls a "
                     f"search, want one a shard")
        if tag != "int4_ip_refine":
            del sharded
        del single
        torch.cuda.empty_cache()

    # The process group: one rank, NCCL, a free local port.
    initialize_distributed(coordinator_address=f"localhost:{free_port()}",
                           num_processes=1, process_id=0)
    try:
        with counted_collectives() as calls:
            got = kept["index"].search(kept["queries"], 10,
                                       nprobe=SIVF_NPROBE)
        gathers, reduces = (calls.get(name, 0)
                            for name in ("all_gather", "all_reduce"))
        same = all(np.array_equal(a, b) for a, b in zip(got, kept["answer"]))
        print(f"[sharded_ivf] process_group backend={dist.get_backend()} "
              f"case=int4_ip_refine all_gather_calls={gathers} "
              f"all_reduce_calls={reduces} same_answer={same}",
              flush=True)
        if not gathers or not reduces or not same:
            fail("[sharded_ivf] the search under the one-rank group did not "
                 "gather and reduce, or answered otherwise")
    finally:
        dist.destroy_process_group()
    kept.clear()
    del rows
    torch.cuda.empty_cache()


def sharded_answers_error(got_all, want_all, tag: str) -> None:
    """Fails unless each answer equals the single-device one: the same
    ids (an id may differ only in an exact tie), similarities within
    ``WARM_EXACT``."""
    for i, (got, want) in enumerate(zip(got_all, want_all)):
        error = answer_error(got, want, WARM_EXACT)
        if error:
            fail(f"[sharded_serving] {tag} query {i}: {error}")


def run_sharded_serving(engine, work: Path, total: int,
                        data: Optional[Path] = None,
                        tag: str = "bfloat16") -> dict:
    """The engine's index (saved first: the warm phase added and removed a
    conversation) loaded over 4 shards on cuda:0 into its storage: the flat
    bf16 path's with ``ShardedFlatIndex.load``, an IVF path's (``tag``
    ``ivf_int4``: with its int8 refine tier) with ``ShardedIVFIndex.load``.
    The 20 probe queries through ``search_conversations`` twice, cold and
    warm, timed beside a pass on the single-device index just before, with
    a lone query's replay profiled on both (the fused path: one CUDA graph
    a window shape, the 4 shard scans, the merge and any rescore inside),
    and through the classic path (the same embedding against both
    indexes), each equal to the single-device answer; the warm server's
    answers to the 16 unfiltered probes one at a time, each equal to the
    in-process one; the sharded index saved and loaded into a
    single-device index, answering as before.  The single-device index is
    put back at the end.  Returns the launch counts of the sharded
    passes (set to 0 just before them)."""
    import torch

    from tpu_search_torch.index.registry import load_index
    from tpu_search_torch.interfaces.query_server import QueryServer
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import (
        ShardedFlatIndex,
        ShardedIVFIndex,
        build_mesh,
    )
    from tpu_search_torch.storage.hybrid import SearchConfig

    dev = torch.device("cuda")
    storage = engine.storage
    data = data or work / "data"
    ivf = tag.startswith("ivf")
    sharded_cls = ShardedIVFIndex if ivf else ShardedFlatIndex
    kernel = PATH_KERNEL[tag]
    name = f"sharded_{tag}"
    storage.save_index()
    _, queries = probe_queries(engine, total)

    def timed_pass():
        times, answers = [], []
        for text, filters, _ in queries:
            t1 = time.perf_counter()
            answers.append(engine.search_conversations(text, filters,
                                                       top_k=10))
            times.append(((time.perf_counter() - t1) * 1e3, bool(filters)))
        return times, answers

    single = storage.index
    times, want = timed_pass()
    print_latency(tag, "one device, fused in process", times,
                  phase="sharded_serving")
    texts = [t for t, f, _ in queries if f is None]
    profile_replays(engine, texts, phase=f"sharded_serving {tag} one device")
    cfg = SearchConfig(top_k=10, include_metadata=True, include_text=True)
    embeddings = [engine.embedder.generate_single_embedding(t)
                  for t, _, _ in queries]
    want_classic = [storage.search(e, cfg, f)
                    for e, (_, f, _) in zip(embeddings, queries)]

    mesh = build_mesh(n_data=SHARDED_SHARDS, devices=[dev] * SHARDED_SHARDS)
    t0 = time.perf_counter()
    sharded = sharded_cls.load(str(storage.index_path), mesh)
    refine = getattr(sharded, "_refine", None)
    print(f"[sharded_serving] path={tag} load rows={sharded.ntotal} "
          f"live={sharded.live} shards={sharded.n_shards} local_capacity="
          f"{sharded._local_capacity} refine="
          f"{refine.count if refine is not None else 0} seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    storage.index = sharded
    storage._data_version += 1
    try:
        _build.reset_launches()
        torch.cuda.synchronize()
        captures = engine._fused.captures
        window = engine._fused_window([queries[0][0]], None, cfg)
        want_key = "sharded_ivf" if ivf else "sharded_flat"
        if window is None or window.scan_key[0] != want_key:
            fail(f"[sharded_serving] {tag}: the fused path declined the "
                 f"co-located shards")
        if ivf and refine is not None and refine.count and (
                not window.scan_key[8]):
            fail(f"[sharded_serving] {tag}: the fused window left out the "
                 f"refine tier")
        cold, got = timed_pass()
        warm, again = timed_pass()
        fused_launches = dict(_build.LAUNCHES)
        new = engine._fused.captures - captures
        replay = {}
        for program in engine._fused._programs.values():
            if program.launches.get(kernel) == SHARDED_SHARDS:
                replay = program.launches
        print(f"[sharded_serving] path={tag} fused captures={new} "
              f"programs={len(engine._fused)} replay_launches={replay} "
              f"launches={fused_launches}", flush=True)
        for what, times in (("cold", cold), ("warm", warm)):
            print_latency(name, f"fused in process {what}", times,
                          phase="sharded_serving")
        if not replay or fused_launches[kernel] == 0:
            fail(f"[sharded_serving] {tag}: no fused replay ran the 4 shard "
                 f"scans")
        sharded_answers_error(got, want, f"{tag} fused")
        sharded_answers_error(again, want, f"{tag} fused, warm")
        profile_replays(engine, texts,
                        phase=f"sharded_serving {tag} 4 shards")
        grouped_window(engine, queries, timed_pass, again, warm, tag)
        got_classic = [storage.search(e, cfg, f)
                       for e, (_, f, _) in zip(embeddings, queries)]
        for i, (a, b) in enumerate(zip(got_classic, want_classic)):
            error = answer_error(
                [{"chunk_id": r.chunk_id, "similarity": r.similarity}
                 for r in a],
                [{"chunk_id": r.chunk_id, "similarity": r.similarity}
                 for r in b], WARM_EXACT)
            if error:
                fail(f"[sharded_serving] {tag} classic query {i}: {error}")

        unfiltered = [(q, a) for q, a in zip(queries, got) if q[1] is None]
        server = QueryServer(engine, str(data))
        server.start()
        try:
            times = warm_one_at_a_time(data, [q for q, _ in unfiltered],
                                       [a for _, a in unfiltered], name)
        finally:
            server.stop()
        print_latency(name, "warm server clients=1", times,
                      phase="sharded_serving")
        launches = dict(_build.LAUNCHES)
        print(f"[launches] path=sharded_serving_{tag} {launches}", flush=True)
        if any(launches[k] == 0 for k in path_kernels(tag)):
            fail(f"the sharded {tag} serving path did not run every "
                 f"kernel: {launches}")

        path = work / f"sharded_save_{tag}.tpuidx"
        sharded.save(str(path))
        storage.index = load_index(str(path), device=dev)
        storage._data_version += 1
        back = [engine.search_conversations(t, f, top_k=10)
                for t, f, _ in queries]
        sharded_answers_error(back, want, f"{tag} saved sharded, loaded on "
                              "one device")
        print(f"[sharded_serving] path={tag} answers equal to one device: "
              f"fused=20 classic=20 warm={len(unfiltered)} "
              f"after_save_load=20 card=\"{card_name()}\"", flush=True)
        return launches
    finally:
        storage.index = single
        storage._data_version += 1
        engine._fused.clear()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def counted_collectives():
    """Counts the ``torch.distributed`` collectives called in the block
    (``all_gather``, ``all_reduce``, ``broadcast``), by name."""
    import torch.distributed as dist

    calls: dict = {}
    real = {name: getattr(dist, name)
            for name in ("all_gather", "all_reduce", "broadcast")}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in real:
        setattr(dist, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def grouped_window(engine, queries, timed_pass, want, ungrouped,
                   tag: str) -> None:
    """``[sharded_serving]``'s index under a one-rank NCCL group
    (``initialize_distributed``): its mesh gathers, so the fused window
    takes the 4 shards as a ``CardPlan`` whose stages gather the ranks'
    results as a program step between graph replays (and, IVF + refine,
    sum the rescore).  The 20 queries in a cold and a warm pass: each
    answer equal to the same window's without the group (``want``: ids
    equal, similarities within ``WARM_EXACT``), the collectives a search,
    p50 beside the ungrouped window's; the window of 1 and of 9 queries
    replayed against its eager run (the eager run gathers too)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_search_torch.api.fused import run_eager
    from tpu_search_torch.parallel import initialize_distributed
    from tpu_search_torch.storage.hybrid import SearchConfig

    t0 = time.perf_counter()
    initialize_distributed(coordinator_address=f"localhost:{free_port()}",
                           num_processes=1, process_id=0)
    init_s = time.perf_counter() - t0
    try:
        cfg = SearchConfig(top_k=10)
        window = engine._fused_window([queries[0][0]], None, cfg)
        plan = None if window is None or window.plan is None else (
            window.plan(window.scan_key, window.buffers, window.staged,
                        window.k, merge_device=window.device))
        if plan is None or any(s.collective is None for s in plan.stages):
            fail(f"[sharded_serving] {tag}: under the one-rank NCCL group "
                 f"the fused window is not a plan that gathers: {window!r}")
        captures = engine._fused.captures
        with counted_collectives() as calls:
            cold, got = timed_pass()
            cold_calls = dict(calls)
            calls.clear()
            warm, again = timed_pass()
        gap = 0.0
        for i, (a, b) in enumerate(zip(got + again, want + want)):
            if [r["chunk_id"] for r in a] != [r["chunk_id"] for r in b]:
                fail(f"[sharded_serving] {tag} query {i % len(want)}: the "
                     f"grouped window's ids differ from the ungrouped")
            gap = max(gap, max_sim_gap(a, b))
        if gap > WARM_EXACT:
            fail(f"[sharded_serving] {tag}: the grouped window is {gap:.3e} "
                 f"from the ungrouped")
        texts = [t for t, f, _ in queries if f is None]
        replay = []
        for q in (1, 9):
            window = engine._fused_window(texts[:q], None, cfg)
            engine._fused_dispatch_many(texts[:q], None, cfg)
            pending = engine._fused_dispatch_many(texts[:q], None, cfg)
            pending.event.synchronize()
            eager = run_eager(window).cpu()
            equal = bool(torch.equal(pending.packed, eager))
            replay.append(f"q={q}:equal={equal}:max_abs_diff="
                          f"{float((pending.packed - eager).abs().max()):.3e}")
            if not equal:
                fail(f"[sharded_serving] {tag}: the grouped replay differs "
                     f"from its eager run at q={q}")
        n = len(queries)
        p50 = float(np.median([t for t, _ in warm]))
        p50_ungrouped = float(np.median([t for t, _ in ungrouped]))
        print(f"[sharded_serving] path={tag} process_group backend="
              f"{dist.get_backend()} ranks={dist.get_world_size()} "
              f"init_seconds={init_s:.3f} window=plan stages="
              f"{len(plan.stages)} cards={len(plan.cards)} captures="
              f"{engine._fused.captures - captures} collectives_a_search="
              + ",".join(f"{k}:{v / n:.2f}" for k, v in sorted(calls.items()))
              + f" cold_pass_collectives={json.dumps(cold_calls)} "
              f"max_abs_diff_vs_ungrouped={gap:.3e} ids_equal=True "
              f"replay_vs_eager={' '.join(replay)} warm_p50_ms={p50:.3f} "
              f"ungrouped_warm_p50_ms={p50_ungrouped:.3f} seconds="
              f"{time.perf_counter() - t0:.2f} "
              f'card="{card_name()}"', flush=True)
        print_latency(f"sharded_{tag}", "fused under a one-rank NCCL group, "
                      "warm", warm, phase="sharded_serving")
        if not calls.get("all_gather"):
            fail(f"[sharded_serving] {tag}: the grouped searches gathered "
                 f"nothing")
    finally:
        dist.destroy_process_group()
        engine._fused.clear()


# -- --cross-card: one shard on each card of the machine -------------------------

CROSS_CARD_CONVERSATIONS = 200


def host_ms(fn, iters: int = 10) -> float:
    """Mean host milliseconds of ``fn`` (a call that ends on the host)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- [train], [f32_encoder], [dryrun]: the trainer, f32 compute, the dry run --

# Fine-tuning a retriever on the chunks it indexes: 32 query/doc pairs of
# all-mpnet-base-v2 at full width (seeded random weights), queries at the
# query bucket (S 64), documents at a chunk bucket (S 256), bf16 compute
# over f32 master weights; 5 AdamW steps on one fixed batch.
TRAIN_PAIRS = 32
TRAIN_QUERY_S, TRAIN_DOC_S = 64, 256
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
# Each parameter's gradient with the kernels against the same step with the
# plain attention (autograd of the plain forward) on the card.  k's bias is
# left out of the cosine: a constant added to every key of a row changes no
# softmax, so its exact gradient is 0 and both sides hold rounding residue
# with no direction to compare; its norm is held under TRAIN_NOISE of the
# largest gradient norm instead.
TRAIN_GRAD_COS = 0.999
TRAIN_NOISE = 1e-3
# The f32 encoder on the card against the same checkpoint on the CPU.
F32_ENCODER_COS = 0.99999


def train_batch(config, dev, query_s: int = TRAIN_QUERY_S,
                doc_s: int = TRAIN_DOC_S):
    """32 query/doc pairs of seeded token ids (queries of ``query_s``
    tokens, documents of ``doc_s``); each document opens with its query's
    live tokens, the rest random; random lengths padded with pad ids under
    mask 0."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(41)
    pad = config.pad_token_id

    def rows(s, lo):
        ids = torch.randint(5, config.vocab_size, (TRAIN_PAIRS, s),
                            generator=gen)
        lengths = torch.randint(lo, s + 1, (TRAIN_PAIRS,), generator=gen)
        live = torch.arange(s)[None, :] < lengths[:, None]
        return torch.where(live, ids, pad), live.to(torch.int32)

    q_ids, q_mask = rows(query_s, 8)
    d_ids, d_mask = rows(doc_s, query_s)
    d_ids[:, :query_s] = torch.where(q_mask.bool(), q_ids,
                                     d_ids[:, :query_s])
    return tuple(t.to(dev) for t in (q_ids, q_mask, d_ids, d_mask))


def grad_cosines(a: dict, b: dict, what: str,
                 k_bias_tol: Optional[float] = None) -> float:
    """The least cosine between the two gradients of each parameter (k's
    bias held to its noise bound instead, see ``TRAIN_NOISE``; with
    ``k_bias_tol``, its two gradients within that share of the largest
    |value| of the same layer's q bias gradient in ``b``, see
    ``FLASH_K_BIAS_TOL``)."""
    top = max(float(g.norm()) for g in b.values())
    worst = 1.0
    for name, ga in a.items():
        gb = b[name]
        if name.endswith(".k.bias") and k_bias_tol is not None:
            scale = float(b[name[:-len("k.bias")] + "q.bias"].abs().max())
            if float((ga - gb).abs().max()) > k_bias_tol * scale:
                fail(f"[train] {what}: {name}'s gradients differ by more "
                     f"than {k_bias_tol} of the q bias's scale")
            continue
        if name.endswith(".k.bias"):
            if max(float(ga.norm()), float(gb.norm())) > TRAIN_NOISE * top:
                fail(f"[train] {what}: {name}'s gradient is not residue")
            continue
        cos = float((ga * gb).sum() / (ga.norm() * gb.norm()).clamp(
            min=1e-30))
        if float(ga.norm()) == float(gb.norm()) == 0.0:
            cos = 1.0
        worst = min(worst, cos)
        if not cos >= TRAIN_GRAD_COS:
            fail(f"[train] {what}: {name}'s gradient cosine {cos:.6f} < "
                 f"{TRAIN_GRAD_COS}")
    return worst


def train_step_profile(call, calls: int = 3) -> None:
    """Where a warm training step's time goes (torch.profiler over
    ``calls`` steps): the wall and the device's busy time a step, the
    attention backward's device ms a step (its three kernels), device
    launches a step and the five kernels that take the most device time."""
    from tpu_search_torch.utils.device_profile import _by_kernel, busy_seconds

    events, wall = profiled_events("[train] step", call, calls)
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in events) / calls
    per_step = {kernel: ms * n / calls
                for kernel, ms, n in kernel_split(_by_kernel(events))}
    bwd = sum(per_step.get(k, 0.0)
              for k in ("bwd_rows", "bwd_cols", "bias_grad_kernel"))
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:5]
    print(f"[train] step_profile calls={calls} wall_ms={wall * 1e3:.2f} "
          f"device_busy_ms={busy * 1e3:.2f} idle_share={1 - busy / wall:.4f} "
          f"attention_bwd_device_ms={bwd:.2f} launches_per_step="
          f"{len(events) / calls:.0f} top_device_ms: "
          + " ".join(f"{k}={v:.2f}" for k, v in top), flush=True)


def check_train(work: Path) -> dict:
    """``[train]``: the trainer at all-mpnet-base-v2's width on the card
    (see ``TRAIN_*``).  Each parameter's gradient with the kernels against
    the plain attention's (cosine); 5 steps on one fixed batch at lr
    ``TRAIN_LR``, the loss finite and falling, ms a step, pairs/s,
    tokens/s, peak MB and the backward's launches (24 a step: 12 layers,
    queries and documents); 4 data shards on cuda:0 against one device;
    save, load, resume; a profiled step (``train_step_profile``); the
    fine-tuned checkpoint loaded by
    ``SearchEngine`` on the card, indexing 20 conversations, each of 8
    probes at rank 1 of its own search; a one-rank NCCL group giving the
    same step.  Returns the launch counts of the 5 steps."""
    import copy

    import torch
    import torch.distributed as dist

    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.models.convert import model_from_params
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import (
        build_mesh,
        infonce_loss,
        init_train_state,
        initialize_distributed,
        load_train_state,
        make_train_step,
        save_train_state,
    )
    from tpu_search_torch.utils.synthetic import (
        write_conversations,
        write_model,
    )

    dev = torch.device("cuda")
    config = MPNetConfig()
    master = model_from_params(init_params(config, 5), config).to(dev)
    batch = train_batch(config, dev)
    bf16 = torch.bfloat16

    def grads(plain: bool):
        model = copy.deepcopy(master)
        ctx = plain_attention() if plain else contextlib.nullcontext()
        with ctx:
            loss = infonce_loss(model, *batch, compute_dtype=bf16)
            loss.backward()
        torch.cuda.synchronize()
        return {n: p.grad for n, p in model.named_parameters()}, float(loss)

    _build.reset_launches()
    kernel_grads, kernel_loss = grads(False)
    one_pass = dict(_build.LAUNCHES)
    plain_grads, plain_loss = grads(True)
    worst = grad_cosines(kernel_grads, plain_grads, "kernels vs plain")
    print(f"[train] model=all-mpnet-base-v2 H={config.hidden_size} "
          f"layers={config.num_layers} pairs={TRAIN_PAIRS} "
          f"query_S={TRAIN_QUERY_S} doc_S={TRAIN_DOC_S} compute=bfloat16 "
          f"loss_kernels={kernel_loss:.6f} loss_plain={plain_loss:.6f} "
          f"min_grad_cosine={worst:.6f} "
          f"bwd_launches_per_loss={one_pass['mpnet_attention_bwd']} "
          f"fwd_launches_per_loss={one_pass['mpnet_attention']}", flush=True)
    if one_pass["mpnet_attention_bwd"] != 2 * config.num_layers:
        fail(f"[train] the backward ran {one_pass['mpnet_attention_bwd']} "
             f"times for one loss, want {2 * config.num_layers}")
    if abs(kernel_loss - plain_loss) > 1e-3 * abs(plain_loss):
        fail("[train] the loss with the kernels is not the plain one's")
    del kernel_grads, plain_grads

    one = build_mesh(n_data=1, devices=[dev])
    state, opt = init_train_state(master, one, learning_rate=TRAIN_LR)
    step = make_train_step(one, config, opt, compute_dtype=bf16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    warm = statistics.mean(times[1:])
    tokens = TRAIN_PAIRS * (TRAIN_QUERY_S + TRAIN_DOC_S)
    print(f"[train] steps={TRAIN_STEPS} lr={TRAIN_LR} losses="
          f"{[round(x, 6) for x in losses]} first_step_ms="
          f"{times[0] * 1e3:.2f} ms_per_step={warm * 1e3:.2f} "
          f"pairs_per_s={TRAIN_PAIRS / warm:.1f} tokens_per_s="
          f"{tokens / warm:.0f} peak_mb={peak:.0f} "
          f"bwd_launches={launches['mpnet_attention_bwd']} "
          f"bwd_launches_per_step="
          f"{launches['mpnet_attention_bwd'] / TRAIN_STEPS:.1f} "
          f"{card_name()}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not (
            losses[-1] < losses[0]):
        fail(f"[train] the loss did not fall over {TRAIN_STEPS} steps: "
             f"{losses}")
    if launches["mpnet_attention_bwd"] != TRAIN_STEPS * 2 * config.num_layers:
        fail(f"[train] {launches['mpnet_attention_bwd']} backward launches "
             f"in {TRAIN_STEPS} steps")

    # 4 data shards on cuda:0 against one device, one step from one state
    def one_step(mesh, state_model):
        st, o = init_train_state(state_model, mesh, learning_rate=TRAIN_LR)
        st, ls = make_train_step(mesh, config, o, compute_dtype=bf16)(
            st, *batch)
        return {n: p.grad for n, p in st.params.named_parameters()}, float(ls)

    g4, l4 = one_step(build_mesh(n_data=4, devices=[dev] * 4), master)
    g1, l1 = one_step(one, master)
    worst4 = grad_cosines(g4, g1, "4 shards vs one device")
    print(f"[train] shards=4 on cuda:0 loss={l4:.6f} one_device_loss="
          f"{l1:.6f} min_grad_cosine={worst4:.6f}", flush=True)
    if abs(l4 - l1) > 1e-3 * abs(l1):
        fail("[train] 4 shards and one device give other losses")
    del g4, g1

    # save, load, resume
    ckpt = work / "train_ckpt"
    save_train_state(state, str(ckpt))
    fresh, fresh_opt = init_train_state(master, one, learning_rate=TRAIN_LR)
    restored = load_train_state(str(ckpt), fresh_opt, fresh)
    same = all(torch.equal(a, b) for a, b in zip(
        state.params.parameters(), restored.params.parameters()))
    a_state, a_loss = step(state, *batch)
    b_state, b_loss = make_train_step(one, config, fresh_opt,
                                      compute_dtype=bf16)(restored, *batch)
    diff = max(float((a - b).abs().max()) for (n, a), (_, b) in zip(
        a_state.params.named_parameters(), b_state.params.named_parameters())
        if not n.endswith(".k.bias"))
    print(f"[train] save_load step={restored.step} params_equal={same} "
          f"resumed_loss={float(b_loss):.6f} continued_loss="
          f"{float(a_loss):.6f} max_param_diff={diff:.3e}", flush=True)
    if not same or restored.step != TRAIN_STEPS or b_state.step != (
            TRAIN_STEPS + 1):
        fail("[train] the loaded state is not the saved one")
    if abs(float(a_loss) - float(b_loss)) > 1e-5 * abs(float(a_loss)) or (
            diff > 1e-2 * TRAIN_LR):
        fail("[train] the resumed step is not the continued one")
    train_step_profile(lambda: step(a_state, *batch))

    # the fine-tuned checkpoint served by SearchEngine on the card
    data = work / "train_data"
    model_dir = data / "models" / "ft-mpnet"
    write_model(model_dir)
    shutil.copy(ckpt / "model.tpu.npz", model_dir / "model.tpu.npz")
    files = write_conversations(work / "train_conv", 20,
                                config.vocab_size - 5)
    engine = SearchEngine(data_dir=str(data), model_name="ft-mpnet",
                          use_warm_server=False, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        stats = engine.index_conversations(files)
    total = engine.storage.index.ntotal
    probes, _ = probe_queries(engine, total)
    misses = [rank_one(engine.search_conversations(p.text, top_k=10), p.id,
                       p.text, None) for p in probes[:8]]
    misses = [m for m in misses if m]
    print(f"[train] fine-tuned checkpoint in SearchEngine chunks={total} "
          f"indexed={stats['chunks_indexed']} self_search_rank1="
          f"{8 - len(misses)}/8", flush=True)
    if misses:
        fail(f"[train] the fine-tuned model's self-search: {misses[0]}")
    engine.storage.close()
    del engine

    # a one-rank NCCL group gives the same step
    g0, l0 = one_step(one, master)
    initialize_distributed(coordinator_address=f"localhost:{free_port()}",
                           num_processes=1, process_id=0)
    try:
        with counted_collectives() as calls:
            gg, lg = one_step(one, master)
        worst_g = grad_cosines(gg, g0, "one-rank group vs none")
        print(f"[train] process_group backend={dist.get_backend()} ranks=1 "
              f"calls={calls} loss={lg:.6f} without_group={l0:.6f} "
              f"min_grad_cosine={worst_g:.6f}", flush=True)
        if calls != {"all_gather": 2, "all_reduce": 1} or (
                abs(lg - l0) > 1e-5 * abs(l0)):
            fail("[train] the step under a one-rank group did not gather "
                 "and reduce, or stepped otherwise")
    finally:
        dist.destroy_process_group()
    del master, state, restored, a_state, b_state, g0, gg
    torch.cuda.empty_cache()
    return launches


def check_f32_encoder(model_dir: Path) -> dict:
    """``[f32_encoder]``: ``EmbeddingGenerator(compute_dtype="float32")``
    on the card (the f32 attention kernel in every layer) against the same
    checkpoint on the CPU at f32, 64 texts over the 64 and 128 buckets:
    cosine >= ``F32_ENCODER_COS``.  Returns the launch counts of the card's
    encode."""
    import numpy as np
    import torch

    from tpu_search_torch.models.encoder import (
        EmbeddingConfig,
        EmbeddingGenerator,
    )
    from tpu_search_torch.ops import _build

    rng = np.random.default_rng(43)
    texts = [" ".join(f"tok{i}" for i in rng.integers(0, 30000, n))
             for n in rng.integers(8, 120, 64)]

    def encoder(device):
        gen = EmbeddingGenerator(EmbeddingConfig(
            model_name=model_dir.name, cache_dir=str(model_dir.parent),
            compute_dtype="float32", device=device, auto_batch_size=False,
            batch_size=32, show_progress=False))
        gen.load_model()
        return gen

    card = encoder("cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    got = card._encode_texts(texts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = encoder("cpu")._encode_texts(texts)
    cos = float((got * want).sum(axis=1).min())
    print(f"[f32_encoder] texts={len(texts)} min_cosine={cos:.7f} "
          f"seconds={seconds:.3f} f32_launches="
          f"{launches['mpnet_attention_f32']} bf16_launches="
          f"{launches['mpnet_attention']} int8_ffn={card._int8_ffn}",
          flush=True)
    if not cos >= F32_ENCODER_COS:
        fail(f"[f32_encoder] cosine {cos} < {F32_ENCODER_COS}")
    if launches["mpnet_attention_f32"] == 0 or launches["mpnet_attention"]:
        fail(f"[f32_encoder] the f32 encode did not run the f32 kernel "
             f"alone: {launches}")
    del card
    torch.cuda.empty_cache()
    return launches


# [flash_grad]: the flash mode under autograd at all-mpnet-base-v2's width
# (seeded random weights, the int8 FFN off: it has no backward), the
# trainer's InfoNCE over its 32 pairs with queries at S 128 and documents
# at S 256 (the flash mode takes S in multiples of 128), bf16 and f32
# compute over f32 masters.  A key projection's bias gets a gradient of
# zero in exact arithmetic; with the flash mode's dS rounded to bf16 before
# dK, both sides hold residue of up to 1.7e-2 of the q bias's gradient on
# the CPU test's model (tests/test_torch_flash_attention_grad.py), so the
# kernels' and the plain versions' k-bias gradients are held within
# FLASH_K_BIAS_TOL of the same layer's q bias gradient.
FLASH_GRAD_QUERY_S, FLASH_GRAD_DOC_S = 128, 256
FLASH_K_BIAS_TOL = 2.0 ** -5
FLASH_GRAD_STEPS = 3


def flash_infonce(model, batch, dtype, impl: str):
    """The trainer's InfoNCE (``parallel.train``: its placement of the
    layers in ``dtype`` by differentiable casts, its contrastive loss)
    through ``MPNetModel.forward(..., attention_impl=impl)``."""
    import torch

    from tpu_search_torch.parallel import build_mesh
    from tpu_search_torch.parallel.encode import place
    from tpu_search_torch.parallel.train import _contrastive

    mesh = build_mesh(n_data=1, devices=[model.rel_bias.device])
    placed = place(model, mesh, False, dtype)[0]
    q_ids, q_mask, d_ids, d_mask = batch
    q, d = (torch.func.functional_call(model, placed, (ids, mask),
                                       {"attention_impl": impl})
            for ids, mask in ((q_ids, q_mask), (d_ids, d_mask)))
    return _contrastive(q, d, 0.05)


@contextlib.contextmanager
def plain_flash():
    """The flash mode's forward and backward through their plain versions
    on the card while inside (the kernels' oracle): ``FlashAttention``
    calls them in place of the kernels."""
    from tpu_search_torch.ops import flash_attention as fa

    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved


def check_flash_grad() -> dict:
    """``[flash_grad]``: the flash mode under autograd on the card (see
    ``FLASH_GRAD_QUERY_S``).  In bf16 and in f32: one loss and its
    backward with the kernels against the same with the plain forward and
    backward (``plain_flash``): the loss within 1e-3, every parameter's
    gradient at cosine >= ``TRAIN_GRAD_COS`` (k's bias within
    ``FLASH_K_BIAS_TOL``), 24 forward and 24 backward launches (12 layers,
    queries and documents); the ms a step (loss, backward, AdamW) over
    ``FLASH_GRAD_STEPS`` warm steps beside the dense ("pallas") mode's.
    Then the f32 flash embeddings on the card against the same weights on
    the CPU in the flash mode (cosine > 0.999).  Returns the launch counts
    of the two kernel runs."""
    import copy

    import torch

    from tpu_search_torch.models.convert import model_from_params
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params
    from tpu_search_torch.ops import _build

    dev = torch.device("cuda")
    config = MPNetConfig()
    master = model_from_params(init_params(config, 5), config).to(dev)
    batch = train_batch(config, dev, FLASH_GRAD_QUERY_S, FLASH_GRAD_DOC_S)
    launches = {name: 0 for name in _build.KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        t0 = time.perf_counter()
        fwd = ("flash_attention" if dtype == torch.bfloat16
               else "flash_attention_f32")

        def grads(plain: bool):
            model = copy.deepcopy(master)
            with plain_flash() if plain else contextlib.nullcontext():
                loss = flash_infonce(model, batch, dtype, "flash")
                loss.backward()
            torch.cuda.synchronize()
            return ({n: p.grad for n, p in model.named_parameters()},
                    float(loss.detach()))

        _build.reset_launches()
        kernel_grads, kernel_loss = grads(False)
        one = dict(_build.LAUNCHES)
        for name in launches:
            launches[name] += one[name]
        plain_grads, plain_loss = grads(True)
        what = f"[flash_grad] {dtype} kernels vs plain"
        worst = grad_cosines(kernel_grads, plain_grads, what,
                             k_bias_tol=FLASH_K_BIAS_TOL)
        del kernel_grads, plain_grads

        def step_ms(impl: str) -> float:
            model = copy.deepcopy(master)
            opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR)

            def step():
                opt.zero_grad(set_to_none=True)
                flash_infonce(model, batch, dtype, impl).backward()
                opt.step()

            step()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(FLASH_GRAD_STEPS):
                step()
            torch.cuda.synchronize()
            return (time.perf_counter() - start) / FLASH_GRAD_STEPS * 1e3

        flash_ms, pallas_ms = step_ms("flash"), step_ms("pallas")
        print(f"[flash_grad] model=all-mpnet-base-v2 H={config.hidden_size} "
              f"layers={config.num_layers} pairs={TRAIN_PAIRS} "
              f"query_S={FLASH_GRAD_QUERY_S} doc_S={FLASH_GRAD_DOC_S} "
              f"compute={str(dtype).split('.')[-1]} "
              f"loss_kernels={kernel_loss:.6f} loss_plain={plain_loss:.6f} "
              f"min_grad_cosine={worst:.6f} fwd_launches={one[fwd]} "
              f"bwd_launches={one['flash_attention_bwd']} "
              f"flash_step_ms={flash_ms:.2f} pallas_step_ms={pallas_ms:.2f} "
              f"seconds={time.perf_counter() - t0:.2f} {card_name()}",
              flush=True)
        want = 2 * config.num_layers
        other = ("flash_attention_f32" if fwd == "flash_attention"
                 else "flash_attention")
        if (one[fwd], one["flash_attention_bwd"], one[other]) != (
                want, want, 0):
            fail(f"[flash_grad] {dtype}: launches {one[fwd]} forward, "
                 f"{one['flash_attention_bwd']} backward, {one[other]} of "
                 f"the other forward; want {want}, {want}, 0")
        if not math.isfinite(kernel_loss) or abs(kernel_loss - plain_loss) > (
                1e-3 * abs(plain_loss)):
            fail(f"[flash_grad] {dtype}: the loss with the kernels "
                 f"{kernel_loss} is not the plain one's {plain_loss}")

    # the f32 flash embeddings on the card against the CPU's
    rows = FLASH_REF_ROWS
    ids, mask = batch[2][:rows], batch[3][:rows]
    with torch.no_grad():
        got = master(ids, mask, attention_impl="flash").cpu()
        cpu_model = copy.deepcopy(master).to("cpu")
        ref = cpu_model(ids.cpu(), mask.cpu(), attention_impl="flash")
    cos = float((got * ref).sum(dim=1).min())
    print(f"[flash_grad] f32 embeddings rows={rows} S={FLASH_GRAD_DOC_S} "
          f"cuda_vs_cpu_min_cosine={cos:.7f} "
          f"finite={bool(torch.isfinite(got).all())}", flush=True)
    if not cos > 0.999 or not bool(torch.isfinite(got).all()):
        fail("[flash_grad] the f32 flash embeddings on the card disagree "
             "with the CPU")
    del master, cpu_model
    torch.cuda.empty_cache()
    return launches


def check_dryrun() -> dict:
    """``[dryrun]``: the port's ``dryrun_multichip(4)`` on 4 x cuda:0 (a
    2 x 2 mesh: the train step with dp and tp in f32, the f32 dp encode,
    the sharded scans and warm serving).  Returns its launch counts."""
    import torch

    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel.dryrun import dryrun_multichip

    _build.reset_launches()
    t0 = time.perf_counter()
    line = dryrun_multichip(4, "cuda")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[dryrun] seconds={time.perf_counter() - t0:.2f} launches="
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if "dryrun_multichip OK" not in line:
        fail(f"[dryrun] {line}")
    for name in ("mpnet_attention_f32", "mpnet_attention_bwd"):
        if not launches[name]:
            fail(f"[dryrun] the dry run did not launch {name}")
    return launches


def peer_access(devices) -> dict:
    """``torch.cuda.can_device_access_peer`` for each ordered pair of
    cards, printed on one ``[cross_card]`` line; True when every pair has
    it."""
    import torch

    pairs = {f"{a.index}->{b.index}": torch.cuda.can_device_access_peer(
        a.index, b.index) for a in devices for b in devices if a != b}
    print(f"[cross_card] peer_access={json.dumps(pairs)} "
          f"all={all(pairs.values())}", flush=True)
    return all(pairs.values())


def check_cross_card() -> None:
    """``[cross_card]`` (``--cross-card``, two or more cards), on a mesh
    with one shard on each card (``build_mesh`` over every card).  First
    each card pair's peer access, then ``cross_card_engine``: an engine
    with ``CLAUDE_SEARCH_SHARD_DEVICES`` unset shards over every card,
    its fused window takes the shards, its answers equal the classic path
    on the same cards and one card, its warm server equals in process.
    Then the scan at 1M x 768 (10 % tombstoned) in each of
    ``SHARDED_CASES`` against the single-device ``FlatIndex`` on cuda:0 at
    Q 1, 8, 128 and k 10, 128, unfiltered and under a half-density mask
    (scores within ``SHARDED_REL_TOL``, ids equal outside exact ties):
    each shard's rows on its own card, one kernel call a shard a search,
    cuda:0 the current device after each, and the search's host ms beside
    the single device's; in bf16 and int8 ``cross_card_fused`` times the
    engine's fused window over those rows.  Then ``check_cross_card_ivf``
    and ``check_cross_card_train``."""
    import numpy as np
    import torch

    from tpu_search_torch.devices import platform_devices
    from tpu_search_torch.index.flat import FlatIndex
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import ShardedFlatIndex, build_mesh

    devices = platform_devices("cuda")
    if len(devices) < 2:
        fail(f"--cross-card needs two or more cards, have {len(devices)}")
    dev = devices[0]
    card = f"{card_name()} x{len(devices)}"
    peer = peer_access(devices)
    mesh = build_mesh(n_data=len(devices), devices=devices)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cross_"))
    try:
        engine, texts = cross_card_engine(work, devices, card)
        gen = torch.Generator(device=dev).manual_seed(31)
        rows = unit_rows(gen, SHARDED_N, 768)
        dead = np.random.default_rng(32).choice(SHARDED_N, SHARDED_N // 10,
                                                replace=False)
        mask = np.random.default_rng(33).random(SHARDED_N) < 0.5
        queries = {q: unit_rows(gen, q, 768).cpu().numpy()
                   for q in SHARDED_QS}
        for dtype, metric in SHARDED_CASES:
            tag = f"{dtype}_{metric}"
            sharded = ShardedFlatIndex.from_device_vectors(
                rows, mesh, metric=metric, dtype=dtype)
            sharded.remove(dead)
            single = FlatIndex(768, metric=metric, dtype=dtype, device=dev)
            single.add(rows)
            single.remove(dead)
            cards = [str(sh._vectors.device)
                     for sh in sharded._shards.values()]
            if cards != [str(d) for d in devices]:
                fail(f"[cross_card] {tag}: shards on {cards}")
            worst = 0.0
            for q, k, m in itertools.product(SHARDED_QS, (10, 128),
                                             (None, mask)):
                before = _build.LAUNCHES[KERNEL_OF[dtype]]
                got = sharded.search(queries[q], k, mask=m)
                calls = _build.LAUNCHES[KERNEL_OF[dtype]] - before
                _, rel, fault = topk_error(got, single.search(queries[q], k,
                                                              mask=m),
                                           SHARDED_REL_TOL)
                worst = max(worst, rel)
                where = f"Q={q} k={k} masked={m is not None}"
                if fault or rel > SHARDED_REL_TOL:
                    fail(f"[cross_card] {tag} {where} disagrees with one "
                         f"device: {fault or f'relative error {rel:.3e}'}")
                if calls != len(devices):
                    fail(f"[cross_card] {tag} {where}: {calls} kernel "
                         f"calls, want one a shard")
                if torch.cuda.current_device() != dev.index:
                    fail(f"[cross_card] {tag} {where}: the current device "
                         f"is cuda:{torch.cuda.current_device()} after a "
                         f"search")
            times = {q: (host_ms(lambda: sharded.search(queries[q], 10)),
                         host_ms(lambda: single.search(queries[q], 10)))
                     for q in SHARDED_QS}
            print(f"[cross_card] case={tag} shards={len(devices)} "
                  f"rows={SHARDED_N} against_one_device "
                  f"max_rel_err={worst:.3e} (Q {SHARDED_QS}, k (10, 128), "
                  f"unfiltered and masked) "
                  + " ".join(f"Q={q} k=10 search_ms={a:.4f} "
                             f"single_device_ms={b:.4f}"
                             for q, (a, b) in times.items())
                  + f' card="{card}"', flush=True)
            if dtype in ("bfloat16", "int8"):
                cross_card_fused(engine, texts, sharded, single, tag, card,
                                 peer)
            del sharded, single
            for d in devices:
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()
        del rows
        check_cross_card_ivf(devices, mesh, card, engine, texts, peer)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check_cross_card_train(devices, card)


def cross_card_engine(work: Path, devices, card: str):
    """``[cross_card]``'s engine phase: an engine with
    ``CLAUDE_SEARCH_SHARD_DEVICES`` unset (auto) indexes 200 conversations
    at all-mpnet-base-v2's full width; auto must shard its flat index over
    every card and the fused window must take the shards (one graph a
    card, ``Window.plan``).  The 20 probe queries through
    ``search_conversations`` (fused), each equal to the classic path on
    the same cards and to the saved index loaded on cuda:0 alone, on the
    same embedding (ids outside exact ties, similarities within
    ``WARM_EXACT``); a replay of the window of 1 and of 9 queries equal to
    its eager run; the warm server's answers to the 16 unfiltered probes,
    one client, equal to in process (p50 / p90); a conversation added and
    then removed, each seen by the next fused search.  Returns the engine
    and the 16 unfiltered probe texts."""
    import torch

    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.api.fused import run_eager
    from tpu_search_torch.index.flat import FlatIndex
    from tpu_search_torch.interfaces.query_server import QueryServer
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import ShardedFlatIndex
    from tpu_search_torch.storage.hybrid import SearchConfig
    from tpu_search_torch.utils.synthetic import (
        write_conversations,
        write_model,
    )

    dev = devices[0]
    data = work / "data"
    config = write_model(data / "models" / "smoke-mpnet")
    files = write_conversations(work, CROSS_CARD_CONVERSATIONS + 2,
                                config.vocab_size - 5)
    os.environ.pop("CLAUDE_SEARCH_SHARD_DEVICES", None)
    engine = SearchEngine(str(data), model_name="smoke-mpnet",
                          use_warm_server=False, device="cuda")
    total, _ = index_path(engine, files[:-1], "cross_card", "bfloat16")
    storage = engine.storage
    index = storage.index
    if not isinstance(index, ShardedFlatIndex) or [
            str(index.mesh.shard_device(s)) for s in range(index.n_shards)
    ] != [str(d) for d in devices]:
        fail(f"[cross_card] auto sharding built {index!r}, not a sharded "
             f"index with one shard on each card")
    _, probes = probe_queries(engine, total)
    cfg = SearchConfig(top_k=10, include_metadata=True, include_text=True)
    window = engine._fused_window([probes[0][0]], None, cfg)
    if window is None or window.plan is None:
        fail("[cross_card] the fused window declined the shards on "
             f"several cards: {window!r}")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = [engine.search_conversations(t, f, top_k=10)
               for t, f, _ in probes]
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if not (launches.get("flat_topk") and launches.get("mpnet_attention")):
        fail(f"[cross_card] the fused searches did not run the scan and "
             f"the encoder kernels: {launches}")
    graphs = program_graphs(engine)
    embeddings = [engine.embedder.generate_single_embedding(t)
                  for t, _, _ in probes]

    def classic():
        return [[{"chunk_id": r.chunk_id, "similarity": r.similarity}
                 for r in storage.search(e, cfg, f)]
                for e, (_, f, _) in zip(embeddings, probes)]

    got = classic()
    storage.save_index()
    storage.index = FlatIndex.load(str(storage.index_path), device=dev)
    storage._data_version += 1
    want = classic()
    storage.index = index
    storage._data_version += 1
    for i, (a, g, w) in enumerate(zip(answers, got, want)):
        error = (answer_error(a, g, WARM_EXACT)
                 or answer_error(g, w, WARM_EXACT))
        if error or not g:
            fail(f"[cross_card] query {i}: {error or 'no results'}")
    print(f"[cross_card] engine auto shards={index.n_shards} chunks={total} "
          f"fused=taken graphs_a_replay={graphs} answers equal to the "
          f"classic path on the cards and to one card: {len(probes)} "
          f"wall_s={wall:.3f} launches={launches} card=\"{card}\"",
          flush=True)

    texts = [t for t, f, _ in probes if f is None]
    cfg = SearchConfig(top_k=10)
    for q in (1, 9):
        window = engine._fused_window(texts[:q], None, cfg)
        pending = engine._fused_dispatch_many(texts[:q], None, cfg)
        pending.event.synchronize()
        eager = run_eager(window).cpu()
        equal = bool(torch.equal(pending.packed, eager))
        print(f"[cross_card] graph_vs_eager q={q} q_pad={window.q_pad} "
              f"equal={equal} max_abs_diff="
              f"{float((pending.packed - eager).abs().max()):.3e}",
              flush=True)
        if not equal:
            fail(f"[cross_card] the replay over the cards differs from its "
                 f"eager run at q={q}")

    unfiltered = [(q, a) for q, a in zip(probes, answers) if q[1] is None]
    server = QueryServer(engine, str(data))
    server.start()
    try:
        times = warm_one_at_a_time(data, [q for q, _ in unfiltered],
                                   [a for _, a in unfiltered], "cross_card")
    finally:
        server.stop()
    print_latency(f"cross_card x{len(devices)}", "warm server clients=1",
                  times, phase="cross_card")

    cfg = SearchConfig(top_k=5)
    before = set(storage.chunk_id_to_faiss_id)
    with contextlib.redirect_stdout(io.StringIO()):
        engine.index_conversations(files[-1:])
    added = sorted(set(storage.chunk_id_to_faiss_id) - before)
    if not added:
        fail("[cross_card] the added conversation indexed no chunk")
    text = storage.get_chunk_by_id(added[0]).text
    top = engine._fused_search_many([text], None, cfg)[0]
    if not top or top[0].chunk_id != added[0]:
        fail(f"[cross_card] the fused search missed the added chunk "
             f"{added[0]}: {[r.chunk_id for r in top]}")
    storage.remove_chunks_for_files([str(files[-1])])
    top = engine._fused_search_many([text], None, cfg)[0]
    if any(r.chunk_id in added for r in top):
        fail("[cross_card] the fused search still finds a removed chunk")
    print(f"[cross_card] add and remove seen by the next fused search: "
          f"added={len(added)}", flush=True)
    return engine, texts


def program_graphs(engine) -> int:
    """CUDA graphs one replay of the engine's newest fused program runs (0
    with no program: the CPU runs the window eagerly)."""
    program = next(reversed(engine._fused._programs.values()), None)
    return 0 if program is None else sum(step.graph is not None
                                         for step in program.steps)


def cross_card_fused(engine, texts, sharded, single, tag: str, card: str,
                     peer: bool, nprobe: int = 0) -> None:
    """``[cross_card_fused]``: the engine's fused window over ``sharded``
    (one shard a card) against the classic encode-then-``search`` on the
    same cards and against the fused window over ``single`` (the same
    rows on cuda:0), each over the 16 probe texts at k 10 after a warm
    pass: p50 and wall ms, graph replays and kernel launches a search;
    the answers of each equal to the fused window over the cards (ids
    outside exact ties, similarities within ``WARM_EXACT``).  For the
    fused windows also the programs the warm pass captured and the MB it
    added to each card's reserved memory (the programs' graph pools, and
    on cuda:0 the cache of the warm eager runs)."""
    import numpy as np
    import torch

    from tpu_search_torch.ops import _build
    from tpu_search_torch.storage.hybrid import SearchConfig

    storage = engine.storage
    kept = storage.index
    cfg = SearchConfig(top_k=10, nprobe=nprobe)

    def fused(text):
        return engine._fused_fetch(
            engine._fused_dispatch_many([text], None, cfg))

    def classic(text):
        emb = engine.embedder.generate_single_embedding(text)
        return storage.index.search(emb[None, :], 10, nprobe=nprobe)

    def run(index, search):
        storage.index = index
        storage._data_version += 1
        engine._fused.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cards = range(torch.cuda.device_count())
        reserved = [torch.cuda.memory_reserved(d) for d in cards]
        for text in texts:  # the captures, the lazy caches
            search(text)
        torch.cuda.synchronize()
        pools = ("" if search is not fused else
                 f" programs={len(engine._fused)} reserved_mb_added="
                 + ",".join(f"{(torch.cuda.memory_reserved(d) - r) / 2**20:.1f}"
                            for d, r in zip(cards, reserved)))
        _build.reset_launches()
        torch.cuda.synchronize()
        times, answers = [], []
        t0 = time.perf_counter()
        for text in texts:
            t1 = time.perf_counter()
            scores, ids = search(text)
            times.append((time.perf_counter() - t1) * 1e3)
            answers.append([{"chunk_id": int(i), "similarity": float(s)}
                            for s, i in zip(scores[0], ids[0]) if i >= 0])
        wall = (time.perf_counter() - t0) * 1e3
        launches = sum(_build.LAUNCHES.values()) / len(texts)
        graphs = program_graphs(engine) if search is fused else 0
        return answers, (float(np.median(times)), wall, graphs, launches,
                         pools)

    try:
        want, over_cards = run(sharded, fused)
        results = {"fused_over_cards": over_cards}
        for name, index, search in (("classic_over_cards", sharded, classic),
                                    ("fused_one_card", single, fused)):
            got, results[name] = run(index, search)
            for i, (a, b) in enumerate(zip(got, want)):
                error = answer_error(a, b, WARM_EXACT)
                if error or not a:
                    fail(f"[cross_card_fused] {tag} {name} probe {i}: "
                         f"{error or 'no results'}")
    finally:
        storage.index = kept
        storage._data_version += 1
        engine._fused.clear()
    print(f"[cross_card_fused] case={tag} rows={sharded.ntotal} "
          f"live={sharded.live} shards={sharded.n_shards} probes="
          f"{len(texts)} k=10 nprobe={nprobe} peer_access={peer} "
          + " ".join(f"{name}: p50_ms={p50:.4f} wall_ms={wall:.3f} "
                     f"graph_replays={graphs} launches={launches:.2f}"
                     f"{pools};"
                     for name, (p50, wall, graphs, launches, pools)
                     in results.items())
          + f' answers equal card="{card}"', flush=True)


def check_cross_card_ivf(devices, mesh, card: str, engine, texts,
                         peer: bool) -> None:
    """``[cross_card]``'s sharded IVF case: an int4 ``ShardedIVFIndex``
    with its int8 refine tier, one shard a card, at the ``[ivf]`` phase's
    size (1M x 768 clustered unit rows, nlist 1024, 10 % tombstoned),
    sharing its centroids with a single-device ``IVFIndex`` on cuda:0: at
    Q 1, 8, 128, k 10 and 128, nprobe 32, scores within ``SHARDED_REL_TOL``
    and ids equal outside exact ties, one ``ivf_topk_int4`` call a shard a
    search, cuda:0 current after each, and the search's host ms beside the
    single device's; then ``cross_card_fused`` over both at nprobe 32."""
    import numpy as np
    import torch

    from tpu_search_torch.index.ivf import IVFIndex
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import ShardedIVFIndex

    dev = devices[0]
    rows = ivf_corpus(dev)
    dead = np.random.default_rng(22).choice(IVF_N, IVF_N // 10, replace=False)
    kw = {"dtype": "int4", "nlist": IVF_NLIST, "refine_dtype": "int8",
          "refine_factor": 4}
    single = IVFIndex(768, device=dev, **kw)
    single.add(rows)
    single.remove(dead)
    sharded = ShardedIVFIndex(768, mesh, **kw)
    sharded.centroids = single.centroids
    sharded.add(rows)
    sharded.remove(dead)
    cards = [str(sh._dblocks.device) for sh in sharded._shards.values()]
    if cards != [str(d) for d in devices]:
        fail(f"[cross_card] sharded IVF: shards on {cards}")
    qrng = np.random.default_rng(26)
    live = np.setdiff1d(np.arange(IVF_N), dead)
    queries = {q: rows[torch.from_numpy(qrng.choice(live, q, replace=False))
                       .to(dev)].cpu().numpy() for q in SIVF_QS}
    worst = 0.0
    for q, k in itertools.product(SIVF_QS, (10, 128)):
        before = _build.LAUNCHES["ivf_topk_int4"]
        got = sharded.search(queries[q], k, nprobe=SIVF_NPROBE)
        calls = _build.LAUNCHES["ivf_topk_int4"] - before
        _, rel, fault = topk_error(
            got, single.search(queries[q], k, nprobe=SIVF_NPROBE),
            SHARDED_REL_TOL)
        worst = max(worst, rel)
        if fault or rel > SHARDED_REL_TOL:
            fail(f"[cross_card] sharded IVF Q={q} k={k} disagrees with one "
                 f"device: {fault or f'relative error {rel:.3e}'}")
        if calls != len(devices):
            fail(f"[cross_card] sharded IVF Q={q} k={k}: {calls} kernel "
                 f"calls, want one a shard")
        if torch.cuda.current_device() != dev.index:
            fail(f"[cross_card] sharded IVF Q={q} k={k}: the current device "
                 f"is cuda:{torch.cuda.current_device()} after a search")
    times = {q: (host_ms(lambda: sharded.search(queries[q], 10,
                                                nprobe=SIVF_NPROBE)),
                 host_ms(lambda: single.search(queries[q], 10,
                                               nprobe=SIVF_NPROBE)))
             for q in SIVF_QS}
    print(f"[cross_card] case=ivf_int4_refine shards={len(devices)} "
          f"rows={IVF_N} nlist={IVF_NLIST} against_one_device "
          f"max_rel_err={worst:.3e} (Q {SIVF_QS}, k (10, 128), nprobe "
          f"{SIVF_NPROBE}) "
          + " ".join(f"Q={q} k=10 search_ms={a:.4f} single_device_ms={b:.4f}"
                     for q, (a, b) in times.items())
          + f' card="{card}"', flush=True)
    cross_card_fused(engine, texts, sharded, single, "ivf_int4_refine", card,
                     peer, nprobe=SIVF_NPROBE)
    del sharded, single, rows
    for d in devices:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def check_cross_card_train(devices, card: str) -> None:
    """A dp train step with one data shard on each card (the [train]
    batch and model, bf16 compute) against the same step on cuda:0 alone:
    the loss within 1e-3 and each parameter's gradient at cosine >=
    ``TRAIN_GRAD_COS``."""
    import copy

    import torch

    from tpu_search_torch.models.convert import model_from_params
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params
    from tpu_search_torch.parallel import (
        build_mesh,
        init_train_state,
        make_train_step,
    )

    config = MPNetConfig()
    dev = devices[0]
    master = model_from_params(init_params(config, 5), config).to(dev)
    batch = train_batch(config, dev)

    def one_step(mesh):
        state, opt = init_train_state(copy.deepcopy(master), mesh,
                                      learning_rate=TRAIN_LR)
        t0 = time.perf_counter()
        state, loss = make_train_step(mesh, config, opt,
                                      compute_dtype=torch.bfloat16)(
            state, *batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return ({n: p.grad for n, p in state.params.named_parameters()},
                float(loss), seconds)

    n = len(devices) if TRAIN_PAIRS % len(devices) == 0 else 2
    g_all, l_all, s_all = one_step(build_mesh(n_data=n, devices=devices[:n]))
    g_one, l_one, s_one = one_step(build_mesh(n_data=1, devices=[dev]))
    worst = grad_cosines(g_all, g_one, f"{n} cards vs one")
    print(f"[cross_card] train dp shards={n} loss={l_all:.6f} "
          f"one_card_loss={l_one:.6f} min_grad_cosine={worst:.6f} "
          f"step_s={s_all:.3f} one_card_step_s={s_one:.3f} "
          f'card="{card}"', flush=True)
    if abs(l_all - l_one) > 1e-3 * abs(l_one):
        fail("[cross_card] the dp train step's loss is not one card's")


# -- [cross_process]: ranks in processes of their own, joined by NCCL ------------

# (ranks, cards a rank) of each layout [cross_process] runs on 4 cards: a
# rank a card, and two ranks of two cards (the cards' plan and the ranks'
# gather in one window).
CROSS_PROCESS_LAYOUTS = ((4, 1), (2, 2))
# A layout's time limit: ``spawn_ranks`` kills every rank of a job that
# has not ended by then, as it does the rest when one rank fails.  The
# process group keeps PyTorch's default timeout, longer than the limit.
CROSS_PROCESS_WORKER_S = 420
# ``check_nccl_rules``: the time limit of the duplicate-card and the
# failing-rank jobs, that of the hanging-rank job (longer than a rank takes
# to reach the card and join: about 11 s), and how soon after its first
# rank ends (or its limit) a job must be over.
NCCL_RULES_S, HANGING_S, JOB_END_MARGIN_S = 60, 40, 5
# What the workers need beside the parent's environment: NCCL's bootstrap
# over the loopback interface (the machine has no other network), and a
# collective that fails tearing its process down.
CROSS_PROCESS_ENV = {"NCCL_SOCKET_IFNAME": "lo",
                     "TORCH_NCCL_ASYNC_ERROR_HANDLING": "3"}


def spawn_ranks(mode: str, cards_of, work: Path, timeout: float,
                stop_on_failure: bool = True,
                platform: str = "cuda", coordinator: Optional[str] = None):
    """One ``chip_smoke.py --cross-process-worker`` process a rank (rank r
    on the cards ``cards_of[r]``, joined at ``coordinator``, default
    ``localhost:<a free port>``), each in a session of its own, its output
    in a file under ``work``.  Waits until every rank has ended, one has
    failed (``stop_on_failure``) or ``timeout`` has passed, then kills what
    is left.  ``[(exit code, output, seconds to its end or None)]`` a
    rank."""
    work.mkdir(parents=True, exist_ok=True)
    coordinator = coordinator or f"localhost:{free_port()}"
    env = {**os.environ, **CROSS_PROCESS_ENV}
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank, cards in enumerate(cards_of):
        spec = {"mode": mode, "rank": rank, "ranks": len(cards_of),
                "cards": list(cards), "coordinator": coordinator,
                "work": str(work), "platform": platform}
        logs.append(work / f"{mode}.rank{rank}.log")
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--cross-process-worker", json.dumps(spec)],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                start_new_session=True))
    ended = [None] * len(procs)
    try:
        while True:
            now = time.perf_counter() - t0
            for i, p in enumerate(procs):
                if ended[i] is None and p.poll() is not None:
                    ended[i] = now
            if all(e is not None for e in ended) or now > timeout or (
                    stop_on_failure
                    and any(p.returncode for p in procs if
                            p.returncode is not None)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [(p.returncode, log.read_text(), e)
            for p, log, e in zip(procs, logs, ended)]


def check_nccl_rules(work: Path) -> None:
    """``[cross_process]``'s checks of the process group and of the job
    that ``spawn_ranks`` runs: two ranks asked onto one card must both fail
    on their own (NCCL refuses a duplicate GPU), not hang; when one rank of
    two exits after a first collective, the job must end within
    ``JOB_END_MARGIN_S`` of it, the other rank killed in its next
    collective; and when one rank hangs in place of its second collective,
    the job must end at its time limit (``HANGING_S``), both ranks killed.
    The cards serve the layouts after."""
    t0 = time.perf_counter()
    got = spawn_ranks("duplicate", [[0], [0]], work / "duplicate",
                      NCCL_RULES_S, stop_on_failure=False)
    codes = [rc for rc, _, _ in got]
    said = [line.strip() for _, out, _ in got for line in out.splitlines()
            if "uplicate GPU" in line][:1]
    print(f"[cross_process] nccl duplicate_card ranks=2 cards=[0, 0] "
          f"exit_codes={codes} seconds={time.perf_counter() - t0:.1f} "
          f"error={json.dumps(said[0][:200] if said else None)}",
          flush=True)
    if any(rc in (0, None) for rc in codes) or not said:
        fail("[cross_process] two ranks on one card did not both fail with "
             "NCCL's duplicate GPU error:\n"
             + "\n".join(out[-1500:] for _, out, _ in got))
    t0 = time.perf_counter()
    got = spawn_ranks("failing", [[0], [1]], work / "failing", NCCL_RULES_S)
    job_s = time.perf_counter() - t0
    (rc0, out0, _), (rc1, _, end1) = got
    print(f"[cross_process] nccl failing_rank ranks=2 rank1_exit={rc1} "
          f"rank1_seconds={end1} rank0_exit={rc0} job_seconds={job_s:.1f}",
          flush=True)
    if (rc1 != 3 or end1 is None or rc0 in (0, None)
            or "every collective returned" in out0
            or job_s > end1 + JOB_END_MARGIN_S):
        fail("[cross_process] the job did not end when a rank exited:\n"
             f"{out0[-3000:]}")
    t0 = time.perf_counter()
    got = spawn_ranks("hanging", [[0], [1]], work / "hanging", HANGING_S)
    job_s = time.perf_counter() - t0
    (rc0, out0, end0), (rc1, out1, end1) = got
    print(f"[cross_process] nccl hanging_rank ranks=2 rank1_exit={rc1} "
          f"rank0_exit={rc0} ended_on_their_own={[end0, end1]} "
          f"limit_s={HANGING_S} job_seconds={job_s:.1f}", flush=True)
    if (rc0 in (0, None) or rc1 in (0, None)
            or "rank 1 hangs in place of its second collective" not in out1
            or "every collective returned" in out0
            or job_s > HANGING_S + JOB_END_MARGIN_S):
        fail("[cross_process] the job did not end at its limit when a rank "
             f"hung:\n{out0[-1500:]}\n{out1[-1500:]}")


def check_cross_process() -> None:
    """``[cross_process]`` (``--cross-card``, four cards): serving across
    processes joined by NCCL.  First ``check_nccl_rules``; then each of
    ``CROSS_PROCESS_LAYOUTS`` as one worker process a rank
    (``cross_process_layout``), each rank on its own cards: rank 0's
    lines printed here, every rank's answers held to the others'
    (``[digest]`` lines), the layout's seconds."""
    from tpu_search_torch.devices import platform_devices

    if len(platform_devices("cuda")) < 4:
        fail("[cross_process] needs four cards")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_procs_"))
    try:
        check_nccl_rules(work)
        for ranks, per in CROSS_PROCESS_LAYOUTS:
            tag = f"{ranks}x{per}"
            t0 = time.perf_counter()
            got = spawn_ranks("layout", [list(range(r * per, (r + 1) * per))
                                         for r in range(ranks)],
                              work / tag, CROSS_PROCESS_WORKER_S)
            seconds = time.perf_counter() - t0
            for rank, (rc, out, _) in enumerate(got):
                if rc != 0:
                    fail(f"[cross_process] layout={tag} rank {rank} exited "
                         f"{rc} after {seconds:.0f} s:\n{out[-4000:]}")
            for line in got[0][1].splitlines():
                if line.startswith(("[cross_process]", "[index]",
                                    "[warmup]")):
                    print(line, flush=True)
            digests = [dict(line.split()[1:3] for line in out.splitlines()
                            if line.startswith("[digest]"))
                       for _, out, _ in got]
            differ = sorted(k for k in digests[0]
                            if any(d.get(k) != digests[0][k]
                                   for d in digests[1:]))
            if not digests[0] or differ or any(
                    d.keys() != digests[0].keys() for d in digests):
                fail(f"[cross_process] layout={tag}: the ranks' answers "
                     f"differ: {differ[:5]}")
            print(f"[cross_process] layout={tag} ranks={ranks} "
                  f"cards_a_rank={per} answers_alike_on_every_rank="
                  f"{len(digests[0])} seconds={seconds:.1f}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cross_process_worker(spec: dict) -> None:
    """A rank of ``spawn_ranks``: joins the group (``initialize_distributed``
    on its cards), then runs ``spec["mode"]``: ``duplicate``, ``failing``
    and ``hanging`` (``check_nccl_rules``) or ``layout``
    (``cross_process_layout``)."""
    import torch
    import torch.distributed as dist

    from tpu_search_torch.parallel import initialize_distributed

    os.environ["CLAUDE_SEARCH_DEVICE"] = spec["platform"]
    t0 = time.perf_counter()
    initialize_distributed(
        coordinator_address=spec["coordinator"],
        num_processes=spec["ranks"], process_id=spec["rank"],
        local_device_ids=spec["cards"])
    init_s = time.perf_counter() - t0
    if spec["mode"] == "layout":
        cross_process_layout(spec, init_s)
    else:
        one = torch.ones(1, device=spec["platform"])
        dist.all_reduce(one)
        float(one.sum())  # waits for the collective
        if spec["mode"] == "failing" and spec["rank"] == 1:
            print("rank 1 exits after its first collective", flush=True)
            os._exit(3)
        if spec["mode"] == "hanging" and spec["rank"] == 1:
            print("rank 1 hangs in place of its second collective",
                  flush=True)
            time.sleep(3600)
        if spec["mode"] != "duplicate":
            dist.all_reduce(one)  # rank 1 is gone or hangs
            float(one.sum())
        print(f"{spec['mode']}: every collective returned", flush=True)
    dist.destroy_process_group()


def digest(name: str, answer) -> None:
    """A ``[digest]`` line: a hash of ``answer``'s arrays, which the parent
    holds equal across the ranks."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for part in answer:
        h.update(np.ascontiguousarray(part).tobytes())
    print(f"[digest] {name.replace(' ', '_')} {h.hexdigest()[:16]}",
          flush=True)


def cross_process_layout(spec: dict, init_s: float) -> None:
    """One layout of ``[cross_process]``, in rank ``spec["rank"]`` of
    ``spec["ranks"]`` on its cards ``spec["cards"]``, every rank running
    the same program on the same data; the mesh is every process's cards,
    process-major (``build_mesh(dcn_data=ranks)``).  Rank 0 holds the
    answers against one card and prints them; every rank prints a
    ``[digest]`` of each answer.

    (d) ``cross_process_engine``: an engine a rank, auto sharding over
    every card of every process, its fused window across the processes;
    (a) the sharded flat index at ``[cross_card]``'s rows in every one of
    ``SHARDED_CASES`` against one card's ``FlatIndex``; (b) the sharded
    IVF int4 index with its int8 refine tier at ``[cross_card]``'s IVF
    case against one card's ``IVFIndex`` with the same lists; (c) for
    each case of (a) and for (b) a per-process save, a load and the same
    answers; (e) ``cross_process_fused`` over (a)'s bf16 rows and (b);
    (f) ``cross_process_train``."""
    import numpy as np
    import torch

    from tpu_search_torch.devices import platform_devices
    from tpu_search_torch.index.flat import FlatIndex
    from tpu_search_torch.index.ivf import IVFIndex
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import (
        ShardedFlatIndex,
        ShardedIVFIndex,
        build_mesh,
    )

    rank, ranks = spec["rank"], spec["ranks"]
    lead = rank == 0
    devices = platform_devices(spec["platform"])
    dev = devices[0]
    tag = f"{ranks}x{len(devices)}"
    mesh = build_mesh(n_data=ranks * len(devices), dcn_data=ranks,
                      devices=devices)
    mine = tuple(range(rank * len(devices), (rank + 1) * len(devices)))
    if mesh.local_shards() != mine or mesh.processes != ranks:
        fail(f"[cross_process] rank {rank}: mesh {mesh!r}")
    work = Path(spec["work"])
    card = f"{card_name()} x{ranks * len(devices)}" if lead else ""
    on_card = spec["platform"] == "cuda"

    def say(line: str) -> None:
        if lead:
            print(f"[cross_process] layout={tag} {line}", flush=True)

    def calls_of(kernel: str, search) -> tuple:
        """``search()`` and its wrapper calls of ``kernel`` (one a local
        shard on the card; the CPU's plain versions count none)."""
        before = _build.LAUNCHES[kernel]
        got = search()
        calls = _build.LAUNCHES[kernel] - before
        if on_card and calls != len(devices):
            fail(f"[cross_process] layout={tag} rank {rank}: {calls} "
                 f"{kernel} calls a search, want one a local shard")
        return got

    say(f"rank0 init_seconds={init_s:.3f} cards={spec['cards']} "
        f"shards={mine} of {mesh.shape['data']}")
    engine, texts = cross_process_engine(spec, work, tag, lead, card)

    # (a) The sharded flat index, made alike on every rank from the seeds.
    gen = torch.Generator(device=dev).manual_seed(31)
    rows = unit_rows(gen, SHARDED_N, 768)
    dead = np.random.default_rng(32).choice(SHARDED_N, SHARDED_N // 10,
                                            replace=False)
    mask = np.random.default_rng(33).random(SHARDED_N) < 0.5
    queries = {q: unit_rows(gen, q, 768).cpu().numpy() for q in SHARDED_QS}
    for dtype, metric in SHARDED_CASES:
        case = f"{dtype}_{metric}"
        sharded = ShardedFlatIndex.from_device_vectors(
            rows, mesh, metric=metric, dtype=dtype)
        sharded.remove(dead)
        on = [str(sh._vectors.device) for sh in sharded._shards.values()]
        if on != [str(d) for d in devices]:
            fail(f"[cross_process] {case}: rank {rank}'s shards on {on}")
        single = None
        if lead:
            single = FlatIndex(768, metric=metric, dtype=dtype, device=dev)
            single.add(rows)
            single.remove(dead)
        worst, answers = 0.0, {}
        for q, k, m in itertools.product(SHARDED_QS, (10, 128),
                                         (None, mask)):
            where = f"Q={q} k={k} masked={m is not None}"
            got = calls_of(KERNEL_OF[dtype], lambda: sharded.search(
                queries[q], k, mask=m))
            answers[where] = ((queries[q], k, m), got)
            digest(f"flat {case} {where}", got)
            if lead:
                _, rel, fault = topk_error(got, single.search(
                    queries[q], k, mask=m), SHARDED_REL_TOL)
                worst = max(worst, rel)
                if fault or rel > SHARDED_REL_TOL:
                    fail(f"[cross_process] {case} {where} disagrees with "
                         f"one card: {fault or f'relative error {rel:.3e}'}")
        say(f"case={case} rows={SHARDED_N} shards={sharded.n_shards} "
            f"against_one_card max_rel_err={worst:.3e} (Q {SHARDED_QS}, k "
            f"(10, 128), unfiltered and masked) live={sharded.live} "
            f'card="{card}"')
        saved_and_loaded(sharded, ShardedFlatIndex, work, case, mesh,
                         answers, lambda ix, q, k, m: ix.search(
                             q, k, mask=m), say, rank)
        if dtype == "bfloat16":
            cross_process_fused(engine, texts, sharded, case, say, card)
        del sharded, single
        if on_card:
            torch.cuda.empty_cache()
    del rows

    # (b) The sharded IVF int4 index with its int8 refine tier, its lists
    # trained once on rank 0's card (the one-card reference) and broadcast.
    import torch.distributed as dist

    rows = ivf_corpus(dev)
    dead = np.random.default_rng(22).choice(IVF_N, IVF_N // 10,
                                            replace=False)
    kw = {"dtype": "int4", "nlist": IVF_NLIST, "refine_dtype": "int8",
          "refine_factor": 4}
    cents = torch.zeros((IVF_NLIST, 768), dtype=torch.float32, device=dev)
    single = None
    if lead:
        single = IVFIndex(768, device=dev, **kw)
        single.add(rows)
        single.remove(dead)
        cents.copy_(torch.from_numpy(single.centroids))
    dist.broadcast(cents, src=0)
    sharded = ShardedIVFIndex(768, mesh, **kw)
    sharded.centroids = cents.cpu().numpy()
    sharded.add(rows)
    sharded.remove(dead)
    qrng = np.random.default_rng(26)
    live = np.setdiff1d(np.arange(IVF_N), dead)
    queries = {q: rows[torch.from_numpy(qrng.choice(live, q, replace=False))
                       .to(dev)].cpu().numpy() for q in SIVF_QS}
    worst, answers = 0.0, {}
    for q, k in itertools.product(SIVF_QS, (10, 128)):
        where = f"Q={q} k={k} masked=False"
        got = calls_of("ivf_topk_int4", lambda: sharded.search(
            queries[q], k, nprobe=SIVF_NPROBE))
        answers[where] = ((queries[q], k, None), got)
        digest(f"ivf_int4_refine {where}", got)
        if lead:
            _, rel, fault = topk_error(got, single.search(
                queries[q], k, nprobe=SIVF_NPROBE), SHARDED_REL_TOL)
            worst = max(worst, rel)
            if fault or rel > SHARDED_REL_TOL:
                fail(f"[cross_process] ivf_int4_refine {where} disagrees "
                     f"with one card: {fault or f'relative error {rel:.3e}'}")
    say(f"case=ivf_int4_refine rows={IVF_N} nlist={IVF_NLIST} shards="
        f"{sharded.n_shards} refine={sharded._refine.count} against_one_card "
        f"max_rel_err={worst:.3e} (Q {SIVF_QS}, k (10, 128), nprobe "
        f'{SIVF_NPROBE}) card="{card}"')
    saved_and_loaded(sharded, ShardedIVFIndex, work, "ivf_int4_refine", mesh,
                     answers, lambda ix, q, k, m: ix.search(
                         q, k, nprobe=SIVF_NPROBE), say, rank)
    cross_process_fused(engine, texts, sharded, "ivf_int4_refine", say, card,
                        nprobe=SIVF_NPROBE)
    del sharded, single, rows
    if on_card:
        torch.cuda.empty_cache()
    cross_process_train(spec, mesh, devices, say, card)


def saved_and_loaded(index, cls, work: Path, case: str, mesh, answers,
                     search, say, rank: int) -> None:
    """(c): ``index`` saved per process (every rank's ``.host<r>`` file
    and the manifest in ``work``), loaded over ``mesh`` and asked
    ``answers``' searches (``where -> ((queries, k, mask), answer)``,
    ``search(index, queries, k, mask)``) again: the same answers; then
    the files are deleted."""
    import numpy as np
    import torch.distributed as dist

    path = work / f"{case}.tpuidx"
    t0 = time.perf_counter()
    index.save(str(path))
    saved_s = time.perf_counter() - t0
    hosts = sorted(p.name for p in work.glob(f"{case}.tpuidx.host*"))
    if len(hosts) != mesh.processes or not path.exists():
        fail(f"[cross_process] {case}: per-process files {hosts}")
    t0 = time.perf_counter()
    loaded = cls.load(str(path), mesh)
    loaded_s = time.perf_counter() - t0
    for where, (args, want) in answers.items():
        got = search(loaded, *args)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"[cross_process] {case} rank {rank}: the loaded index "
                 f"answers {where} otherwise")
    say(f"case={case} per_process_save files={hosts} save_seconds="
        f"{saved_s:.2f} load_seconds={loaded_s:.2f} loaded answers equal: "
        f"{len(answers)}")
    dist.barrier()  # every rank has loaded: the files can go
    Path(f"{path}.host{rank}").unlink()
    if rank == 0:
        path.unlink()


def cross_process_engine(spec: dict, work: Path, tag: str, lead: bool,
                         card: str):
    """(d): an engine on each rank over the same 200 conversations at
    all-mpnet-base-v2's full width, ``CLAUDE_SEARCH_SHARD_DEVICES`` unset:
    auto must shard over every card of every process, and the fused window
    take the shards across the processes (a ``CardPlan`` whose stages
    gather).  The 20 probe queries through ``search_conversations``, each
    equal to the classic path across the processes and (rank 0) to one
    card's window over the same conversations (an engine with
    ``CLAUDE_SEARCH_SHARD_DEVICES=1``); the window of 1 and of 9 queries
    replayed against its eager run; a conversation added and then removed,
    each seen by the next fused search.  Returns the engine and the 16
    unfiltered probe texts."""
    import torch

    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.api.fused import run_eager
    from tpu_search_torch.ops import _build
    from tpu_search_torch.parallel import ShardedFlatIndex
    from tpu_search_torch.storage.hybrid import SearchConfig
    from tpu_search_torch.utils.synthetic import (
        write_conversations,
        write_model,
    )

    rank, ranks = spec["rank"], spec["ranks"]
    own = work / f"rank{rank}"
    config = write_model(own / "data" / "models" / "smoke-mpnet")
    files = write_conversations(own, CROSS_CARD_CONVERSATIONS + 2,
                                config.vocab_size - 5)
    os.environ.pop("CLAUDE_SEARCH_SHARD_DEVICES", None)
    engine = SearchEngine(str(own / "data"), model_name="smoke-mpnet",
                          use_warm_server=False, device=spec["platform"])
    total, _ = index_path(engine, files[:-1], f"cross_process_{tag}",
                          "bfloat16")
    storage = engine.storage
    index = storage.index
    n_cards = ranks * len(spec["cards"])
    if not isinstance(index, ShardedFlatIndex) or (
            index.n_shards, index.mesh.processes) != (n_cards, ranks):
        fail(f"[cross_process] rank {rank}: auto sharding built {index!r}, "
             f"not {n_cards} shards over {ranks} processes")
    _, probes = probe_queries(engine, total)
    cfg = SearchConfig(top_k=10, include_metadata=True, include_text=True)
    window = engine._fused_window([probes[0][0]], None, cfg)
    plan = None if window is None or window.plan is None else window.plan(
        window.scan_key, window.buffers, window.staged, window.k,
        merge_device=window.device)
    if plan is None or plan.stages[0].collective is None:
        fail(f"[cross_process] rank {rank}: the fused window did not take "
             f"the shards across the processes: {window!r}")
    _build.reset_launches()
    with counted_collectives() as calls:
        t0 = time.perf_counter()
        answers = [engine.search_conversations(t, f, top_k=10)
                   for t, f, _ in probes]
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    embeddings = [engine.embedder.generate_single_embedding(t)
                  for t, _, _ in probes]
    classic = [[{"chunk_id": r.chunk_id, "similarity": r.similarity}
                for r in storage.search(e, cfg, f)]
               for e, (_, f, _) in zip(embeddings, probes)]
    for i, (a, c) in enumerate(zip(answers, classic)):
        digest(f"engine probe {i}", [[r["chunk_id"] for r in a],
                                     [r["similarity"] for r in a]])
        error = answer_error(a, c, WARM_EXACT)
        if error or not a:
            fail(f"[cross_process] rank {rank} probe {i}: fused against "
                 f"classic: {error or 'no results'}")
    if lead:  # one card's window over the same conversations
        shutil.copytree(own / "data" / "models", own / "one" / "models")
        os.environ["CLAUDE_SEARCH_SHARD_DEVICES"] = "1"
        try:
            one = SearchEngine(str(own / "one"), model_name="smoke-mpnet",
                               use_warm_server=False,
                               device=spec["platform"])
            with contextlib.redirect_stdout(io.StringIO()):
                one.index_conversations(files[:-1])
        finally:
            os.environ.pop("CLAUDE_SEARCH_SHARD_DEVICES", None)
        for i, (a, (t, f, _)) in enumerate(zip(answers, probes)):
            error = answer_error(a, one.search_conversations(t, f, top_k=10),
                                 WARM_EXACT)
            if error:
                fail(f"[cross_process] probe {i}: across the processes "
                     f"against one card: {error}")
        del one
    n = len(probes)
    if lead:
        print(f"[cross_process] layout={tag} engine auto shards="
              f"{index.n_shards} processes={ranks} chunks={total} "
              f"fused=taken stages={len(plan.stages)} cards_a_rank="
              f"{len(plan.cards)} graphs_a_replay={program_graphs(engine)} "
              "collectives_a_search=" + ",".join(
                  f"{k}:{v / n:.2f}" for k, v in sorted(calls.items()))
              + " answers equal to the classic path across the processes "
              f"and to one card: {n} wall_s={wall:.3f} launches={launches} "
              f'card="{card}"', flush=True)

    texts = [t for t, f, _ in probes if f is None]
    cfg = SearchConfig(top_k=10)
    for q in (1, 9):
        window = engine._fused_window(texts[:q], None, cfg)
        engine._fused_dispatch_many(texts[:q], None, cfg)
        pending = engine._fused_dispatch_many(texts[:q], None, cfg)
        if pending.event is not None:
            pending.event.synchronize()
        eager = run_eager(window).cpu()
        equal = bool(torch.equal(pending.packed, eager))
        if lead:
            print(f"[cross_process] layout={tag} graph_vs_eager q={q} "
                  f"q_pad={window.q_pad} equal={equal} max_abs_diff="
                  f"{float((pending.packed - eager).abs().max()):.3e}",
                  flush=True)
        if not equal:
            fail(f"[cross_process] rank {rank}: the replay across the "
                 f"processes differs from its eager run at q={q}")

    cfg = SearchConfig(top_k=5)
    before = set(storage.chunk_id_to_faiss_id)
    with contextlib.redirect_stdout(io.StringIO()):
        engine.index_conversations(files[-1:])
    added = sorted(set(storage.chunk_id_to_faiss_id) - before)
    if not added:
        fail("[cross_process] the added conversation indexed no chunk")
    text = storage.get_chunk_by_id(added[0]).text
    top = engine._fused_search_many([text], None, cfg)[0]
    if not top or top[0].chunk_id != added[0]:
        fail(f"[cross_process] rank {rank}: the fused search missed the "
             f"added chunk {added[0]}: {[r.chunk_id for r in top]}")
    storage.remove_chunks_for_files([str(files[-1])])
    top = engine._fused_search_many([text], None, cfg)[0]
    if any(r.chunk_id in added for r in top):
        fail(f"[cross_process] rank {rank}: the fused search still finds a "
             f"removed chunk")
    if lead:
        print(f"[cross_process] layout={tag} add and remove seen by the "
              f"next fused search: added={len(added)}", flush=True)
    return engine, texts


def cross_process_fused(engine, texts, sharded, case: str, say, card: str,
                        nprobe: int = 0) -> None:
    """(e): the engine's fused window over ``sharded`` (1M rows across the
    processes) against the classic encode-then-``search`` across them,
    over the 16 probe texts at k 10 after a warm pass: p50 and wall ms,
    graph replays, collectives and kernel launches a search (``[cross_card
    _fused]`` gives the window over the same 4 cards in one process); the
    answers of both equal (ids outside exact ties, similarities within
    ``WARM_EXACT``)."""
    import numpy as np

    from tpu_search_torch.ops import _build
    from tpu_search_torch.storage.hybrid import SearchConfig

    storage = engine.storage
    kept = storage.index
    cfg = SearchConfig(top_k=10, nprobe=nprobe)

    def fused(text):
        return engine._fused_fetch(
            engine._fused_dispatch_many([text], None, cfg))

    def classic(text):
        emb = engine.embedder.generate_single_embedding(text)
        return storage.index.search(emb[None, :], 10, nprobe=nprobe)

    def run(search):
        engine._fused.clear()
        for text in texts:  # the captures, the lazy caches
            search(text)
        _build.reset_launches()
        times, answers = [], []
        with counted_collectives() as calls:
            t0 = time.perf_counter()
            for text in texts:
                t1 = time.perf_counter()
                scores, ids = search(text)
                times.append((time.perf_counter() - t1) * 1e3)
                answers.append([{"chunk_id": int(i), "similarity": float(s)}
                                for s, i in zip(scores[0], ids[0]) if i >= 0])
            wall = (time.perf_counter() - t0) * 1e3
        n = len(texts)
        graphs = program_graphs(engine) if search is fused else 0
        return answers, (f"p50_ms={float(np.median(times)):.4f} wall_ms="
                         f"{wall:.3f} graph_replays={graphs} launches="
                         f"{sum(_build.LAUNCHES.values()) / n:.2f} "
                         "collectives=" + ",".join(
                             f"{k}:{v / n:.2f}"
                             for k, v in sorted(calls.items())))

    storage.index = sharded
    storage._data_version += 1
    try:
        want, over = run(fused)
        got, classic_line = run(classic)
    finally:
        storage.index = kept
        storage._data_version += 1
        engine._fused.clear()
    for i, (a, b) in enumerate(zip(got, want)):
        error = answer_error(a, b, WARM_EXACT)
        if error or not a:
            fail(f"[cross_process] {case} probe {i}: classic against the "
                 f"fused window: {error or 'no results'}")
    say(f"fused case={case} rows={sharded.ntotal} shards={sharded.n_shards} "
        f"probes={len(texts)} k=10 nprobe={nprobe} fused_across_processes: "
        f"{over}; classic_across_processes: {classic_line}; answers equal "
        f'card="{card}"')


def cross_process_train(spec: dict, mesh, devices, say, card: str) -> None:
    """(f): the dp encode's global rows and two dp train steps across the
    processes ([train]'s batch and model, bf16 compute, one data shard a
    card), against one card (rank 0): each step's loss within 1e-3, each
    parameter's gradient at cosine >= ``TRAIN_GRAD_COS``, and the encode's
    rows against one card's on the same parameters (least row cosine)."""
    import copy

    import torch

    from tpu_search_torch.models.convert import model_from_params
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params
    from tpu_search_torch.parallel import (
        build_mesh,
        init_train_state,
        make_sharded_encode,
        make_train_step,
    )

    config = MPNetConfig()
    dev = devices[0]
    master = model_from_params(init_params(config, 5), config).to(dev)
    batch = train_batch(config, dev)

    def steps(on):
        state, opt = init_train_state(copy.deepcopy(master), on,
                                      learning_rate=TRAIN_LR)
        step = make_train_step(on, config, opt, compute_dtype=torch.bfloat16)
        losses = []
        t0 = time.perf_counter()
        for _ in range(2):
            state, loss = step(state, *batch)
            losses.append(float(loss))
        seconds = (time.perf_counter() - t0) / 2
        grads = {n: p.grad for n, p in state.params.named_parameters()}
        return state, losses, grads, seconds

    state, losses, grads, seconds = steps(mesh)
    digest("train losses", [torch.tensor(losses).numpy()])
    encode = make_sharded_encode(mesh, config, compute_dtype=torch.bfloat16)
    emb = encode(state.params, batch[0], batch[1])
    digest("dp encode", [emb.float().cpu().numpy()])
    if spec["rank"]:
        return
    one = build_mesh(n_data=1, devices=[dev])
    _, one_losses, one_grads, one_seconds = steps(one)
    worst = grad_cosines(grads, one_grads, "across processes vs one card")
    want = make_sharded_encode(one, config, compute_dtype=torch.bfloat16)(
        state.params, batch[0], batch[1])
    cos = float(torch.nn.functional.cosine_similarity(emb, want).min())
    say(f"train dp shards={mesh.shape['data']} losses={losses} "
        f"one_card_losses={one_losses} min_grad_cosine={worst:.6f} "
        f"step_s={seconds:.3f} one_card_step_s={one_seconds:.3f} "
        f"dp_encode rows={emb.shape[0]} min_row_cosine_vs_one_card="
        f'{cos:.6f} card="{card}"')
    if any(abs(a - b) > 1e-3 * abs(b) for a, b in zip(losses, one_losses)):
        fail("[cross_process] the dp train steps' losses are not one card's")
    if not cos >= TRAIN_GRAD_COS:
        fail(f"[cross_process] the dp encode's rows are {cos:.6f} from one "
             f"card's")


# -- phase 3: the main path -----------------------------------------------------


def check_encoder_reference(engine, texts) -> float:
    """Embeddings from the CUDA kernels vs the same model on the CPU
    (plain versions, same bf16 + int8 FFN numerics): min cosine."""
    import copy

    import torch

    emb = engine.embedder
    gpu = emb._encode_texts(texts)
    cpu_model = copy.deepcopy(emb._model).to("cpu")
    if emb._int8_ffn:
        cpu_model.quantize_ffn()
    ids = [emb._tokenizer.encode(t, 64) for t in texts]
    width = max(len(s) for s in ids)
    tok = torch.full((len(ids), 64), emb._tokenizer.pad_id, dtype=torch.long)
    mask = torch.zeros((len(ids), 64), dtype=torch.int32)
    for row, seq in enumerate(ids):
        tok[row, : len(seq)] = torch.tensor(seq)
        mask[row, : len(seq)] = 1
    assert width <= 64
    with torch.inference_mode():
        ref = cpu_model(tok, mask, int8_ffn=emb._int8_ffn).numpy()
    return float((gpu * ref).sum(axis=1).min())


def index_path(engine, files, tag: str, dtype: str, warm_files: int = 1):
    """Index ``files[:warm_files]`` as a warm-up, then, with the launch
    counts set to 0, the rest, timed.  Returns ``(total chunks, launches of
    the indexing)``."""
    import torch

    from tpu_search_torch.ops import _build

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the parser's warnings
        warm = engine.index_conversations(files[:warm_files])
    gate = engine.embedder.int8_gate
    print(f"[warmup] path={tag} first file chunks={warm['chunks_indexed']} "
          f"seconds={time.perf_counter() - t0:.2f} "
          f"int8_ffn={engine.embedder._int8_ffn} "
          f"gate_min_cosine={gate.get('min_cosine')}", flush=True)
    if not engine.embedder._int8_ffn:
        fail(f"int8 FFN gate closed on random full-width weights: {gate}")

    _build.reset_launches()
    torch.cuda.synchronize()
    # The parser prints one warning per malformed or noise line (two in
    # every file of this recipe); count them instead of echoing them.
    parser_log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(parser_log):
        stats = engine.index_conversations(files[warm_files:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after_index = dict(_build.LAUNCHES)
    n_timed = len(files) - warm_files
    print(f"[index] path={tag} conversations={n_timed} files_processed="
          f"{stats['files_processed']} chunks={stats['chunks_indexed']} "
          f"seconds={wall:.3f} s_per_1k_conversations="
          f"{wall / n_timed * 1000:.3f} chunks_per_s="
          f"{stats['chunks_indexed'] / wall:.1f} "
          f"errors={len(stats['errors'])} "
          f"parser_warnings={parser_log.getvalue().count(chr(10))}",
          flush=True)
    print(f"[index] path={tag} phases={json.dumps(stats['phases'])}",
          flush=True)
    if stats["errors"] or stats["files_processed"] != n_timed:
        fail(f"indexing errors: {stats['errors'][:3]}")
    total = warm["chunks_indexed"] + stats["chunks_indexed"]
    index = engine.storage.index
    if index.ntotal != total or index.live != total:
        fail("index row count disagrees with the chunks indexed")
    if index.dtype != dtype:
        fail(f"the {tag} path built a {index.dtype} index")
    if 0 in (after_index["mpnet_attention"], after_index["int8_ffn_ln"]):
        fail(f"indexing did not run the encoder kernels: {after_index}")
    return total, after_index


def probe_queries(engine, total: int):
    """``(probes, queries)``: 16 probe chunks drawn from the first
    ``PROBE_POOL`` ids, and the 20 queries ``(text, filters, want)``: the 16
    probes' own text, 2 ``--project``, 2 ``--has-code``."""
    import numpy as np

    storage = engine.storage
    pool = min(total, PROBE_POOL)
    probe_ids = [f"chunk_{i:06d}" for i in
                 np.random.default_rng(3).choice(pool, 16, replace=False) + 1]
    probes = [storage.get_chunk_by_id(cid) for cid in probe_ids]
    project = storage.get_all_projects()[0]
    queries = [(p.text, None, p.id) for p in probes]
    queries += [(probes[i].text, {"project_name": project[-6:]}, probes[i].id)
                for i in range(2)]
    queries += [(probes[i].text, {"has_code": True}, None) for i in (2, 3)]
    return probes, queries


def search_path(engine, total: int, tag: str, check_hit):
    """The 20 queries of :func:`probe_queries` in a cold and a warm pass;
    ``check_hit(results, want, text, filters)`` returns an error or None for
    each query with a known answer (outside the timed call).  Returns the
    probes."""
    import numpy as np
    import torch

    probes, queries = probe_queries(engine, total)
    project = engine.storage.get_all_projects()[0]

    # Two passes over the same queries: the first meets each query
    # shape and filter for the first time, the second is warm.
    passes = {"cold": [], "warm": []}
    for times, (text, filters, want) in itertools.product(
        passes.values(), queries
    ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.search_conversations(text, filters, top_k=10)
        times.append(((time.perf_counter() - t0) * 1000, bool(filters)))
        if not results:
            fail(f"no results for filters={filters}")
        if want is not None:
            error = check_hit(results, want, text, filters)
            if error:
                fail(f"self-search on the {tag} path: {error}")
        if filters and "has_code" in filters:
            if not all(r["has_code"] for r in results):
                fail("--has-code returned a chunk without code")
        if filters and "project_name" in filters:
            if not all(r["project"] == project for r in results):
                fail("--project returned another project")
    for name, times in passes.items():
        for kind, sel in (("all", (False, True)), ("unfiltered", (False,)),
                          ("filtered", (True,))):
            ms = [t for t, filtered in times if filtered in sel]
            print(f"[search] path={tag} pass={name} queries={kind} "
                  f"n={len(ms)} p50_ms={np.median(ms):.3f} "
                  f"p90_ms={np.percentile(ms, 90):.3f} "
                  f"max_ms={max(ms):.3f}", flush=True)
    return probes


# A CLI subprocess spends 10-16 s on the card, most of it starting up.  A
# check of a data directory that nothing later in its path touches runs on
# a thread of its own (``cli_in_background``), after the earlier checks of
# the same directory, so that it overlaps the paths that follow;
# ``join_cli`` waits for them all at the end of phase 3 and fails the run
# on the first fault.
_CLI_THREADS: dict = {}
_CLI_FAULTS: list = []
_CLI_PROCS: set = set()


def run_cli(argv: list, env: dict) -> subprocess.CompletedProcess:
    """The CLI in a subprocess (``argv`` after ``--data-dir D --device
    cuda``), ended with the run if the run ends first."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_search_torch.interfaces.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    _CLI_PROCS.add(proc)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        _CLI_PROCS.discard(proc)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _kill_cli() -> None:
    for proc in list(_CLI_PROCS):
        if proc.poll() is None:
            proc.kill()


atexit.register(_kill_cli)


def cli_in_background(key: str, step) -> None:
    """Run ``step()`` (a fault's message, or None) on a thread, after the
    steps given before under the same ``key`` (a data directory)."""
    import threading

    before = _CLI_THREADS.get(key)

    def run():
        if before is not None:
            before.join()
        try:
            fault = step()
        except Exception as exc:  # reported by join_cli
            fault = f"{type(exc).__name__}: {exc}"
        if fault:
            _CLI_FAULTS.append(fault)

    thread = threading.Thread(target=run, name=f"cli {key}", daemon=True)
    thread.start()
    _CLI_THREADS[key] = thread


def join_cli() -> None:
    """Wait for every background CLI check; fail on the first fault."""
    t0 = time.perf_counter()
    for thread in list(_CLI_THREADS.values()):
        thread.join()
    _CLI_THREADS.clear()
    print(f"[cli] background checks joined, waited "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if _CLI_FAULTS:
        fail(_CLI_FAULTS[0])


def cli_search(engine, data_dir: Path, query: str, tag: str,
               env_extra: dict, model: str = "smoke-mpnet",
               rerank_model: str = ""):
    """``search --json`` (with ``rerank_model``: ``search --rerank
    --rerank-model M --rerank-factor F --json``) in a subprocess, over the
    index loaded from disk, against the in-process ids: the in-process
    search runs now, the subprocess in the step returned (a fault's
    message, or None)."""
    flags, kwargs = [], {}
    if rerank_model:
        flags = ["--rerank", "--rerank-model", rerank_model,
                 "--rerank-factor", str(RERANK_FACTOR)]
        kwargs = dict(rerank=True, rerank_model=rerank_model,
                      rerank_factor=RERANK_FACTOR)
    inproc = [r["chunk_id"] for r in engine.search_conversations(
        query, top_k=RERANK_TOP_K, **kwargs)]
    env = dict(os.environ, CLAUDE_SEARCH_MODEL=model, **env_extra)

    def step():
        t0 = time.perf_counter()
        proc = run_cli(["--data-dir", str(data_dir), "--device", "cuda",
                        "search", query, "--top-k", str(RERANK_TOP_K),
                        *flags, "--json"], env)
        if proc.returncode != 0:
            return f"CLI search on {tag} failed: {proc.stderr[-2000:]}"
        cli_ids = [item["uid"] for item in json.loads(proc.stdout)["items"]]
        what = "search --rerank --json" if rerank_model else "search --json"
        print(f"[cli] path={tag} {what} seconds="
              f"{time.perf_counter() - t0:.2f} same_top_ids="
              f"{cli_ids == inproc} top={cli_ids[:3]}", flush=True)
        if cli_ids != inproc:
            return (f"CLI on {tag} (index loaded from disk) {cli_ids} != "
                    f"in-process {inproc}")
        return None

    return step


def check_cli(engine, data_dir: Path, query: str, tag: str,
              env_extra: dict, model: str = "smoke-mpnet",
              rerank_model: str = "") -> None:
    """:func:`cli_search`, run now."""
    fault = cli_search(engine, data_dir, query, tag, env_extra, model,
                       rerank_model)()
    if fault:
        fail(fault)


def rank_one(results, want, text, filters):
    """The own chunk at rank 1 with similarity ~1 (bf16 storage)."""
    top = results[0]
    if top["chunk_id"] != want or abs(top["similarity"] - 1.0) > 1e-2:
        return (f"want {want} at rank 1 with sim ~1, got "
                f"{top['chunk_id']} sim={top['similarity']}")
    return None


def bf16_tie_hit(gaps: list):
    """A self-search check for bf16 storage where neighbouring chunks embed
    nearly alike (random-weight BERT: adjacent chunks share a turn): the own
    chunk in the top 10 with similarity within 1e-2 of 1, and at rank 1 or
    within ``BF16_TIE`` of the top score.  Appends ``(rank, gap, bound)``
    to ``gaps``."""

    def hit(results, want, text, filters):
        ids = [r["chunk_id"] for r in results]
        if want not in ids:
            return f"want {want} in the top 10, got {ids}"
        rank = ids.index(want)
        own, top = results[rank]["similarity"], results[0]["similarity"]
        gaps.append((rank, top - own, BF16_TIE))
        if top - own > BF16_TIE or abs(own - 1.0) > 1e-2:
            return (f"{want} at rank {rank + 1} with sim {own}, "
                    f"{top - own:.3e} under {ids[0]}")
        return None

    return hit


def tie_hit(engine, sigma, exact_near_one: bool, gaps: list):
    """A self-search check for quantized storage: the own chunk ranks
    first, or below chunks whose scores it ties within the tier's
    quantization noise (``QUANT_TIE_SIGMAS`` of ``sigma(chunk_id)``, the
    score's standard deviation); with ``exact_near_one`` (int8) it also
    scores within 2e-2 of 1.  Appends ``(rank, gap, bound)`` to ``gaps``."""

    def hit(results, want, text, filters):
        ranked = results
        if want not in [r["chunk_id"] for r in ranked]:
            ranked = engine.search_conversations(text, filters, top_k=200)
        ids = [r["chunk_id"] for r in ranked]
        if want not in ids:
            return f"want {want} in the top 200, got {ids[:10]}"
        rank = ids.index(want)
        own, top = ranked[rank]["similarity"], ranked[0]["similarity"]
        limit = QUANT_TIE_SIGMAS * math.hypot(sigma(want), sigma(ids[0]))
        gaps.append((rank, top - own, limit))
        if top - own > limit:
            return (f"{want} at rank {rank + 1}, {top - own:.3e} under "
                    f"{ids[0]} (tie bound {limit:.3e})")
        if exact_near_one and abs(own - 1.0) > 2e-2:
            return f"{want} scores {own}, not within 2e-2 of 1"
        return None

    return hit


def print_gaps(tag: str, gaps: list) -> None:
    ranks = [r for r, _, _ in gaps]
    print(f"[search] path={tag} own chunk rank: 1st {ranks.count(0)} "
          f"of {len(ranks)}, top 10 {sum(r < 10 for r in ranks)}, worst "
          f"{max(ranks) + 1}; gap to the top / tie bound: max "
          f"{max(g / b for _, g, b in gaps):.3f}, bound median "
          f"{statistics.median(b for _, _, b in gaps):.3e}", flush=True)


def path_kernels(tag: str):
    return [name for name, path in PATH_OF.items() if path == tag]


def run_main_path(work: Path, files) -> dict:
    """Index and search on the GPU with the default bf16 storage, then the
    warm phase, ``serve`` and the MCP server on its directory, the CLI's
    other reads, and the flash step on its encoder; return the kernel
    launch counts of each."""
    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.ops import _build

    engine = SearchEngine(str(work / "data"), model_name="smoke-mpnet",
                          use_warm_server=False, device="cuda")
    total, after_index = index_path(engine, files, "bfloat16", "bfloat16")
    probes = search_path(engine, total, "bfloat16", rank_one)
    launches = dict(_build.LAUNCHES)
    searched = {k: launches[k] - after_index[k] for k in launches}
    print(f"[launches] path=bfloat16 index={after_index} search={searched}",
          flush=True)
    if any(searched[k] == 0 for k in path_kernels("bfloat16")):
        fail(f"search did not run every kernel: {searched}")

    cos = check_encoder_reference(engine, [p.text[:200] for p in probes[:4]])
    print(f"[reference] cuda_vs_cpu_plain_min_cosine={cos:.6f}", flush=True)
    if not cos > 0.999:
        fail("CUDA encoder disagrees with the plain CPU encoder")
    check_cli(engine, work / "data", probes[4].text, "bfloat16", {})
    warm = run_warm_path(engine, work, total)
    sharded = run_sharded_serving(engine, work, total)
    launches = {k: n + sharded.get(k, 0) for k, n in launches.items()}
    # The servers load the directory from disk: give them this engine's
    # state (the warm phase's add and remove may be newer than the file).
    engine.storage.save_index()
    served = {"http": run_http(engine, work, probes),
              "mcp": run_mcp(engine, work, probes)}
    run_cli_surface(engine, work, probes)
    return launches, run_flash_encoder(engine), warm, served


# The warm phase: one in-process QueryServer on the flat bf16 path's warm
# engine, its answers held against the in-process fused answers.  One at
# a time the two run the same program (batch 1, q_pad 8, the query's own
# sequence bucket), so they must agree to WARM_EXACT.  A concurrent
# window encodes at another batch and sequence bucket (the longest query
# of the window sets it), where cuBLAS may sum in another order: there
# ids agree outside near-ties and similarities within WARM_TOL, the port's
# bf16-compute tolerance against the JAX package (tests/test_torch_engine).
WARM_EXACT, WARM_TOL = 1e-6, 5e-3
# (client threads, rounds): of the 20 queries, then of the 16 unfiltered
# alone (a filtered window computes its SQLite mask on the server's one
# dispatch thread, 75-90 ms on this index, and holds every window behind it)
WARM_CLIENTS = ((8, 4), (32, 2))
WARM_UNFILTERED_CLIENTS = ((8, 5), (32, 3))


def answer_error(got, want, tol):
    """None when ``got`` (a response's results) matches ``want`` (the
    in-process results): the same length, each rank's similarity within
    ``tol``, an id that differs only in a near-tie (its in-process score,
    or for an id past the in-process top k the last score, within
    ``2 tol``)."""
    if len(got) != len(want):
        return f"{len(got)} results, in process {len(want)}"
    want_by_id = {r["chunk_id"]: r["similarity"] for r in want}
    for rank, (a, b) in enumerate(zip(got, want)):
        if abs(a["similarity"] - b["similarity"]) > tol:
            return (f"rank {rank + 1}: similarity {a['similarity']} against "
                    f"{b['similarity']}")
        if a["chunk_id"] != b["chunk_id"]:
            other = want_by_id.get(a["chunk_id"], want[-1]["similarity"])
            if abs(other - b["similarity"]) > 2 * tol:
                return (f"rank {rank + 1}: {a['chunk_id']} against "
                        f"{b['chunk_id']}, not a near-tie")
    return None


def max_sim_gap(got, want) -> float:
    return max((abs(a["similarity"] - b["similarity"])
                for a, b in zip(got, want)), default=0.0)


def warm_one_at_a_time(data_dir: Path, queries, reference, tag: str):
    """Each query once through one persistent ``QueryClient``; every answer
    must equal the in-process one (same ids, similarities within
    ``WARM_EXACT``).  Returns the latencies (ms)."""
    from tpu_search_torch.interfaces.query_server import QueryClient

    times = []
    with QueryClient(str(data_dir), timeout=120) as client:
        for (text, filters, _), want in zip(queries, reference):
            t0 = time.perf_counter()
            response = client.request({"op": "search", "query": text,
                                       "filters": filters, "top_k": 10})
            times.append(((time.perf_counter() - t0) * 1e3, bool(filters)))
            if not response.get("ok"):
                fail(f"warm search failed on the {tag} path: {response}")
            got = response["results"]
            ids_equal = [r["chunk_id"] for r in got] == [
                r["chunk_id"] for r in want]
            if not ids_equal or max_sim_gap(got, want) > WARM_EXACT:
                fail(f"warm answer differs from in process on the {tag} "
                     f"path: {[r['chunk_id'] for r in got]} against "
                     f"{[r['chunk_id'] for r in want]}, similarity gap "
                     f"{max_sim_gap(got, want):.3e}")
    return times


def warm_concurrent(data_dir: Path, queries, reference, clients: int,
                    rounds: int):
    """``clients`` threads, each with its own ``QueryClient``, each sending
    the queries ``rounds`` times from its own offset.  Returns
    ``(latencies ms, wall s, worst similarity gap)``; fails on an answer
    outside :func:`answer_error`'s gate."""
    import threading

    from tpu_search_torch.interfaces.query_server import QueryClient

    times, errors, gaps = [], [], [0.0]
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(c):
        mine, worst = [], 0.0
        with QueryClient(str(data_dir), timeout=120) as qc:
            start.wait(timeout=120)
            for r in range(rounds):
                for j in range(len(queries)):
                    i = (c + j + r) % len(queries)
                    text, filters, _ = queries[i]
                    t0 = time.perf_counter()
                    response = qc.request({"op": "search", "query": text,
                                           "filters": filters, "top_k": 10})
                    mine.append(((time.perf_counter() - t0) * 1e3,
                                 bool(filters)))
                    error = (response.get("error") if not response.get("ok")
                             else answer_error(response["results"],
                                               reference[i], WARM_TOL))
                    if error:
                        with lock:
                            errors.append(f"query {i}: {error}")
                        return
                    worst = max(worst, max_sim_gap(response["results"],
                                                   reference[i]))
        with lock:
            times.extend(mine)
            gaps.append(worst)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        fail(f"{clients} warm clients: {errors[:3] or 'a client hung'}")
    return times, wall, max(gaps)


def print_latency(tag: str, what: str, times, wall=None,
                  phase: str = "warm") -> None:
    """p50 / p90 / max of ``(ms, filtered)`` latencies, all and by kind,
    and queries/s (over ``wall``, else one client's: 1 / mean), on a
    ``[phase]`` line."""
    import numpy as np

    ms = [t for t, _ in times]
    qps = len(ms) / wall if wall else 1e3 / float(np.mean(ms))
    parts = []
    for kind, sel in (("all", (False, True)), ("unfiltered", (False,)),
                      ("filtered", (True,))):
        got = [t for t, filtered in times if filtered in sel]
        if got:
            parts.append(f"{kind}: n={len(got)} p50_ms={np.median(got):.3f} "
                         f"p90_ms={np.percentile(got, 90):.3f} "
                         f"max_ms={max(got):.3f}")
    print(f"[{phase}] path={tag} {what} queries_per_s={qps:.1f} "
          + "; ".join(parts), flush=True)


def graph_against_eager(engine, texts) -> None:
    """The window of 1 (q_pad 8) and of 9 queries (q_pad 32), each captured
    anew (the device memory its capture reserved is printed), replayed as
    a CUDA graph and run eagerly (``api.fused.run_eager``, no user path
    calls it): the packed outputs must be equal."""
    import torch

    from tpu_search_torch.api.fused import run_eager
    from tpu_search_torch.storage.hybrid import SearchConfig

    cfg = SearchConfig(top_k=10)
    engine._fused.clear()  # each window captures anew: its pool's size
    for q in (1, 9):
        window = engine._fused_window(texts[:q], None, cfg)
        captures = engine._fused.captures
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        pending = engine._fused_dispatch_many(texts[:q], None, cfg)
        pending.event.synchronize()
        pool_mb = (torch.cuda.memory_reserved() - reserved) / 2**20
        eager = run_eager(window).cpu()
        gap = float((pending.packed - eager).abs().max())
        equal = bool(torch.equal(pending.packed, eager))
        print(f"[warm] graph_vs_eager q={q} q_pad={window.q_pad} "
              f"batch={window.ids.shape[0]} seq={window.ids.shape[1]} "
              f"packed={tuple(eager.shape)} equal={equal} "
              f"max_abs_diff={gap:.3e} captured="
              f"{engine._fused.captures > captures} "
              f"reserved_mb_added={pool_mb:.1f}", flush=True)
        if not equal:
            fail(f"the graph replay differs from the eager run at q={q}")


def scan_both_ways(engine) -> None:
    """The flat bf16 scan at the smoke's index, over the whole capacity
    (the fused path's choice: a graph stays valid across adds) against
    over ``round_up(count, 128)`` rows (the classic path's, which would
    key a graph on the row count), at q_pad 8, k 10; and the capture of a
    lone query's window, timed after clearing the program cache."""
    import torch

    from tpu_search_torch.index.flat import flat_scan
    from tpu_search_torch.storage.hybrid import SearchConfig
    from tpu_search_torch.utils.shapes import round_up

    index = engine.storage.index
    scan_key, buffers = index.make_scan_fn()
    staged = index.scan_staged(None)
    gen = torch.Generator(device="cuda").manual_seed(4)
    queries = torch.randn((8, index.dim), generator=gen, device="cuda")
    queries = queries / queries.norm(dim=1, keepdim=True)
    n_scan = round_up(index.ntotal, 128)
    cap_ms, rows_ms = paired_ms(
        lambda: flat_scan(scan_key, buffers, staged, queries, 10),
        lambda: flat_scan(scan_key, buffers, staged, queries, 10, n_scan),
        iters=50)
    bound_ms, by = flat_bound(index.capacity, index.dim, 8, 10)
    text = engine.storage.get_chunk_by_id("chunk_000002").text
    engine._fused.clear()
    t0 = time.perf_counter()
    engine._fused_search_many([text], None, SearchConfig(top_k=10))
    first_ms = (time.perf_counter() - t0) * 1e3
    print(f"[warm] scan capacity={index.capacity} rows={n_scan} Q=8 k=10 "
          f"capacity_ms={cap_ms:.4f} rows_ms={rows_ms:.4f} "
          f"capacity_bound_ms={bound_ms:.4f} ({by}) "
          f"recapture_ms={engine._fused.last_capture_ms:.1f} "
          f"first_search_ms={first_ms:.1f}", flush=True)


# The launches of one flat bf16 / f32 scan call (csrc/flat_topk.cu): the
# prologue, the ring scan and the tree merge.
FLAT_SCAN_KERNELS = ("float_prep", "ivf_float_scan", "tree_merge")


def profile_replays(engine, texts, phase: str = "warm") -> None:
    """The host and device split of a warm in-process query (a lone query,
    its graph replayed): the wall a search, the device busy time a replay
    and its kernels (torch.profiler sees a replay's kernels; the launch
    counters are the gate's witness either way)."""
    from tpu_search_torch.storage.hybrid import SearchConfig
    from tpu_search_torch.utils.device_profile import _by_kernel, busy_seconds

    cfg = SearchConfig(top_k=10)
    calls = 10
    events, wall = profiled_events(
        "warm replays", lambda: engine._fused_search_many(texts[:1], None, cfg),
        calls)
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in events) / calls
    split = kernel_split(_by_kernel(events))
    top = " ".join(f"{k}={ms * n / calls:.4f}(n={n // calls})"
                   for k, ms, n in split[:6])
    scan = " ".join(f"{k}={ms * n / calls:.4f}(n={n / calls:g})"
                    for k, ms, n in split if k in FLAT_SCAN_KERNELS)
    print(f"[{phase}] replay profile: wall_ms_a_search={wall * 1e3:.4f} "
          f"device_busy_ms_a_replay={busy * 1e3:.4f} "
          f"device_events_a_replay={len(events) / calls:.1f} "
          f"kernels_ms_a_replay: {top} flat_scan_ms_a_replay: {scan}",
          flush=True)


def run_warm_path(engine, work: Path, total: int) -> dict:
    """The warm phase on the flat bf16 path's engine (see ``WARM_EXACT``):
    an in-process ``QueryServer`` answers the 20 probe queries one at a
    time, then from 8 and 32 client threads; a graph replay against the
    eager run at q_pad 8 and 32; staleness (a conversation indexed through
    the server's worker is found at rank 1, then removed and gone); the
    scan over the capacity against over the rows, and a capture's time.
    Returns the launch counts of the whole phase (set to 0 before it)."""
    import torch

    from tpu_search_torch.interfaces.query_server import QueryServer
    from tpu_search_torch.ops import _build
    from tpu_search_torch.storage.hybrid import SearchConfig

    data = work / "data"
    _, queries = probe_queries(engine, total)
    texts = [t for t, f, _ in queries if f is None]
    _build.reset_launches()
    torch.cuda.synchronize()
    reference = [engine.search_conversations(t, f, top_k=10)
                 for t, f, _ in queries]
    captures = engine._fused.captures
    server = QueryServer(engine, str(data))
    server.start()
    try:
        times = warm_one_at_a_time(data, queries, reference, "bfloat16")
        print_latency("bfloat16", "clients=1", times)
        unfiltered = [i for i, (_, f, _) in enumerate(queries) if f is None]
        for mix, passes in (("20", WARM_CLIENTS),
                            ("16 unfiltered", WARM_UNFILTERED_CLIENTS)):
            keep = range(len(queries)) if mix == "20" else unfiltered
            for clients, rounds in passes:
                times, wall, gap = warm_concurrent(
                    data, [queries[i] for i in keep],
                    [reference[i] for i in keep], clients, rounds)
                print_latency("bfloat16", f"queries={mix} clients={clients} "
                              f"max_similarity_gap={gap:.3e}", times, wall)
        print(f"[warm] programs={len(engine._fused)} captures during the "
              f"passes={engine._fused.captures - captures}", flush=True)
        graph_against_eager(engine, texts)
        check_staleness(engine, server, work, data)
    finally:
        server.stop()
    launches = dict(_build.LAUNCHES)
    print(f"[launches] path=warm {launches}", flush=True)
    if any(launches[k] == 0 for k in path_kernels("bfloat16")):
        fail(f"the warm path did not run every kernel: {launches}")
    profile_replays(engine, texts)
    scan_both_ways(engine)
    engine._fused_search_many(texts[:1], None, SearchConfig(top_k=10))
    return launches


def check_staleness(engine, server, work: Path, data: Path) -> None:
    """A new conversation indexed through the server's worker thread (as
    the watcher indexes) is found through the warm server at rank 1 with
    similarity ~1; removed the same way, it is gone."""
    from tpu_search_torch.interfaces.query_server import QueryClient

    path = work / "fresh-projects" / "-root-fresh" / "fresh.jsonl"
    path.parent.mkdir(parents=True)
    words = " ".join(f"tok{(37 * j) % 500 + 20}" for j in range(150))
    path.write_text("".join(json.dumps({
        "uuid": f"f{i}", "sessionId": "fresh",
        "timestamp": f"2025-08-01T10:0{i}:00Z",
        "message": {"role": role, "content": [{"type": "text",
                                               "text": words}]},
    }) + "\n" for i, role in enumerate(("user", "assistant"))))
    storage = engine.storage
    before = set(storage.chunk_id_to_faiss_id)
    captures, capacity = engine._fused.captures, storage.index.capacity
    with contextlib.redirect_stdout(io.StringIO()):
        server._worker.run(lambda: engine.index_conversations([path]))
    new = sorted(set(storage.chunk_id_to_faiss_id) - before)
    if not new:
        fail("the fresh conversation indexed no chunk")
    text = storage.get_chunk_by_id(new[0]).text
    with QueryClient(str(data), timeout=120) as client:
        got = client.search(text, top_k=10)["results"]
        if got[0]["chunk_id"] != new[0] or abs(
                got[0]["similarity"] - 1.0) > 1e-2:
            fail(f"the fresh chunk {new[0]} is not at rank 1: "
                 f"{[(r['chunk_id'], r['similarity']) for r in got[:3]]}")
        server._worker.run(
            lambda: storage.remove_chunks_for_files([str(path)]))
        after = client.search(text, top_k=10)["results"]
    gone = all(r["chunk_id"] not in new for r in after)
    print(f"[warm] staleness: added {len(new)} chunks, rank 1 {new[0]} "
          f"sim={got[0]['similarity']:.6f}; removed, gone={gone}; "
          f"captures={engine._fused.captures - captures} "
          f"capacity {capacity} -> {storage.index.capacity}", flush=True)
    if not gone:
        fail("a removed chunk still comes back from the warm server")


def warm_exact_pass(engine, data: Path, probes, tag: str, kernel: str):
    """The 16 probes one at a time through an in-process ``QueryServer`` on
    a quantized path's engine, each answer equal to the in-process one,
    with the path's scan kernel launched in graph replays."""
    from tpu_search_torch.interfaces.query_server import QueryServer
    from tpu_search_torch.ops import _build

    queries = [(p.text, None, p.id) for p in probes]
    reference = [engine.search_conversations(t, None, top_k=10)
                 for t, _, _ in queries]
    _build.reset_launches()
    server = QueryServer(engine, str(data))
    server.start()
    try:
        times = warm_one_at_a_time(data, queries, reference, tag)
    finally:
        server.stop()
    print_latency(tag, "clients=1", times)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"[launches] path={tag} warm={launches}", flush=True)
    if not launches.get(kernel):
        fail(f"the warm {tag} pass did not launch {kernel}: {launches}")


def run_daemon(work: Path, files) -> None:
    """The watcher daemon on the card, last: ``cli start`` on an empty data
    directory watching an empty projects directory; 20 conversations copied
    in are indexed by the daemon; ``cli search --json`` answers through its
    warm server (run with a model name that does not exist, so a local
    engine could not have answered); ``cli stop``, then ``cli status``
    reports it stopped.  The daemon also serves the HTTP front (``start
    --http-port``, a port found free by binding to 0): after the 20 files,
    ``/v1/search`` answers ``chunk_000003`` at rank 1, ``DAEMON_HTTP_CALLS``
    times, timed."""
    import socket

    from tpu_search_torch.interfaces.query_server import request, socket_path_for

    data = work / "data_daemon"
    data.mkdir()
    (data / "models").symlink_to(work / "data" / "models")
    watched = work / "daemon-projects"
    project = watched / "-root-daemon"
    project.mkdir(parents=True)
    env = dict(os.environ, CLAUDE_SEARCH_MODEL="smoke-mpnet")

    def cli(*args, model_env=env, timeout=300):
        return subprocess.run(
            [sys.executable, "-m", "tpu_search_torch.interfaces.cli",
             "--data-dir", str(data), "--device", "cuda", *args],
            capture_output=True, text=True, env=model_env, cwd=str(ROOT),
            timeout=timeout)

    def log_tail() -> str:
        log = data / "watcher.log"
        return " | ".join(log.read_text().splitlines()[-8:]) if (
            log.exists()) else "(no log)"

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        http_port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = cli("start", "--claude-dir", str(watched), "--debounce", "1",
               "--http-port", str(http_port))
    if proc.returncode != 0 or "started with PID" not in proc.stdout:
        fail(f"cli start failed: {proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    try:
        deadline = time.time() + 300
        while not socket_path_for(str(data)).exists():
            if time.time() > deadline:
                fail(f"the daemon's query socket never appeared: "
                     f"{log_tail()}")
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        for f in files[:20]:
            shutil.copy(f, project / f.name)
        t1, stats = time.perf_counter(), {}
        while not stats.get("total_chunks"):
            if time.time() > deadline:
                fail(f"the daemon indexed nothing: {stats} {log_tail()}")
            time.sleep(0.5)
            response = request(str(data), {"op": "stats"}, timeout=120)
            stats = (response or {}).get("stats", {})
        indexed_s = time.perf_counter() - t1
        chunk = request(str(data), {"op": "get_chunk",
                                    "chunk_id": "chunk_000003"},
                        timeout=120)["chunk"]
        if chunk is None:
            fail(f"the daemon has no chunk_000003: {stats}")
        t2 = time.perf_counter()
        proc = cli("search", chunk["text"], "--top-k", "5", "--json",
                   model_env=dict(env, CLAUDE_SEARCH_MODEL="no-such-model"))
        search_s = time.perf_counter() - t2
        if proc.returncode != 0:
            fail(f"cli search through the daemon failed: "
                 f"{proc.stdout[-1000:]} {proc.stderr[-1000:]} {log_tail()}")
        items = json.loads(proc.stdout)["items"]
        top = items[0]["uid"] if items else None
        print(f"[daemon] start_to_socket_s={up_s:.2f} "
              f"index_20_files_s={indexed_s:.2f} "
              f"chunks={stats['total_chunks']} search_json_s={search_s:.2f} "
              f"top={top} sim={items[0]['variables']['similarity']:.6f}",
              flush=True)
        if top != "chunk_000003":
            fail(f"the daemon's search returned {top}, not chunk_000003")
        times = []
        for _ in range(DAEMON_HTTP_CALLS):
            t3 = time.perf_counter()
            hits = http_search(http_port, chunk["text"], top_k=5)["results"]
            times.append(((time.perf_counter() - t3) * 1e3, False))
            if not hits or hits[0]["chunk_id"] != "chunk_000003":
                fail(f"the daemon's HTTP front answered {hits[:1]}")
        print_latency("daemon_http", f"port={http_port} top=chunk_000003 "
                      f"sim={hits[0]['similarity']:.6f}", times,
                      phase="daemon")
    finally:
        stop = cli("stop")
        status = cli("status")
    print(f"[daemon] stop rc={stop.returncode} "
          f"status={status.stdout.strip().splitlines()[0]}", flush=True)
    if stop.returncode != 0 or "not running" not in status.stdout:
        fail(f"the daemon did not stop: {stop.stdout} {status.stdout}")


# -- the product surface: HTTP, MCP, the CLI's SQL-only reads, storage ------


def compute_apps():
    """``[(pid, used MiB)]`` of ``nvidia-smi --query-compute-apps`` and the
    card's used memory (MiB)."""
    def smi(query: str) -> str:
        return subprocess.run(["nvidia-smi", query, "--format=csv,noheader,"
                               "nounits"], capture_output=True, text=True,
                              check=True).stdout
    apps = [tuple(int(x) for x in line.split(","))
            for line in smi("--query-compute-apps=pid,used_memory").splitlines()
            if line.strip()]
    used = int(smi("--query-gpu=memory.used").splitlines()[0])
    return apps, used


def check_cuda_context(tag: str, pid: int, running, after) -> None:
    """The server held a CUDA context: its PID among nvidia-smi's compute
    apps while it ran, or, where nvidia-smi reports every process under
    one PID (a container whose PIDs it cannot see: ``1 /process_api``),
    the card's used memory dropping by at least ``CONTEXT_MIB`` when it
    exited."""
    (apps, used), (_, used_after) = running, after
    freed = used - used_after
    listed = pid in {p for p, _ in apps}
    print(f"[{tag}] nvidia-smi compute apps while serving (pid, MiB)={apps} "
          f"server pid={pid} listed={listed} card MiB serving={used} "
          f"after exit={used_after} freed={freed}", flush=True)
    if not listed and freed < CONTEXT_MIB:
        fail(f"the {tag} server shows no CUDA context: pid {pid} not in "
             f"{apps}, {freed} MiB freed at its exit")


# A CUDA context alone takes ~500 MiB on an H100; the servers also hold the
# encoder and the index.
CONTEXT_MIB = 256


def start_server(cmd, env, log: Path, **popen):
    """Start ``cmd`` with stderr into ``log``; returns ``(proc, lines)``,
    ``lines`` a queue of its stdout lines (a reader thread fills it)."""
    import queue
    import threading

    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=log.open("w"),
                            **popen)
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, lines


def next_line(lines, log: Path, timeout: float = 300.0) -> str:
    import queue

    try:
        line = lines.get(timeout=timeout)
    except queue.Empty:
        line = None
    if line is None:
        fail(f"the server stopped answering: "
             f"{' | '.join(log.read_text().splitlines()[-8:])}")
    return line


def stop_server(proc, sig=signal.SIGINT) -> int:
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def served_launches(tag: str, log: Path) -> dict:
    """The launch counts a server process wrote at exit
    (``CLAUDE_SEARCH_LAUNCH_LOG``); fails unless it launched every kernel
    of the flat bf16 path."""
    if not log.exists():
        fail(f"the {tag} server wrote no launch counts")
    launches = json.loads(log.read_text())
    print(f"[launches] path={tag} {launches}", flush=True)
    if any(launches[k] == 0 for k in path_kernels("bfloat16")):
        fail(f"the {tag} server did not launch every kernel: {launches}")
    return launches


def http_get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as resp:
        return json.loads(resp.read())


def http_search(port: int, text: str, top_k: int = 10, **filters):
    from urllib.parse import urlencode

    query = urlencode({"q": text, "top_k": top_k, **filters})
    return http_get(port, f"/v1/search?{query}")


def http_concurrent(port: int, queries, reference, clients: int,
                    rounds: int):
    """``clients`` threads sending the unfiltered ``queries`` ``rounds``
    times from their own offsets; answers within :func:`answer_error`'s
    gate.  Returns ``(latencies, wall s, worst similarity gap)``."""
    import threading

    times, errors, gaps = [], [], [0.0]
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(c):
        mine, worst = [], 0.0
        start.wait(timeout=120)
        for r in range(rounds):
            for j in range(len(queries)):
                i = (c + j + r) % len(queries)
                t0 = time.perf_counter()
                response = http_search(port, queries[i])
                mine.append(((time.perf_counter() - t0) * 1e3, False))
                error = (response.get("error") if not response.get("ok")
                         else answer_error(response["results"], reference[i],
                                           WARM_TOL))
                if error:
                    with lock:
                        errors.append(f"query {i}: {error}")
                    return
                worst = max(worst, max_sim_gap(response["results"],
                                               reference[i]))
        with lock:
            times.extend(mine)
            gaps.append(worst)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        fail(f"{clients} HTTP clients: {errors[:3] or 'a client hung'}")
    return times, wall, max(gaps)


def run_http(engine, work: Path, probes) -> dict:
    """``cli serve --port 0`` on the flat bf16 directory: its routes; the
    16 probes one at a time, twice (the first pass meets each query shape
    for the first time; each answer equal to the in-process one: ids,
    similarities within ``WARM_EXACT``), then from 8 client threads (ids
    equal outside near-ties, similarities within ``WARM_TOL``); a
    ``project`` filter; its CUDA context; the launches of the server
    process (its warm-up search included)."""
    data = work / "data"
    texts = [p.text for p in probes]
    reference = [engine.search_conversations(t, top_k=10) for t in texts]
    project = engine.storage.get_all_projects()[0]
    launch_log, log = work / "launches_http.json", work / "serve.log"
    env = dict(os.environ, CLAUDE_SEARCH_MODEL="smoke-mpnet",
               CLAUDE_SEARCH_LAUNCH_LOG=str(launch_log))
    t0 = time.perf_counter()
    proc, lines = start_server(
        [sys.executable, "-m", "tpu_search_torch.interfaces.cli",
         "--data-dir", str(data), "--device", "cuda", "serve", "--port", "0"],
        env, log)
    try:
        port = None
        while port is None:
            match = re.search(r"Search API on http://127\.0\.0\.1:(\d+)",
                              next_line(lines, log))
            port = int(match.group(1)) if match else None
        up_s = time.perf_counter() - t0
        health = http_get(port, "/healthz")
        stats = http_get(port, "/v1/stats")["stats"]
        projects = http_get(port, "/v1/projects")["projects"]
        chunk = http_get(port, f"/v1/chunks/{probes[0].id}")["chunk"]
        if not (health["model_loaded"] and stats["total_chunks"]
                == engine.storage.total_chunks and project in projects
                and chunk["text"] == probes[0].text):
            fail(f"serve routes: {health} {stats} {projects} {chunk['id']}")
        for name in ("cold", "warm"):  # cold: first captures of the shapes
            times = []
            for text, want in zip(texts, reference):
                t1 = time.perf_counter()
                got = http_search(port, text)
                times.append(((time.perf_counter() - t1) * 1e3, False))
                if not got.get("ok") or [r["chunk_id"] for r in got[
                        "results"]] != [r["chunk_id"] for r in want] or (
                        max_sim_gap(got["results"], want) > WARM_EXACT):
                    fail(f"serve answer differs from in process: {got}")
            print_latency("http", f"clients=1 pass={name}", times,
                          phase="http")
        times, wall, gap = http_concurrent(port, texts, reference, 8, 2)
        print_latency("http", f"clients=8 max_similarity_gap={gap:.3e}",
                      times, wall, phase="http")
        filtered = http_search(port, texts[0], project=project[-6:])
        if not filtered["results"] or any(
                r["project"] != project for r in filtered["results"]):
            fail(f"serve project filter: {filtered}")
        running = compute_apps()
    finally:
        rc = stop_server(proc)
    check_cuda_context("http", proc.pid, running, compute_apps())
    print(f"[http] start_to_banner_s={up_s:.2f} routes ok, 16 probes equal, "
          f"project filter ok, exit rc={rc}", flush=True)
    if rc != 0:
        fail(f"serve exited with {rc}: {log.read_text()[-1000:]}")
    return served_launches("http", launch_log)


def mcp_text(response) -> str:
    if "error" in response:
        fail(f"MCP error: {response['error']}")
    return response["result"]["content"][0]["text"]


def run_mcp(engine, work: Path, probes) -> dict:
    """The MCP stdio server on the flat bf16 directory: the handshake, the
    five tools, each probe's own text at Result 1 (similarity >= 0.999),
    ``related_to`` + ``same_session``, the other tools, -32601 for an
    unknown tool, its CUDA context, and its launches."""
    storage = engine.storage
    launch_log, log = work / "launches_mcp.json", work / "mcp.log"
    env = dict(os.environ, CLAUDE_SEARCH_DATA_DIR=str(work / "data"),
               CLAUDE_SEARCH_DEVICE="cuda", CLAUDE_SEARCH_MODEL="smoke-mpnet",
               CLAUDE_SEARCH_LAUNCH_LOG=str(launch_log))
    proc, lines = start_server(
        [sys.executable, "-m", "tpu_search_torch.interfaces.mcp_server"],
        env, log, stdin=subprocess.PIPE)
    ids = itertools.count()

    def rpc(method, params=None, notify=False):
        msg = {"jsonrpc": "2.0", "method": method, "params": params or {}}
        if not notify:
            msg["id"] = next(ids)
        proc.stdin.write(json.dumps(msg) + "\n")
        proc.stdin.flush()
        return None if notify else json.loads(next_line(lines, log))

    def tool(name, **arguments):
        return rpc("tools/call", {"name": name, "arguments": arguments})

    try:
        init = rpc("initialize", {"protocolVersion": "2024-11-05"})
        rpc("notifications/initialized", notify=True)
        tools = [t["name"] for t in rpc("tools/list")["result"]["tools"]]
        pong = rpc("ping")
        if (init["result"]["serverInfo"]["name"] != "claude-search"
                or len(tools) != 5 or pong.get("result") != {}):
            fail(f"MCP handshake: {init} {tools} {pong}")
        times, sims = [], []
        for probe in probes:
            t0 = time.perf_counter()
            text = mcp_text(tool("claude_semantic_search", query=probe.text,
                                 top_k=5))
            times.append(((time.perf_counter() - t0) * 1e3, False))
            top = re.search(r"### Result 1 \[Similarity: ([0-9.]+)\]\n"
                            r"\*\*Chunk ID\*\*: (\S+)", text)
            if top is None or top.group(2) != probe.id or float(
                    top.group(1)) < 0.999:
                fail(f"MCP search for {probe.id}: {text[:300]}")
            sims.append(float(top.group(1)))
        running = compute_apps()
        session = storage._get_chunk_data(probes[0].id)["session_id"]
        want = {c.id for c in storage.get_chunks_by_session(session)} - {
            probes[0].id}
        text = mcp_text(tool("claude_semantic_search", related_to=probes[0].id,
                             same_session=True, top_k=1000))
        got = set(re.findall(r"\*\*Chunk ID\*\*: (\S+)", text))
        if got != want or set(re.findall(r"\*\*Session\*\*: (\S+)", text)) != {
                session}:
            fail(f"MCP same_session: {sorted(got ^ want)[:5]}")
        card = mcp_text(tool("get_chunk_by_id", chunk_id=probes[1].id))
        listing = mcp_text(tool("list_projects"))
        stats = mcp_text(tool("get_stats"))
        status = mcp_text(tool("get_status"))
        if (probes[1].text not in card
                or storage.get_all_projects()[0] not in listing
                or f"Total chunks: {storage.total_chunks:,}" not in stats
                or "Daemon running" not in status):
            fail(f"MCP tools: {card[:100]} {listing[:100]} {stats[:200]} "
                 f"{status}")
        unknown = tool("no_such_tool")
        if unknown.get("error", {}).get("code") != -32601:
            fail(f"MCP unknown tool: {unknown}")
        proc.stdin.close()
        rc = proc.wait(timeout=120)
    finally:
        stop_server(proc, signal.SIGTERM)
    check_cuda_context("mcp", proc.pid, running, compute_apps())
    print_latency("mcp", f"tool=claude_semantic_search min_similarity="
                  f"{min(sims):.3f}", times, phase="mcp")
    print(f"[mcp] tools={tools} same_session={len(got)} chunks, other tools "
          f"ok, unknown tool -32601, exit rc={rc}", flush=True)
    if rc != 0:
        fail(f"the MCP server exited with {rc}: {log.read_text()[-1000:]}")
    return served_launches("mcp", launch_log)


@contextlib.contextmanager
def env_set(**values):
    """``os.environ`` with ``values`` for the block."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def run_main(main, argv, **env) -> str:
    """An entry point's ``main(argv)`` in this process with ``env`` set;
    returns its stdout, fails on a non-zero exit."""
    out = io.StringIO()
    try:
        with env_set(**env), contextlib.redirect_stdout(out):
            main(argv)
    except SystemExit as exc:
        if exc.code:
            fail(f"{argv[:6]} exited {exc.code}: {out.getvalue()[-1000:]}")
    return out.getvalue()


def run_cli_surface(engine, work: Path, probes) -> None:
    """The CLI's SQL-only reads and ``stats --gpu`` on the flat bf16
    directory, through the CLI's ``main`` in this process: ``--chunk-id``,
    ``--related-to --same-session`` (the session's other chunks in time
    order), a semantic search ``--related-to`` (that session only)."""
    import torch

    from tpu_search_torch.interfaces.cli import main

    storage = engine.storage
    probe = probes[2]
    session = storage._get_chunk_data(probe.id)["session_id"]

    def cli(*args):
        t0 = time.perf_counter()
        out = run_main(main, ["--data-dir", str(work / "data"), "--device",
                              "cuda", *args],
                       CLAUDE_SEARCH_MODEL="smoke-mpnet")
        return out, time.perf_counter() - t0

    out, chunk_s = cli("search", "--chunk-id", probe.id, "--json")
    items = json.loads(out)["items"]
    if [i["uid"] for i in items] != [probe.id] or items[0]["text"] != (
            probe.text):
        fail(f"search --chunk-id: {out[:300]}")
    out, related_s = cli("search", "--related-to", probe.id,
                         "--same-session", "--top-k", "1000", "--json")
    items = json.loads(out)["items"]
    want = [c.id for c in storage.get_chunks_by_session(session)
            if c.id != probe.id]
    stamps = [i["variables"]["timestamp"] for i in items]
    if [i["uid"] for i in items] != want or stamps != sorted(stamps):
        fail(f"search --related-to --same-session: {[i['uid'] for i in items]}"
             f" against {want}")
    out, semantic_s = cli("search", probes[3].text, "--related-to", probe.id,
                          "--json")
    items = json.loads(out)["items"]
    if not items or {i["variables"]["session"] for i in items} != {session}:
        fail(f"search --related-to: {out[:300]}")
    out, stats_s = cli("stats", "--gpu")
    if torch.cuda.get_device_name(0) not in out:
        fail(f"stats --gpu names no card: {out}")
    print(f"[cli] surface: --chunk-id {chunk_s:.2f}s, --related-to "
          f"--same-session {len(want)} chunks in time order {related_s:.2f}s, "
          f"semantic --related-to {len(items)} hits one session "
          f"{semantic_s:.2f}s, stats --gpu {stats_s:.2f}s", flush=True)


def run_storage(work: Path, files) -> dict:
    """Last, on a copy of the flat int8 path's directory:
    ``delete_chunks_by_session`` seen by the fused search (graph replays of
    the int8 scan), ``backup`` then ``restore`` into a fresh engine with the
    probe answers unchanged; ``setup-models --from-dir`` on a small random
    HF-format MPNet verified on the card; ``index --trace`` naming the
    encoder kernels.  Returns the launch counts of the delete's searches."""
    import torch

    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.models import setup as model_setup
    from tpu_search_torch.models.mpnet import MPNetConfig
    from tpu_search_torch.ops import _build
    from tpu_search_torch.utils.synthetic import write_hf_model

    data = work / "data_storage"
    shutil.copytree(work / "data_int8", data, symlinks=True)
    engine = SearchEngine(str(data), model_name="smoke-mpnet",
                          use_warm_server=False, device="cuda")
    engine._open()
    storage = engine.storage
    probes, _ = probe_queries(engine, storage.total_chunks)
    session = storage._get_chunk_data(probes[0].id)["session_id"]
    engine.search_conversations(probes[0].text, top_k=10)  # captured
    t0 = time.perf_counter()
    removed = storage.delete_chunks_by_session(session)
    _build.reset_launches()
    after = engine.search_conversations(probes[0].text, top_k=10)
    launches = dict(_build.LAUNCHES)
    if not removed or not after or any(r["session"] == session
                                       for r in after):
        fail(f"delete_chunks_by_session({session}) removed {removed}, the "
             f"fused search still returns it: {after[:2]}")
    if not launches["flat_topk_int8"]:
        fail(f"the search after the delete ran no int8 scan: {launches}")
    delete_s = time.perf_counter() - t0
    before = [engine.search_conversations(p.text, top_k=10) for p in probes]
    t0 = time.perf_counter()
    storage.backup(str(work / "backup"))
    fresh = work / "data_restored"
    fresh.mkdir()
    (fresh / "models").symlink_to(work / "data" / "models")
    restored = SearchEngine(str(fresh), model_name="smoke-mpnet",
                            use_warm_server=False, device="cuda")
    restored._open()
    restored.storage.restore(str(work / "backup"))
    restore_s = time.perf_counter() - t0
    if restored.storage.index.device.type != "cuda":
        fail("restore loaded the index off the card")
    for probe, want in zip(probes, before):
        got = restored.search_conversations(probe.text, top_k=10)
        if [r["chunk_id"] for r in got] != [r["chunk_id"] for r in want] or (
                max_sim_gap(got, want) > WARM_EXACT):
            fail(f"restored answers differ for {probe.id}")
    print(f"[storage] delete_chunks_by_session removed={removed} gone from "
          f"the fused search, seconds={delete_s:.2f}; backup+restore "
          f"seconds={restore_s:.2f}, 16 probes equal after restore",
          flush=True)
    del engine, restored
    torch.cuda.empty_cache()

    hf = work / "hf-smoke"
    write_hf_model(hf, MPNetConfig(vocab_size=1000, num_layers=2), seed=11)
    t0 = time.perf_counter()
    out = run_main(model_setup.main, ["--from-dir", str(hf), "--model",
                                      "smoke-hf", "--device", "cuda"],
                   CLAUDE_SEARCH_DATA_DIR=str(work / "data_setup"))
    verified = [line for line in out.splitlines()
                if line.startswith("Verification")]
    print(f"[storage] setup-models --from-dir seconds="
          f"{time.perf_counter() - t0:.2f} {verified}", flush=True)
    if not verified or "on cuda" not in verified[0] or (
            "norms ok=True" not in verified[0]):
        fail(f"setup-models: {out[-1000:]}")
    check_index_trace(work, files)
    return launches


def global_names(source: str) -> set:
    """The ``__global__`` functions of ``csrc/<source>.cu``."""
    text = (ROOT / "tpu_search_torch" / "csrc" / f"{source}.cu").read_text()
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                          r"\)\s*)?(\w+)\s*\(", text))


def check_index_trace(work: Path, files) -> None:
    """``index --trace DIR`` on 5 conversations writes a trace whose
    device kernels include ``mpnet_attention.cu``'s and
    ``int8_ffn_ln.cu``'s."""
    data, projects = work / "data_trace", work / "trace-projects" / "-root-t"
    data.mkdir()
    (data / "models").symlink_to(work / "data" / "models")
    projects.mkdir(parents=True)
    for f in files[:5]:
        shutil.copy(f, projects / f.name)
    from tpu_search_torch.interfaces.cli import main

    t0 = time.perf_counter()
    run_main(main, ["--data-dir", str(data), "--device", "cuda", "index",
                    "--claude-dir", str(projects.parent), "--trace",
                    str(work / "trace")], CLAUDE_SEARCH_MODEL="smoke-mpnet")
    events = json.loads((work / "trace" / "trace.json").read_text())[
        "traceEvents"]
    kernels = {short_kernel_name(e["name"]) for e in events
               if e.get("cat") == "kernel"}
    found = {src: sorted(global_names(src) & kernels)
             for src in ("mpnet_attention", "int8_ffn_ln")}
    print(f"[storage] index --trace seconds={time.perf_counter() - t0:.2f} "
          f"device kernels={len(kernels)} of the encoder sources: {found}",
          flush=True)
    if not all(found.values()):
        fail(f"the trace names no kernel of {found}: {sorted(kernels)[:20]}")


DAEMON_HTTP_CALLS = 16


# The flash step: all-mpnet-base-v2 at full width over an indexing wave
# (B 128 at the 384 bucket); FLASH_REF_ROWS of them again on the CPU.
FLASH_BATCH, FLASH_SEQ, FLASH_REF_ROWS = 128, 384, 8


def run_flash_encoder(engine) -> dict:
    """The main path's encoder (all-mpnet-base-v2, 12 layers, H 768, bf16,
    the int8 FFN as its gate left it) through ``forward(attention_impl=
    "flash")`` at B 128, S 384 on the card, with the launch counts set to 0
    just before and read just after; the first ``FLASH_REF_ROWS``
    embeddings against the same weights on the CPU in the flash mode
    (cosine > 0.999, the encoder gate), and the forward's time beside the
    default (``"pallas"``) mode's."""
    import copy

    import torch

    from tpu_search_torch.ops import _build

    emb = engine.embedder
    model, int8 = emb._model, emb._int8_ffn
    cfg = model.config
    gen = torch.Generator().manual_seed(21)
    ids = torch.randint(5, cfg.vocab_size, (FLASH_BATCH, FLASH_SEQ),
                        generator=gen)
    lengths = torch.randint(8, FLASH_SEQ + 1, (FLASH_BATCH,), generator=gen)
    lengths[0] = FLASH_SEQ
    live = torch.arange(FLASH_SEQ)[None, :] < lengths[:, None]
    ids = torch.where(live, ids, cfg.pad_token_id)
    mask = live.to(torch.int32)
    dev = next(model.parameters()).device
    dids, dmask = ids.to(dev), mask.to(dev)

    def forward(impl):
        return model(dids, dmask, int8_ffn=int8, attention_impl=impl)

    with torch.inference_mode():
        _build.reset_launches()
        torch.cuda.synchronize()
        got = forward("flash")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if launches["flash_attention"] != cfg.num_layers:
            fail(f"the flash forward launched {launches}")
        flash_ms, pallas_ms = paired_ms(lambda: forward("flash"),
                                        lambda: forward("pallas"), iters=3)
        cpu_model = copy.deepcopy(model).to("cpu")
        if int8:
            cpu_model.quantize_ffn()
        ref = cpu_model(ids[:FLASH_REF_ROWS], mask[:FLASH_REF_ROWS],
                        int8_ffn=int8, attention_impl="flash")
    got = got.float().cpu()
    cos = float((got[:FLASH_REF_ROWS] * ref).sum(dim=1).min())
    print(f"[flash_encoder] model=all-mpnet-base-v2 layers={cfg.num_layers} "
          f"hidden={cfg.hidden_size} B={FLASH_BATCH} S={FLASH_SEQ} "
          f"int8_ffn={int8} flash_forward_ms={flash_ms:.4f} "
          f"pallas_forward_ms={pallas_ms:.4f} "
          f"cuda_vs_cpu_min_cosine={cos:.6f} (rows {FLASH_REF_ROWS}) "
          f"finite={bool(torch.isfinite(got).all())} "
          f"launches={launches['flash_attention']}", flush=True)
    if not bool(torch.isfinite(got).all()) or got.shape != (
            FLASH_BATCH, cfg.hidden_size):
        fail("the flash forward gave non-finite or misshapen embeddings")
    if not cos > 0.999:
        fail("the flash forward on the card disagrees with the CPU")
    return launches


def chunk_embeddings(engine):
    """The indexed chunks' texts, encoded again: ``[total, D]`` f32."""
    storage = engine.storage
    rows = storage.meta.rows_for_vec_ids(list(range(storage.index.ntotal)))
    return engine.embedder._encode_texts([rows[i]["text"] for i in sorted(rows)])


def gaussian_rows():
    """The rows of ``tests/test_index_int4.py``'s recall test: 8192 unit
    Gaussian rows of 768 dims (seed 9)."""
    import numpy as np

    x = np.random.default_rng(9).standard_normal((8192, 768)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def recall_at_10(emb, dtype: str):
    """Recall@10 of a ``dtype`` FlatIndex against a bf16 one, both built on
    the card from ``emb``, queried with 64 of its rows (each query's own row
    counts).  Also describes how alike the rows are: the median cosine of
    a query with its 2nd and 10th bf16 neighbours."""
    import numpy as np
    import torch

    from tpu_search_torch.index.flat import FlatIndex

    dev = torch.device("cuda")
    quant, ref = (FlatIndex(emb.shape[1], dtype=t, device=dev)
                  for t in (dtype, "bfloat16"))
    quant.add(emb)
    ref.add(emb)
    queries = emb[np.random.default_rng(5).choice(len(emb), 64, replace=False)]
    _, got = quant.search(queries, 10)
    ref_s, want = ref.search(queries, 10)
    recall = float(np.mean([len(set(g) & set(w)) / 10
                            for g, w in zip(got, want)]))
    spread = (f"median cos to the 2nd / 10th neighbour "
              f"{np.median(ref_s[:, 1]):.4f} / {np.median(ref_s[:, 9]):.4f}")
    return recall, spread


def run_quant_path(work: Path, files, dtype: str) -> dict:
    """The main path with ``CLAUDE_SEARCH_STORAGE_DTYPE=dtype`` in a fresh
    data directory (the same checkpoint): index, search (filtered, and at
    ``top_k=200``), the CLI on the saved index.  Returns the launch counts
    of that run (set to 0 just before it)."""
    import torch

    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.ops import _build

    data = work / f"data_{dtype}"
    data.mkdir()
    (data / "models").symlink_to(work / "data" / "models")
    env = {"CLAUDE_SEARCH_STORAGE_DTYPE": dtype}
    os.environ.update(env)
    try:
        engine = SearchEngine(str(data), model_name="smoke-mpnet",
                              use_warm_server=False, device="cuda")
        total, after_index = index_path(engine, files, dtype, dtype)

        index, slot = engine.storage.index, engine.storage.chunk_id_to_faiss_id
        gaps = []

        def sigma(chunk_id):
            return float(index._scales[slot[chunk_id]]) / math.sqrt(12.0)

        probes = search_path(engine, total, dtype,
                             tie_hit(engine, sigma, dtype == "int8", gaps))
        print_gaps(dtype, gaps)
        t0 = time.perf_counter()
        wide = engine.search_conversations(probes[5].text, top_k=200)
        torch.cuda.synchronize()
        print(f"[search] path={dtype} top_k=200 results={len(wide)} "
              f"ms={(time.perf_counter() - t0) * 1000:.3f}", flush=True)
        if len(wide) != 200:
            fail(f"top_k=200 on the {dtype} path returned {len(wide)}")
        launches = dict(_build.LAUNCHES)
        searched = {k: launches[k] - after_index[k] for k in launches}
        print(f"[launches] path={dtype} index={after_index} "
              f"search={searched}", flush=True)
        if any(searched[k] == 0 for k in path_kernels(dtype)):
            fail(f"the {dtype} search did not run its kernel: {searched}")
        emb = chunk_embeddings(engine)
        recall, spread = recall_at_10(emb, dtype)
        gauss, _ = recall_at_10(gaussian_rows(), dtype)
        print(f"[recall] path={dtype} recall_at_10_vs_bf16 embeddings="
              f"{recall:.4f} ({total} rows, 64 queries; {spread}) "
              f"gaussian_rows={gauss:.4f} (8192 x 768, 64 queries)",
              flush=True)
        if dtype == "int4" and gauss < 0.6:
            fail(f"int4 recall@10 on Gaussian rows {gauss:.4f} < 0.6")
        step = cli_search(engine, data, probes[4].text, dtype, env)
        if dtype != "int8":
            cli_in_background(str(data), step)
            return launches
        fault = step()
        if fault:
            fail(fault)
        warm_exact_pass(engine, data, probes, dtype, "flat_topk_int8")
        return launches
    finally:
        for key in env:
            os.environ.pop(key, None)


def cli_optimize(data_dir: Path, tag: str, env_extra: dict):
    """``optimize`` through the CLI on the saved index, as a step (a
    fault's message, or None)."""
    env = dict(os.environ, CLAUDE_SEARCH_MODEL="smoke-mpnet", **env_extra)

    def step():
        t0 = time.perf_counter()
        proc = run_cli(["--data-dir", str(data_dir), "--device", "cuda",
                        "optimize"], env)
        out = " | ".join(line.strip() for line in proc.stdout.splitlines())
        print(f"[cli] path={tag} optimize seconds="
              f"{time.perf_counter() - t0:.2f} rc={proc.returncode} "
              f"out={out}", flush=True)
        if proc.returncode != 0 or "Optimization complete" not in proc.stdout:
            return f"CLI optimize on {tag} failed: {proc.stderr[-2000:]}"
        return None

    return step


def run_ivf_path(work: Path, files, dtype: str, opq: bool = False) -> dict:
    """The main path with ``CLAUDE_SEARCH_INDEX_TYPE=ivf`` and
    ``CLAUDE_SEARCH_STORAGE_DTYPE=dtype`` (with ``opq``,
    ``CLAUDE_SEARCH_PQ_OPQ=1``) in a fresh data directory: index
    (auto-train, rebalance, nprobe autotune; int4 and pq with their refine
    tier and calibration, pq through ``tune_pq_config``), search (filtered,
    and at ``top_k=200``), the CLI on the saved index, ``optimize`` through
    the CLI (not with ``opq``; both on a background thread where the path
    ends there), and for int4 and pq the warm server's answers.  Returns the launch counts of that run (set to 0 after the
    warm-up)."""
    import torch

    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.ops import _build

    tag = f"ivf_{dtype}" + ("_opq" if opq else "")
    data = work / f"data_{tag}"
    data.mkdir()
    (data / "models").symlink_to(work / "data" / "models")
    env = {"CLAUDE_SEARCH_INDEX_TYPE": "ivf",
           "CLAUDE_SEARCH_STORAGE_DTYPE": dtype}
    if opq:
        env["CLAUDE_SEARCH_PQ_OPQ"] = "1"
    os.environ.update(env)
    try:
        engine = SearchEngine(str(data), model_name="smoke-mpnet",
                              use_warm_server=False, device="cuda")
        total, _ = index_path(engine, files, tag, dtype, IVF_WARM_FILES)
        index = engine.storage.index
        cal = {k: v for k, v in (index._quant_cal or {}).items()
               if k != "trail"}
        print(f"[ivf] path={tag} nlist={index.nlist} cap="
              f"{index._cluster_capacity} padding="
              f"{json.dumps(index.padding_stats())} nprobe_hint="
              f"{index.nprobe_hint} refine={index.refine_dtype} "
              f"refine_factor={index.refine_factor} calibration="
              f"{json.dumps(cal)}", flush=True)
        if dtype == "pq":
            print(f"[ivf] path={tag} pq_m={index.pq_m} opq={index.opq} "
                  f"rotation={index._pq_rot is not None} pq_auto="
                  f"{index.pq_auto} tune={json.dumps(index._pq_tune_report)}",
                  flush=True)
            if opq != (index._pq_rot is not None) or index.pq_auto == opq:
                fail(f"the {tag} path built pq_auto={index.pq_auto} "
                     f"rotation={index._pq_rot is not None}")
            if not opq and index._pq_tune_report is None:
                fail(f"the {tag} path did not run tune_pq_config")
        if dtype in ("int4", "pq") and not opq and not cal.get("calibrated"):
            fail(f"the {tag} path did not calibrate: {cal}")
        slot = engine.storage.chunk_id_to_faiss_id

        def sigma(chunk_id):
            vid = slot[chunk_id]
            if index._refine is not None:  # refine rows score the result
                return float(index._refine.scales[vid]) / math.sqrt(12.0)
            cap = index._cluster_capacity
            fi = int(index._slot_cluster[vid]) * cap + int(
                index._slot_pos[vid])
            if dtype == "pq":
                # A pq row scores a unit query at most |x - decode(x)| off
                # its row x (Cauchy-Schwarz): half of it here makes the tie
                # bound at least the two rows' errors added.
                x = torch.from_numpy(engine.embedder._encode_texts(
                    [engine.storage.get_chunk_by_id(chunk_id).text])).cuda()
                x = x / x.norm()
                rec = index._gather_dequant(
                    torch.tensor([fi], device="cuda"), index._dcent)
                return float((x - rec).norm()) / 2.0
            return float(index._dscale.reshape(-1)[fi]) / math.sqrt(12.0)

        gaps = []
        check = rank_one if dtype == "bfloat16" else tie_hit(
            engine, sigma, dtype == "int8", gaps)
        probes = search_path(engine, total, tag, check)
        if gaps:
            print_gaps(tag, gaps)
        t0 = time.perf_counter()
        wide = engine.search_conversations(probes[5].text, top_k=200)
        torch.cuda.synchronize()
        print(f"[search] path={tag} top_k=200 results={len(wide)} "
              f"ms={(time.perf_counter() - t0) * 1000:.3f}", flush=True)
        if len(wide) != 200:
            fail(f"top_k=200 on the {tag} path returned {len(wide)}")
        launches = dict(_build.LAUNCHES)
        print(f"[launches] path={tag} index+search={launches}", flush=True)
        wanted = [k for k, path in PATH_OF.items() if path == tag]
        if dtype == "pq":  # no kernel scans pq: the encoder's run
            wanted += ["mpnet_attention", "int8_ffn_ln"]
        if dtype in ("int4", "pq") and not opq:
            wanted.append("flat_topk_int8")  # the calibration's truth scan
        if any(launches[k] == 0 for k in wanted):
            fail(f"the {tag} path did not run {wanted}: {launches}")
        steps = [cli_search(engine, data, probes[4].text, tag, env)]
        if not opq:
            steps.append(cli_optimize(data, tag, env))
        if dtype not in ("int4", "pq") or opq:
            # nothing later in the path reads the directory
            for step in steps:
                cli_in_background(str(data), step)
            return launches
        for step in steps:
            fault = step()
            if fault:
                fail(fault)
        warm_exact_pass(engine, data, probes, tag,
                        "ivf_topk_int4" if dtype == "int4"
                        else "mpnet_attention")
        if dtype == "int4":
            # The saved index (with its refine tier) over 4 shards: its
            # fused, classic and warm answers against one device's.
            sharded = run_sharded_serving(engine, work, total, data=data,
                                          tag=tag)
            launches = {k: n + sharded.get(k, 0)
                        for k, n in launches.items()}
        return launches
    finally:
        for key in env:
            os.environ.pop(key, None)


def run_bert_path(work: Path, files):
    """The main path with an all-MiniLM-L6-v2 embedder (BERT, full width,
    random weights, mean pooling) on flat bf16 storage: index, the 20
    searches, the CLI.  The cross-encoders and the tiny-overlap fixture go
    into the same data directory for the rerank paths.  Returns ``(engine,
    data dir, probes, launch counts)``."""
    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.ops import _build
    from tpu_search_torch.utils.synthetic import write_bert_model

    tag, data = "minilm", work / "data_minilm"
    t0 = time.perf_counter()
    for seed, name in enumerate(("all-MiniLM-L6-v2", "ms-marco-MiniLM-L-6-v2",
                                 "ms-marco-TinyBERT-L-4")):
        write_bert_model(data / "models" / name, name, 30 + seed)
    shutil.copytree(ROOT / "tests" / "fixtures" / "tiny-overlap",
                    data / "models" / "tiny-overlap")
    print(f"[setup] path={tag} checkpoints seconds="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    engine = SearchEngine(str(data), model_name="all-MiniLM-L6-v2",
                          use_warm_server=False, device="cuda")
    total, after_index = index_path(engine, files, tag, "bfloat16")
    gaps = []
    probes = search_path(engine, total, tag, bf16_tie_hit(gaps))
    print_gaps(tag, gaps)
    launches = dict(_build.LAUNCHES)
    searched = {k: launches[k] - after_index[k] for k in launches}
    print(f"[launches] path={tag} index={after_index} search={searched}",
          flush=True)
    if any(searched[k] == 0 for k in path_kernels("bfloat16")):
        fail(f"the {tag} search did not run every kernel: {searched}")
    cos = check_encoder_reference(engine, [p.text[:200] for p in probes[:4]])
    print(f"[reference] path={tag} cuda_vs_cpu_plain_min_cosine={cos:.6f}",
          flush=True)
    if not cos > 0.999:
        fail("CUDA MiniLM encoder disagrees with the plain CPU encoder")
    cli_in_background(str(data), cli_search(engine, data, probes[4].text,
                                             tag, {},
                                             model="all-MiniLM-L6-v2"))
    return engine, data, probes, launches


def cpu_twin(reranker):
    """The same cross-encoder checkpoint on the CPU (f32, plain versions)."""
    from tpu_search_torch.models.cross_encoder import CrossEncoder

    twin = CrossEncoder(dataclasses.replace(reranker.config, device="cpu"))
    twin.load_model()
    return twin


def classifier_reference(reranker, twin, pairs):
    """The reranker on the card and its CPU twin on ``pairs``, as one
    padded batch: each side's logits (the first label, before the sigmoid)
    and the minimum cosine of the final CLS hidden states (random-weight
    classifiers give every pair about one logit, so the hidden state is
    what shows the kernels' work)."""
    import torch

    from tpu_search_torch.models.cross_encoder import SEQ_BUCKETS
    from tpu_search_torch.utils.shapes import bucket_size

    tok, max_len = reranker._tokenizer, reranker.max_length
    width = bucket_size(max(len(tok.encode_pair(a, b, max_len)[0])
                            for a, b in pairs), SEQ_BUCKETS)
    ids, types, mask = (torch.from_numpy(a).long() for a in
                        tok.encode_pair_batch(pairs, max_len, pad_to=width))
    hidden, logits = {}, {}
    for name, enc in (("cuda", reranker), ("cpu", twin)):
        args = [t.to(enc.device) for t in (ids, mask, types)]
        with torch.inference_mode():
            out = enc._model.forward_hidden(args[0], args[1],
                                            token_type_ids=args[2])
            hidden[name] = out[:, 0].float().cpu()
            logits[name] = enc._model.classify(*args)[:, 0].float().cpu()
    cos = torch.nn.functional.cosine_similarity(hidden["cuda"],
                                                hidden["cpu"], dim=1)
    return logits["cuda"].numpy(), logits["cpu"].numpy(), float(cos.min())


@contextlib.contextmanager
def plain_attention():
    """The encoder layers' attention through its plain versions on the
    card (the kernels' oracle) while inside: the rerank logits the
    attention kernels are held to."""
    import tpu_search_torch.models.mpnet as M
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention_bhsd_plain,
        mpnet_attention_plain,
    )

    saved = M.mpnet_attention, M.mpnet_attention_bhsd
    M.mpnet_attention = mpnet_attention_plain
    M.mpnet_attention_bhsd = mpnet_attention_bhsd_plain
    try:
        yield
    finally:
        M.mpnet_attention, M.mpnet_attention_bhsd = saved


def outranks_ok(got, want, tie: float) -> bool:
    """Every pair that ``want`` orders by more than ``tie``, ``got`` orders
    the same way: the orders agree outside ties."""
    return all(got[i] > got[j] for i in range(len(want))
               for j in range(len(want)) if want[i] - want[j] > tie)


def check_logit_order(tag: str, case: str, card, ref,
                      ref_name: str = "cpu") -> None:
    """The card's logits against a reference's (the CPU's, or the card's
    with the plain attention): print both orders, the largest difference,
    the smallest reference gap and the ties; fail unless every logit is
    within ``RERANK_LOGIT_TOL`` and the orders agree outside ties."""
    import numpy as np

    tie = 2 * RERANK_LOGIT_TOL
    card_order = np.argsort(-card, kind="stable").tolist()
    ref_order = np.argsort(-ref, kind="stable").tolist()
    diff = float(np.abs(card - ref).max())
    same = outranks_ok(card, ref, tie)
    gaps = np.abs(ref[:, None] - ref[None, :])[np.triu_indices(len(ref), 1)]
    print(f"[rerank] path={tag} case={case} cuda_logit_order={card_order} "
          f"{ref_name}_logit_order={ref_order} "
          f"identical={card_order == ref_order} "
          f"agree_outside_ties={same} max_abs_logit_diff={diff:.4e} "
          f"min_{ref_name}_logit_gap={float(gaps.min()):.4e} "
          f"{ref_name}_logit_std={float(np.std(ref)):.4e} "
          f"tie_pairs={int((gaps <= tie).sum())}/{len(gaps)}", flush=True)
    if not (diff <= RERANK_LOGIT_TOL and same):
        fail(f"{tag} {case}: the card's logits disagree with the "
             f"{ref_name} logits")


def check_fixture_orderings(reranker, twin) -> None:
    """``tests/test_rerank_quality.py::TestFixtureQuality``'s ordering
    cases, scored by the trained tiny-overlap reranker on the card and on
    the CPU's plain path: each case's assertions hold on both, and the two
    logit orders agree outside ties."""
    import numpy as np

    query = "alpha bravo charlie delta echo foxtrot"
    relevant = ["alpha bravo charlie delta echo foxtrot",
                "delta echo foxtrot alpha kilo lima",
                "bravo charlie delta mike november"]
    irrelevant = ["apple banana cherry grape lemon mango",
                  "kilo lima mike november oscar papa",
                  "alphax bravox charliex deltax echox foxtrotx",
                  "apple apple apple apple apple apple"]
    by_overlap = ["apple banana cherry grape lemon mango",
                  "alpha bravo charlie delta echo foxtrot",
                  "alpha bravo charlie kilo lima mike"]
    for name, docs in (("separation", relevant + irrelevant),
                       ("rank_by_overlap", by_overlap)):
        pairs = [(query, d) for d in docs]
        for device, enc in (("cuda", reranker), ("cpu", twin)):
            scores = enc.predict(pairs)
            order = np.argsort(-scores, kind="stable")
            if name == "separation":
                ok = (scores[:3].min() > scores[3:].max()
                      and scores[:3].mean() > 0.9 and scores[3:].mean() < 0.1)
            else:
                ok = set(order[:2].tolist()) == {1, 2} and order[-1] == 0
            if not ok:
                fail(f"fixture case {name} fails on {device}: {scores}")
        card, cpu, _ = classifier_reference(reranker, twin, pairs)
        check_logit_order("rerank_fixture", name, card, cpu)


def run_rerank_path(engine, data: Path, probes, tag: str, model: str,
                    kernels) -> dict:
    """``search_conversations(rerank=True)`` with ``model`` over the 16
    probes (top_k 10, factor 5: 50 candidates, batch bucket 128) after one
    warm-up query, launch counts set to 0 just before and read just after;
    the reranker against its CPU twin (CLS hidden-state cosine; the
    trained fixture's logits too) and against itself with the plain
    attention (logits); ``search --rerank --json``."""
    import numpy as np
    import torch

    from tpu_search_torch.ops import _build

    def rerank(text):
        return engine.search_conversations(
            text, top_k=RERANK_TOP_K, rerank=True, rerank_model=model,
            rerank_factor=RERANK_FACTOR)

    t0 = time.perf_counter()
    rerank(probes[0].text)  # loads the reranker
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    reranker = engine._rerankers.get(model)
    if reranker is None:
        fail(f"the {model} reranker did not load")
    _build.reset_launches()
    torch.cuda.synchronize()
    times = []
    for probe in probes:
        t0 = time.perf_counter()
        results = rerank(probe.text)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        scores = [r.get("rerank_score") for r in results]
        if len(results) != RERANK_TOP_K or None in scores:
            fail(f"{tag}: {len(results)} results, scores {scores}")
        if scores != sorted(scores, reverse=True):
            fail(f"{tag}: results not in rerank order: {scores}")
    launches = dict(_build.LAUNCHES)
    print(f"[rerank] path={tag} model={model} layers="
          f"{reranker._model_config.num_layers} hidden="
          f"{reranker._model_config.hidden_size} layout="
          f"{reranker._model.layers[0].layout} candidates="
          f"{RERANK_TOP_K * RERANK_FACTOR} queries={len(times)} "
          f"first_call_s={warm:.2f} p50_ms={np.median(times):.3f} "
          f"p90_ms={np.percentile(times, 90):.3f} max_ms={max(times):.3f} "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if any(launches[k] == 0 for k in kernels):
        fail(f"the {tag} path did not run {kernels}: {launches}")

    cands = engine.search_conversations(probes[1].text, top_k=8)
    pairs = [(probes[1].text, c["text"]) for c in cands]
    twin = cpu_twin(reranker)
    card, cpu, cos = classifier_reference(reranker, twin, pairs)
    with plain_attention():
        plain, _, _ = classifier_reference(reranker, twin, pairs)
    print(f"[reference] path={tag} cuda_vs_cpu_plain pairs={len(pairs)} "
          f"min_cls_hidden_cosine={cos:.6f} max_abs_logit_diff="
          f"{float(np.abs(card - cpu).max()):.4e} plain_attention_max_abs_"
          f"logit_diff={float(np.abs(plain - cpu).max()):.4e}", flush=True)
    if not cos > 0.999:
        fail(f"{tag}: the card's reranker disagrees with the CPU's")
    check_logit_order(tag, "kernels_vs_plain_attention", card, plain,
                      "plain_attention")
    if model == "tiny-overlap":
        check_logit_order(tag, "probe_candidates", card, cpu)
        check_fixture_orderings(reranker, twin)
    cli_in_background(str(data), cli_search(
        engine, data, probes[4].text, tag, {}, model="all-MiniLM-L6-v2",
        rerank_model=model))
    return launches


def run_int8_bench() -> dict:
    """The int8 GEMM bench at full size (all-mpnet-base-v2's FFN, M = 128 x
    384), its entry point ``int8_gemm_bench.run``, with the launch counts
    set to 0 just before and read just after; the int8 pair must keep a
    cosine of at least 0.999 to the bf16 FFN."""
    import torch

    from tpu_search_torch.benchmarks import int8_gemm_bench
    from tpu_search_torch.ops import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = int8_gemm_bench.run("cuda")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for name, r in out["results"].items():
        tops = "" if r["tops"] is None else f" effective_tops={r['tops']:.1f}"
        print(f"[int8_bench] {name} M={out['shape']['m']} H="
              f"{out['shape']['h']} I={out['shape']['i']} reps={out['reps']} "
              f"ms={r['ms']:.4f}{tops}", flush=True)
    print(f"[int8_bench] cos_int8_pair_vs_bf16="
          f"{out['cos_int8_pair_vs_bf16']:.6f} seconds="
          f"{time.perf_counter() - t0:.2f} launches="
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if out["cos_int8_pair_vs_bf16"] < 0.999:
        fail(f"int8 pair cosine {out['cos_int8_pair_vs_bf16']} < 0.999")
    if any(launches[k] == 0 for k in path_kernels("int8_bench")):
        fail(f"the int8 bench did not run its kernels: {launches}")
    return launches


def run_probes(results: dict) -> dict:
    """The int4 and scan-overhead probes: every variant against its plain
    version at a small N, then both at full size (1M x 768), with the
    launch counts set to 0 just before and read just after."""
    import torch

    from tpu_search_torch.benchmarks import int4_probe, scan_overhead_probe
    from tpu_search_torch.ops import _build

    for module, tol in ((int4_probe, 0.0),
                        (scan_overhead_probe, scan_overhead_probe.SCORE_TOL)):
        name = module.__name__.rsplit(".", 1)[-1]
        errors = module.check("cuda")
        print(f"[{name}] check max_abs_err={json.dumps(errors)}", flush=True)
        if not all(e <= tol for e in errors.values()):
            fail(f"{name} disagrees with its plain versions: {errors}")
        results[name] = {"max_abs_err": max(errors.values())}

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    int4 = int4_probe.run("cuda")
    overhead = scan_overhead_probe.run("cuda")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for name, out in (("int4_probe", int4),
                      ("scan_overhead_probe", overhead)):
        for key, r in out["results"].items():
            gbps = "" if r["gbps"] is None else f" gbps={r['gbps']:.1f}"
            print(f"[{name}] {key} ms={r['ms']:.4f} wall_ms="
                  f"{r['wall_ms']:.4f}{gbps} bound_ms={r['bound_ms']:.4f}",
                  flush=True)
    print(f"[probes] seconds={time.perf_counter() - t0:.2f} launches="
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if any(launches[k] == 0 for k in path_kernels("probes")):
        fail(f"the probes did not run their kernels: {launches}")

    # The headline rows: the production structure of each scan, at the
    # shortest row range, against its plain version at full size.
    corpus, prep = int4_probe.make_inputs(1 << 20, 0, "cuda")
    head = "full_t2048"
    plain_ms = cuda_ms(lambda: int4_probe.plain("full", corpus, prep),
                       iters=2)
    results["int4_probe"].update(
        ms=int4["results"][head]["ms"], plain_ms=plain_ms,
        bound_ms=int4["results"][head]["bound_ms"], bound_by="bytes",
        library_ms=None)
    del corpus, prep
    vectors, penalty, queries = scan_overhead_probe.make_inputs(
        1 << 20, 0, "cuda")
    head = "t2048_prod_r20"
    plain_ms = cuda_ms(lambda: scan_overhead_probe.plain(
        "prod", vectors, penalty, queries), iters=2)
    results["scan_overhead_probe"].update(
        ms=overhead["results"][head]["ms"], plain_ms=plain_ms,
        bound_ms=overhead["results"][head]["bound_ms"], bound_by="bytes",
        library_ms=None)
    return launches


# -- main ----------------------------------------------------------------------


# The bulk build ([adopt]): the padded paths adopt ADOPT_N rows (short of
# their 65,536-aligned capacity), the packed words ADOPT_WORDS_N (their
# capacity: adopted as they are).  The fused window on them runs a one-layer
# all-mpnet-base-v2-wide encoder (seeded random weights) over 8 texts.
ADOPT_N, ADOPT_WORDS_N = 1_000_000, 1 << 20
ADOPT_CASES = (("float32", "f32"), ("bfloat16", "f32"), ("bfloat16", "bf16"),
               ("int8", "f32"), ("int8", "bf16"), ("int4", "f32"),
               ("int8", "words"))
# The 10M capacity run must find at least this share of the f32 truth's
# top 10 (int8 rows of unit vectors: the JAX script's recall on its chip
# is the reference point, not a gate; 0.9 leaves room for near-ties).
SCALE_MIN_RECALL = 0.9


def adopted_window(index, model, ids, mask):
    """The fused window (``api/fused.py``) of ``index``'s scan with
    ``model`` as its encoder, q_pad 8, k 10, nothing filtered."""
    import torch

    from tpu_search_torch.api.fused import Window
    from tpu_search_torch.index.flat import flat_scan

    key, buffers = index.make_scan_fn()
    return Window(model=model, ids=ids, mask=mask, q_pad=8,
                  staged=index.scan_staged(None), normalize=True,
                  int8_ffn=False, store_normalize=True, scan=flat_scan,
                  scan_key=key, buffers=buffers, k=10,
                  device=torch.device("cuda"))


def check_adopted_fused(tag: str, index, model, kernel: str) -> dict:
    """The fused window on an adopted index, captured, then replayed with
    the launch counts set to 0, against the classic path (the same encoded
    queries through ``FlatIndex.search``): ids equal, scores within
    ``WARM_EXACT``.  Returns the replay's launches."""
    import numpy as np
    import torch

    from tpu_search_torch.api.fused import FusedPrograms, _encode
    from tpu_search_torch.ops import _build

    rng = np.random.default_rng(43)
    ids = rng.integers(5, model.config.vocab_size, (8, 64)).astype(np.int64)
    mask = np.ones((8, 64), dtype=np.int64)
    w = adopted_window(index, model, ids, mask)
    programs = FusedPrograms()
    packed, event = programs.dispatch(w)  # the capture
    event.synchronize()
    _build.reset_launches()
    packed, event = programs.dispatch(w)  # a replay
    event.synchronize()
    launches = dict(_build.LAUNCHES)
    with torch.inference_mode():
        queries = _encode(w, torch.from_numpy(ids).cuda(),
                          torch.from_numpy(mask).cuda())
    scores, got = index.search(queries.cpu().numpy(), 10)
    fused_ids = np.rint(packed[:, 10:].numpy()).astype(np.int64)
    fused_ids[~np.isfinite(packed[:, :10].numpy())] = -1
    err = float(np.abs(packed[:, :10].numpy() - scores).max())
    same = bool(np.array_equal(fused_ids, got))
    print(f"[adopt] fused {tag}: key={w.scan_key} replay_launches="
          f"{json.dumps({k: v for k, v in launches.items() if v})} "
          f"ids_equal_classic={same} max_abs_err={err:.3e}", flush=True)
    if not same or err > WARM_EXACT:
        fail(f"[adopt] the fused window on the adopted {tag} index differs "
             f"from the classic path")
    if launches[kernel] == 0:
        fail(f"[adopt] the fused window on {tag} did not launch {kernel}")
    return launches


def check_adopt() -> dict:
    """``[adopt]``: ``FlatIndex.from_device_vectors`` on the card, 1M x 768
    unit rows made there, in each of ``ADOPT_CASES`` (f32 and bf16 sources;
    int8 words of 2^20 rows adopted as they are), each against ``add`` of
    the same rows: the same capacity, stored bits and scales, and ids and
    scores at Q 8; the device memory the adoption took above its source
    (its output and a chunk; about none for the words); then the fused
    window (``api/fused.py``, a CUDA graph) on the adopted bf16 and word
    index against the classic path.  Returns the fused replays' launches."""
    import numpy as np
    import torch

    from tpu_search_torch.index.flat import FlatIndex, quantize_rows_int8
    from tpu_search_torch.models.convert import model_from_params
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params
    from tpu_search_torch.ops.int8_pack import pack_int8_rows

    dev = torch.device("cuda")
    card = card_name()
    gen = torch.Generator(device=dev).manual_seed(41)
    rows = unit_rows(gen, ADOPT_WORDS_N, 768)
    queries = unit_rows(gen, 8, 768).cpu().numpy()
    words, word_scales = None, None
    kept = {}
    for dtype, source in ADOPT_CASES:
        if source == "words":
            codes, word_scales = quantize_rows_int8(rows)
            words = pack_int8_rows(codes)
            del codes
            src, n = rows, ADOPT_WORDS_N
        else:
            src = rows[:ADOPT_N]
            if source == "bf16":
                src = src.to(torch.bfloat16)
            n = ADOPT_N
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if source == "words":
            adopted = FlatIndex.from_device_vectors(
                words, dtype="int8", scales=word_scales, packed=True)
        else:
            adopted = FlatIndex.from_device_vectors(src, dtype=dtype)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak_mb = (torch.cuda.max_memory_allocated() - before) / 2**20
        stored = adopted._vectors
        out_mb = (stored.numel() * stored.element_size()
                  + (0 if adopted._scales is None
                     else adopted._scales.numel() * 4)
                  + adopted._valid.numel()) / 2**20
        added = FlatIndex(768, dtype=dtype, device=dev)
        added.add(src)
        # stored rows: int4 two a byte row, int8 four a word
        rows_of = {"int4": (n + 1) // 2, "int8": n // 4}.get(dtype, n)
        bits = (adopted.capacity == added.capacity
                and (adopted.ntotal, adopted.live) == (n, n)
                and torch.equal(stored[:rows_of], added._vectors[:rows_of]))
        if adopted._scales is not None:
            bits &= torch.equal(adopted._scales[:n], added._scales[:n])
        got, want = adopted.search(queries, 10), added.search(queries, 10)
        same = bool(np.array_equal(got[1], want[1])
                    and np.array_equal(got[0], want[0]))
        zero_copy = (source == "words"
                     and adopted._vectors.data_ptr() == words.data_ptr())
        print(f"[adopt] dtype={dtype} source={source} n={n} capacity="
              f"{adopted.capacity} zero_copy={zero_copy} seconds={seconds:.3f} peak_over_source_mb="
              f"{peak_mb:.1f} output_mb={out_mb:.1f} bits_equal_add={bits} "
              f"answers_equal_add={same} card={card!r}", flush=True)
        if not (bits and same):
            fail(f"[adopt] {dtype} from {source} differs from add of the "
                 f"same rows")
        if source == "words" and not zero_copy:
            fail("[adopt] the packed words were not adopted as they are")
        if source == "words" and peak_mb > 64:
            fail(f"[adopt] adopting the words took {peak_mb:.1f} MB")
        del added
        if (dtype, source) in (("bfloat16", "f32"), ("int8", "words")):
            kept[dtype] = adopted
    del rows
    config = MPNetConfig(num_layers=1)
    model = model_from_params(init_params(config, 5), config)
    model.layers.to(torch.bfloat16)
    model = model.to(dev)
    launches = {}
    for dtype, kernel in (("bfloat16", "flat_topk"),
                          ("int8", "flat_topk_int8")):
        for name, count in check_adopted_fused(
                dtype, kept[dtype], model, kernel).items():
            launches[name] = launches.get(name, 0) + count
    return launches


def run_scale_10m(results: dict) -> dict:
    """``[scale_10m]``: the entry point ``benchmarks.scale_10m.run`` at its
    full N (10,027,008 x 768 int8 words, adopted as they are) with the
    launch counts set to 0 just before: recall@10 against the f32 truth at
    least ``SCALE_MIN_RECALL``, the words scanned in their layout
    (``flat_topk_int8.cu``, words), the word scan equal to the row scan on
    the same corpus, the scan's ms and device ms at Q 8 beside its bytes
    bound.  The word layout's launches and 10M numbers go into the int8
    entry's ``words``.  Returns the run's launches."""
    import torch

    from tpu_search_torch.benchmarks import scale_10m
    from tpu_search_torch.index.flat import flat_scan
    from tpu_search_torch.ops import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, index, q8 = scale_10m.run("cuda", against_rows=True)
    launches = out.pop("launches")
    key, buffers = index.make_scan_fn()
    staged = index.scan_staged(None)
    busy, calls = device_breakdown(
        f"scale_10m words N={index.ntotal} Q=8 k=10",
        lambda: flat_scan(key, buffers, staged, q8, 10))
    check_launches("scale_10m words", calls)
    device_ms = {"words": busy}
    del index, buffers, staged
    print(f"[scale_10m] {json.dumps(out)}", flush=True)
    print(f"[scale_10m] seconds={time.perf_counter() - t0:.2f} device_ms_q8="
          f"{device_ms['words']:.4f} bound_ms={out['bound_ms']:.4f} "
          f"share={out['bound_ms'] / device_ms['words']:.4f} "
          f"rows_scan_ms_q8={out['rows_scan_ms_q8']:.4f} launches="
          f"{json.dumps(launches)}", flush=True)
    if out["recall_at_10_vs_f32"] < SCALE_MIN_RECALL:
        fail(f"[scale_10m] recall {out['recall_at_10_vs_f32']}")
    if not out["zero_copy"]:
        fail("[scale_10m] the words were not adopted as they are")
    if not out["words_equal_rows"]:
        fail("[scale_10m] the word scan differs from the row scan")
    if not launches.get("flat_topk_int8"):
        fail(f"[scale_10m] the words scan was never launched: {launches}")
    results["flat_topk_int8"].setdefault("words", {}).update(
        launches=launches["flat_topk_int8"], ms_10m=out["device_scan_ms_q8"],
        device_ms_10m=device_ms["words"], bound_ms_10m=out["bound_ms"])
    return launches


def run_bench_scripts() -> dict:
    """The other ported bulk-build scripts through their entry points
    (``run``), each with the launch counts set to 0 just before and read
    just after: ``ivf_sweep`` (262,144 x 768 blobs, nlist 256 and 1024;
    recall 1.0 at nprobe = nlist), ``sharded_scan`` (8 shards on the card,
    exact), ``int8_residual_ab`` (the JAX bench's 1M x 768, nlist 1024,
    nprobe 16), ``cross_encoder_bench`` (MiniLM-L-6, batch 64, S 256 and
    512) and ``index_e2e`` (200 conversations at full width).  Returns
    each one's launches."""
    import torch

    from tpu_search_torch.benchmarks import (
        cross_encoder_bench,
        index_e2e,
        int8_residual_ab,
        ivf_sweep,
        sharded_scan,
    )
    from tpu_search_torch.ops import _build

    runs = {
        "ivf_sweep": (lambda: ivf_sweep.run(
            "cuda", n=262_144, nlists=(256, 1024), nprobes=(1, 8, 32, 256),
            train_sample=262_144), ("ivf_topk", "flat_topk")),
        "sharded_scan": (lambda: sharded_scan.run("cuda"), ("flat_topk",)),
        "int8_residual_ab": (lambda: int8_residual_ab.run("cuda"),
                             ("ivf_topk_int8",)),
        "cross_encoder_bench": (lambda: cross_encoder_bench.run("cuda"), ()),
        "index_e2e": (lambda: index_e2e.run("cuda", conversations=201),
                      ("mpnet_attention", "int8_ffn_ln")),
    }
    launches = {}
    for name, (call, kernels) in runs.items():
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # parser warnings
            out = call()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in _build.LAUNCHES.items() if v}
        line = {k: v for k, v in out.items() if k not in ("sweep", "rows")}
        print(f"[{name}] {json.dumps(line)}", flush=True)
        for row in out.get("sweep", out.get("rows", [])):
            print(f"[{name}] {json.dumps(row)}", flush=True)
        print(f"[{name}] seconds={time.perf_counter() - t0:.2f} launches="
              f"{json.dumps(launches[name])}", flush=True)
        if any(not launches[name].get(k) for k in kernels):
            fail(f"[{name}] did not launch {kernels}: {launches[name]}")
        if name == "ivf_sweep" and not all(
                r["recall_at_10"] == 1.0 for r in out["sweep"]
                if r["nprobe"] == r["nlist"]):
            fail("[ivf_sweep] recall below 1.0 at nprobe = nlist")
        if name == "sharded_scan" and not out["exact_match_vs_single_device"]:
            fail("[sharded_scan] the sharded ids differ from one device's")
        if name == "cross_encoder_bench" and not all(
                r["kernels"] for r in out["rows"] if r["impl"] == "kernel"):
            fail("[cross_encoder_bench] a kernel row launched no kernel")
        if name == "index_e2e" and (out["errors"] or out["files_processed"]
                                    != out["conversations"]):
            fail(f"[index_e2e] indexing errors: {out['errors']}")
    return launches


@contextlib.contextmanager
def timed_phase(name: str):
    """Prints the seconds a phase of ``main`` took."""
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name} seconds={time.perf_counter() - t0:.2f}",
          flush=True)


def check_capability() -> None:
    """``[capability]``: the device report of the JAX package's contract
    (``devices.assess_gpu_capability``) on the card must say ``cuda``
    and that the card can hold the default corpus."""
    from tpu_search_torch.devices import assess_gpu_capability

    cap = assess_gpu_capability()
    print(f"[capability] backend={cap.backend} "
          f"can_use_accelerator={cap.can_use_accelerator} "
          f"devices={cap.device_count} sm_count={cap.sm_count} "
          f"memory_free_gb={(cap.memory_free or 0) / 1024**3:.2f} "
          f"recommended_batch_size={cap.recommended_batch_size} "
          f"status={cap.status_message!r}", flush=True)
    if cap.backend != "cuda" or not cap.can_use_accelerator:
        fail(f"[capability] the card is not reported usable: {cap}")


def main() -> None:
    import torch

    # Every f32 product of the plain versions in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--cross-process-worker"]:  # spawn_ranks's ranks
        cross_process_worker(json.loads(sys.argv[2]))
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    cross_card = sys.argv[1:] == ["--cross-card"]
    if sys.argv[1:] and not cross_card:
        fail(f"unknown arguments {sys.argv[1:]} (only --cross-card)")
    from tpu_search_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    print(f"[build] sources={list(_build.LIBRARIES)} "
          f"seconds={time.perf_counter() - t0:.2f}", flush=True)
    check_build(built["logs"])
    print(card_name(), flush=True)
    check_capability()
    if cross_card:
        with timed_phase("check_cross_card"):
            check_cross_card()
        with timed_phase("check_cross_process"):
            check_cross_process()
        print_profile_tries()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return

    results: dict = {}
    for check in (check_flat_topk, check_quant_topk, check_attention,
                  check_attention_bhsd, check_flash_attention,
                  check_flash_attention_bwd, check_flash_attention_f32,
                  check_attention_grad, check_attention_f32, check_int8_ffn,
                  check_int8_gemm, check_ivf):
        with timed_phase(check.__name__):
            check(results)
    with timed_phase("check_pq"):
        check_pq()
    with timed_phase("check_sharded"):
        check_sharded()
    with timed_phase("check_sharded_ivf"):
        check_sharded_ivf()
    bulk = {}
    with timed_phase("adopt"):
        bulk["adopt"] = check_adopt()
    with timed_phase("scale_10m"):
        bulk["scale_10m"] = run_scale_10m(results)

    from tpu_search_torch.utils.synthetic import (
        N_CONVERSATIONS,
        write_conversations,
        write_model,
    )

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        config = write_model(work / "data" / "models" / "smoke-mpnet")
        files = write_conversations(work, N_CONVERSATIONS,
                                    config.vocab_size - 5)
        print(f"[setup] checkpoint+{N_CONVERSATIONS} conversations "
              f"seconds={time.perf_counter() - t0:.2f}", flush=True)
        with timed_phase("main_path"):
            launches = dict(zip(
                ("bfloat16", "flash_encoder", "warm", "served"),
                run_main_path(work, files)))
        for dtype in ("int8", "int4"):
            with timed_phase(dtype):
                launches[dtype] = run_quant_path(
                    work, files[: N_QUANT_CONVERSATIONS + 1], dtype)
        for dtype, n in (("bfloat16", N_CONVERSATIONS),
                         ("int8", N_IVF_QUANT_CONVERSATIONS),
                         ("int4", N_IVF_QUANT_CONVERSATIONS),
                         ("pq", N_IVF_QUANT_CONVERSATIONS)):
            with timed_phase(f"ivf_{dtype}"):
                launches[f"ivf_{dtype}"] = run_ivf_path(
                    work, files[: n + IVF_WARM_FILES], dtype)
        with timed_phase("ivf_pq_opq"):
            run_ivf_path(work, files[: N_IVF_QUANT_CONVERSATIONS
                                     + IVF_WARM_FILES], "pq", opq=True)
        with timed_phase("minilm"):
            engine, data, probes, launches["minilm"] = run_bert_path(
                work, files[: N_BERT_CONVERSATIONS + 1])
        for tag, model, kernels in RERANK_PATHS:
            with timed_phase(tag):
                launches[tag] = run_rerank_path(engine, data, probes, tag,
                                                model, kernels)
        launches["rerank"] = {
            k: launches["rerank_tinybert"][k] + launches["rerank_fixture"][k]
            for k in launches["rerank_fixture"]}
        with timed_phase("cli_join"):
            join_cli()
        with timed_phase("int8_bench"):
            launches["int8_bench"] = run_int8_bench()
        with timed_phase("probes"):
            launches["probes"] = run_probes(results)
        with timed_phase("daemon"):
            run_daemon(work, files)
        with timed_phase("storage"):
            launches["storage"] = run_storage(work, files)
        with timed_phase("train"):
            launches["train"] = check_train(work)
        with timed_phase("f32_encoder"):
            launches["f32_encoder"] = check_f32_encoder(
                work / "data" / "models" / "smoke-mpnet")
        with timed_phase("flash_grad"):
            launches["flash_grad"] = check_flash_grad()
        with timed_phase("dryrun"):
            check_dryrun()
        with timed_phase("bench_scripts"):
            bulk.update(run_bench_scripts())
        print(f"[bulk_build] launches={json.dumps(bulk)}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": launches[PATH_OF[name]][name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
            "bound_ms": results[name]["bound_ms"],
            "bound_by": results[name]["bound_by"],
            "library_ms": results[name]["library_ms"],
            **{key: results[name][key] for key in ("words", "fused")
               if key in results[name]},
        }
        for name in _build.KERNELS
    ]}
    print_profile_tries()
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
