#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one card, nvcc

Builds the CUDA kernels from the checkout's sources, holds each against its
plain PyTorch version on the card, then drives the serving and training
paths:

1. environment: versions, ``nvidia-smi`` name and power limit, kernel build
   (one ``nvcc`` per source, in parallel), each kernel's registers, spills
   and dynamic shared memory from ptxas, and ``cuobjdump -sass`` of the flash
   and qmatmul libraries: the run fails unless every bf16 flash forward
   kernel and every bf16 flash backward kernel at hd 64 and 128 holds wgmma
   (``HGMMA``) and TMA (``UTMALDG``) instructions, the bf16 backward at hd
   256 ``mma.sync`` (``HMMA``), and every ``qmatmul_tma`` kernel the int8
   wgmma (``IGMMA``) and TMA with no spills, and every selective-scan
   backward sweep kernel TMA loads and stores (``UTMALDG``, ``UTMASTG``)
   with no spills; the WKV-6 backward's fp64 instructions (``DFMA``,
   ``DMUL``, ``DADD``) by kernel;
2. flash-attention kernel vs its plain version at every shape the later
   phases give it, phases 16-17's five head layouts included (reference
   bounds: 2e-3 fp32, 2e-2 bf16, plus a per-row bound relative to the
   row's size) with kernel / plain / library (SDPA) / bound times;
3. granite-3-8b at full width and depth, bf16, seeded init: the prefill
   planned by the DSE branch of ``plan_for_cell`` (one-chip model axis, the
   reference's TPU v5e cost model), prefill step at B=4 x S=2048 (exactly
   one kernel launch per layer), then the launcher's flow (batch 4, prompt
   64, 32 greedy tokens), and one decode step counted (operations
   dispatched) and traced (device busy time);
4. prefill vs token-by-token decode logits, granite-3-8b full width cut to 4
   layers, fp32 with TF32 off: the kernel against the model's independent
   decode attention;
5. gemma2-9b full width cut to 2 layers (one local, one global): prefill at
   S=8192 so the 4096 window bites, then 8 decode steps;
6. WKV-6 kernel vs its plain version at every shape the later phases give it
   (the reference's bound 2e-4, plus a per-row bound relative to the row's
   size), with kernel / plain / bound times, on the reference's decays and
   on strong ones (w down to 1e-3, some log w = -50; every output finite);
   no single PyTorch call computes WKV-6, so it has no library time;
7. rwkv6-3b at full width and depth, bf16, seeded init: prefill step at
   B=4 x S=2048 (exactly one kernel launch per layer), prefill with the state
   collected then 8 decode steps from it, the launcher's flow (batch 4,
   prompt 64, 32 greedy tokens), and one decode step counted and traced;
8. prefill vs token-by-token decode, rwkv6-3b full width cut to 4 layers,
   fp32 with TF32 off: logits and the final S / shift / shift_ffn state, the
   kernel against the model's plain one-step scan;
9. selective-scan (mamba) kernel vs its plain version at every shape the
   later phases give it and at the edges of its split (the reference's bound
   2e-4, plus a per-row bound relative to the row's size), with kernel /
   plain / bound times, and at the jamba shape the floor its exponentials set
   on the special-function unit; no single PyTorch call computes the
   selective scan, so it has no library time;
10. jamba-v0.1-52b at full width cut to 16 layers (two periods of 7 mamba +
    1 attention layer, MoE on every second layer), bf16, seeded init:
    prefill step at B=4 x S=2048 (exactly 14 selective-scan and 2 flash
    launches; a second call's logits bit-identical to the first's), prefill
    with the state collected then 8 decode steps from it,
    the launcher's flow (batch 4, prompt 64, 32 greedy tokens), and one
    decode step counted and traced;
11. prefill vs token-by-token decode, jamba full width cut to 8 layers, fp32
    with TF32 off, B=2 x S=100 (no MoE drops at this size): logits and the
    final k / v / h / conv state, the kernel against the model's plain
    one-step update;
12. granite-moe-1b-a400m at full width and depth, bf16, seeded init: prefill
    step at B=4 x S=2048 (exactly one flash launch per layer; a second
    call's logits bit-identical to the first's), the same prefill with the
    kernels called directly and through their autograd functions, in
    turns, the launcher's flow and one decode step traced, then ``python -m
    repro_torch.launch.serve --arch granite-moe-1b-a400m`` as a process;
13. int8 ``qmatmul``: the op on its main path, granite-3-8b's FFN
    up-projection at its B=4 x S=2048 prefill (M=8192, K=4096, N=12800), a
    bf16 activation and weight quantized per row and per column (exactly one
    op call; within the reference's 0.02 of the bf16 product), then the
    kernel vs its plain version, bit-equal (``torch.equal``), at the
    reference's test shapes with random scales, kernel_bench's, ragged
    shapes of both paths (the wgmma / TMA kernel where K % 16 == 0, the
    byte-staged mma.sync kernel otherwise), bf16 output and the main-path
    shape, with kernel / plain / library (``torch._int_mm`` and the
    dequantizing multiply) / bound times, and as context ``torch._int_mm``
    alone on w as given and on a K-major copy of it;
14. the facade (``repro_torch.scope``) on its main path: solve granite-3-8b
    + gemma2-9b at full size (S=2048, weights 1:2) on the cost model's
    ``tpu_v5e(16, (1, 16))`` (a merged co-schedule), deploy at global batch
    4 (re-planned partitioned), then ``serve(n_requests=1000,
    measure=True, device="cuda")``: both models built at full size and depth
    (gemma2-9b's 42 layers), one at a time, their bf16 prefills timed at
    B=1 and B=4 (every attention layer through the flash kernel), and every
    server of the simulated run on its measured service law; the report
    beside the modeled (``measure=False``) one, which must differ;
15. training: (a) the flash backward kernel (``csrc/flash_attention_bwd.cu``),
    on the log-sum-exp and output a training forward keeps, against
    ``attention_bwd_ref`` in fp32 and bf16 (the reference's flash bounds, and
    a per-row bound over rows that are not ~0; two calls bit-identical) at
    granite-3-8b's training shape, gemma2-9b's local and global layers at
    S=8192 (hd 256, window 4096, softcap 50, q scaled so the cap's tanh
    saturates), granite-20b's MQA (48 query heads, one kv head) and the
    softcap with a window at hd 128; (b) its time in bf16 at each beside
    its bound (five products) and SDPA's backward (``library_ms``, timed
    alone after one forward; under a window or a softcap SDPA's causal
    backward is a different function, recorded apart), at the granite shape
    the plain backward's and the forward's serving and training
    instantiations; (c) granite-3-8b at full width cut to 2 layers, bf16: the
    loss and every leaf's gradient through the kernels against plain
    attention (``plain_attention=True``), both against the same weights in
    fp32 (the kernels no further from it than the plain path, within 10 %),
    every wq / wk / wv gradient non-zero; (d) the slice's path: granite-3-8b at full width cut to 16
    layers, bf16, AdamW, B=4 x S=2048, planned by ``plan_for_cell(kind=
    "train")``, 6 steps of ``build_train_step`` through ``ResilientTrainer``
    on the data pipeline's batches: step wall time, tokens/s, MFU, peak
    memory, launches per step, one more step traced (device time by kind:
    flash forward, flash backward, dense products, optimizer, other; the
    backward's three kernels per call: D, dq, dk / dv), every
    loss, grad norm and per-layer gradient finite and non-zero; (e)
    ``tests/test_system.py``'s story at granite-3-8b's smoke config (d_head
    64, bf16): 20 steps, checkpoints every 5, a failure injected at step 12,
    the restarted run's parameters and optimizer state bit-identical to an
    uninterrupted run's (deterministic algorithms on), then greedy decoding;
    (f) ``python -m repro_torch.launch.train --arch granite-moe-1b-a400m``
    as a process, 4 steps at full size;
16. the configs first run on the card: starcoder2-15b (ungated GELU MLP,
    GQA 48 / 4) and granite-20b (MQA 48 / 1) at full size, llama4-maverick
    at full width cut to 2 layers (one dense, one MoE layer of 128 experts,
    top-1), bf16, seeded init: prefill step at B=4 x S=2048 (exactly one
    flash launch per attention layer, nothing else), its wall time and
    device time by kind, one batch-4 decode step counted and traced; then
    each at full width and reduced depth in fp32 with TF32 off, prefill
    against token-by-token decode (phase 4's bound; llama4 at B*S = 200,
    where no dispatch drops a choice);
17. the frontend stubs at full size, bf16: paligemma-3b (256 patch
    embeddings ahead of 1792 tokens) and musicgen-medium (2048 frame
    embeddings, no tokens) as phase 16, their fp32 checks (paligemma: a
    prefill of the patches and the first text tokens, caches collected,
    then decode of the rest against one prefill of it all; musicgen: frames
    = the embedded tokens against token-by-token decode), then ``python -m
    repro_torch.launch.train --arch <it> --batch 4 --seq 2048`` as a
    process, 4 steps at full size each (the backward kernel at hd 256 and
    hd 64): finite losses and grad norms; then the gradient of each on one
    batch in this process: every per-layer gradient non-zero;
18. the WKV-6 backward kernel (``csrc/wkv6_bwd.cu``), on the segment states
    a training forward keeps, against ``wkv6_bwd_ref`` (the forward's bound
    2e-4 on every gradient, and its per-row bound over rows that are not
    ~0; two calls bit-identical) at rwkv6-3b's training shape on the
    reference's decays and on strong ones, at a ragged S with a cotangent
    of S_last, and at an S below 64 on strong decays with one; its time
    (median of 21) and each pass's (traced) beside its bound and the plain
    version's (autograd of ``wkv6_ref``), and at the main shape both
    against the float64 plain version; no single PyTorch call computes it,
    so it has no library time; then rwkv6-3b at full size (32 layers,
    bf16, AdamW, B=4 x S=2048), 5 steps of ``build_train_step`` through
    ``ResilientTrainer``: step wall time, tokens/s, MFU, peak memory,
    launches per step (64 forward and 32 backward WKV-6 calls), one more
    step traced (device time by kind and the backward's kernels); then
    ``python -m repro_torch.launch.train --arch rwkv6-3b`` as a process, 4
    steps at full size, and every per-layer gradient of it non-zero in
    this process, one backward launch per layer;
19. the selective-scan backward kernel (``csrc/mamba_scan_bwd.cu``), on the
    chunk states a training forward keeps, against ``mamba_scan_bwd_ref``
    (the forward's bound 2e-4 on every gradient and its per-row bound over
    rows that are not ~0; two calls bit-identical; with bf16 x the kernel's
    fp32 dx / dB / dC held to the bounds and its bf16 ones equal to them
    rounded; the forward's chunk states bit-equal to its h) at the tests'
    shapes, jamba's training shape in the model layout on the reference's
    test draw and on strong decays, a ragged S with a cotangent of h_last,
    an S below 64, d_inner no multiple of 128 and N = 4 and 8; its time
    (median of 21; each of its two kernels' traced in (c)) beside its bound,
    the exponential floor and the plain version's (``mamba_scan_bwd_ref``),
    the forward with and without its states, and at the main shape both
    against the float64 plain version; no single PyTorch call computes it,
    so it has no library time; then (c) jamba-v0.1-52b at full width cut
    to one period (7 mamba + 1 attention layer) with a dense FFN in place
    of the experts, bf16, AdamW, B=4 x S=2048, 5 steps of
    ``build_train_step`` through ``ResilientTrainer``: step wall time,
    tokens/s, MFU, peak memory, launches per step (14 / 7 scan, 2 / 1
    flash), one more step traced by kind, every per-layer gradient
    non-zero; (d) the same period with its experts (13.3 B parameters), one
    gradient at B=1 x S=2048; (e) ``python -m repro_torch.launch.train
    --arch jamba-v0.1-52b --smoke --device cuda`` as a process, 4 steps;
20. the dry-run (``launch/dryrun.py``) against the card, (a)-(c) in a
    process of their own with expandable segments (``python3 chip_smoke.py
    --phase-20``): (a) the card's name, SMs and memory against the
    dry-run's constants, and the flash backward's split rule in Python
    against the C function at 540 shapes; (b) one call of each kernel
    function at its main-path shape (the forwards with and without what
    training keeps, the backward also at granite-20b's MQA): the
    allocator's rise equal to the meta tracker's peak, byte for byte; (c)
    whole steps, granite-3-8b's B=4 x S=2048 prefill at full size, its
    16-layer training, rwkv6-3b's training and jamba's dense period: the
    predicted peak within 5 % of the measured one, ``kernel_calls`` equal
    to the launches here and in phases 3, 15(d), 18(c) and 19(c), the free
    memory against the dry-run's ``CARD_USABLE_MEMORY``, the reserved peak
    above the prediction by no more than ``RESERVED_MARGIN``; then (c)
    again in a process with the default allocator, its reserved peak held
    to the same margin; beside
    them (d) ``python -m repro_torch.launch.dryrun --all`` (one line a
    cell) and (e) the CLI's ``solve``, ``serve --mix``, ``serve --llm``
    and ``strategies`` and ``examples/serve_batched_torch.py`` and
    ``examples/train_lm_torch.py`` as processes, each exiting 0;
21. the serving steps on (data, model) meshes of ranks: the flash kernel
    with a query offset (a WSP rank's queries at their positions) against
    its plain version in fp32 and bf16 at the ranks' calls below, an
    offset inside gemma2's window included; then granite-3-8b at full
    width cut to 8 layers (B=4 x S=2048, bf16) on (2, 2) and (1, 4) under
    ISP, WSP, the mixed plan and the plan ``plan_for_cell(...,
    model_axis=m)`` chooses, and gemma2-9b at full width cut to 4 layers
    (B=1 x S=8192) on (1, 4) under the mixed plan: 4 ranks, processes
    sharing the card over gloo (``launch/mesh.run_ranks``), each its
    shard; each rank's prefill logits and 8 decode steps against its rows
    and vocab columns of the one-rank run of the same seeded weights on
    the card, its flash launches, its collectives equal to the dry-run's
    count for its coordinates; prefill wall, collective bytes by kind,
    each rank's memory rise beside the dry-run's;
22. the merged pipeline (``runtime/pipeline.py``) on (stage, data) meshes
    of the same 4 ranks sharing the card over gloo (``python3
    chip_smoke.py --phase-22`` runs it alone): (a) ``psum_compressed`` over
    a data axis of 4, a granite-3-8b FFN weight's gradient a rank, each
    rank's mean and residual bit-equal to the reference's formula reckoned
    on the host in numpy; (b) granite-3-8b at full size (40 layers, bf16),
    B=8 x S=2048 as 4 microbatches of 2 rows, pipelined on (4, 1) and (2,
    2): each rank's logits against the one-rank forward of its rows, its
    flash launches, its collectives equal to a count from the shapes, the
    walls beside one rank's forward of the whole batch; (c) SGD steps of
    ``build_pipeline_train_step`` at full width cut to 8 layers (3 steps on
    (4, 1), 1 on (2, 2)): the first step's loss, every gradient and every
    updated parameter against the one-rank plain step, every gradient
    non-zero, flash forward and backward launches, the collectives, each
    rank's peak beside the meta step's prediction, the step walls.

Any failed check raises and the script exits non-zero without a result.  The
last line is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, the line before that a JSON object listing
every ported kernel with its launches on its own main path (flash attention:
the phase-3 granite-3-8b prefill; its backward: the phase-15(d) training
run, calls of three kernels each; WKV-6: the phase-7 rwkv6-3b prefill;
its backward: the phase-18 training run, calls of five kernels each;
selective scan: the phase-10 jamba prefill; its backward: the phase-19(c)
training run, calls of two kernels each; qmatmul: the phase-13 op call)
and its times (each also with its launches on phase 14's facade path;
flash also with one rank's launches in phase 21's WSP prefill and in phase
22's pipelined prefill on (4, 1)), and
the line before that the script's wall time.  Imports nothing of JAX or of
``repro``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
INT8_PEAK_OPS = 1979e12       # H100 SXM dense int8 tensor cores
FP32_PEAK_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3

# (name, B, H, KV, S, hd, causal, window, softcap, dtype)
FA_CASES = [
    ("fa_case0", 2, 4, 2, 256, 64, True, 0, 0.0, "float32"),
    ("fa_case1", 1, 4, 1, 256, 128, True, 0, 50.0, "float32"),
    ("fa_case2", 2, 2, 2, 384, 64, True, 128, 0.0, "float32"),
    ("fa_case3", 1, 8, 4, 512, 64, False, 0, 0.0, "float32"),
    ("fa_case4", 1, 2, 2, 256, 64, True, 0, 0.0, "bfloat16"),
    ("fa_case5", 1, 16, 2, 128, 128, True, 64, 30.0, "float32"),
    ("ragged_s1000", 1, 8, 2, 1000, 128, True, 0, 0.0, "bfloat16"),
    ("granite_prefill", 4, 32, 8, 2048, 128, True, 0, 0.0, "bfloat16"),
    ("phase4_fp32", 2, 32, 8, 100, 128, True, 0, 0.0, "float32"),
    ("gemma2_local", 1, 16, 8, 8192, 256, True, 4096, 50.0, "bfloat16"),
    ("gemma2_global", 1, 16, 8, 8192, 256, True, 0, 50.0, "bfloat16"),
    ("granite_moe_prefill", 4, 16, 8, 2048, 64, True, 0, 0.0, "bfloat16"),
    # phase 14 times granite-3-8b and gemma2-9b (local and global layers)
    # prefills at B=1 and B=4 x S=2048
    ("granite_prefill_b1", 1, 32, 8, 2048, 128, True, 0, 0.0, "bfloat16"),
    ("gemma2_prefill_local", 4, 16, 8, 2048, 256, True, 4096, 50.0, "bfloat16"),
    ("gemma2_prefill_global", 4, 16, 8, 2048, 256, True, 0, 50.0, "bfloat16"),
    ("gemma2_prefill_b1_local", 1, 16, 8, 2048, 256, True, 4096, 50.0, "bfloat16"),
    ("gemma2_prefill_b1_global", 1, 16, 8, 2048, 256, True, 0, 50.0, "bfloat16"),
    # phases 16-17: the head layouts of the configs first run on the card, at
    # their B=4 x S=2048 bf16 prefills and their fp32 checks' shapes
    ("starcoder2_prefill", 4, 48, 4, 2048, 128, True, 0, 0.0, "bfloat16"),
    ("granite20b_prefill", 4, 48, 1, 2048, 128, True, 0, 0.0, "bfloat16"),
    ("llama4_prefill", 4, 40, 8, 2048, 128, True, 0, 0.0, "bfloat16"),
    ("paligemma_prefill", 4, 8, 1, 2048, 256, True, 0, 0.0, "bfloat16"),
    ("musicgen_prefill", 4, 24, 24, 2048, 64, True, 0, 0.0, "bfloat16"),
    ("starcoder2_fp32", 2, 48, 4, 100, 128, True, 0, 0.0, "float32"),
    ("granite20b_fp32", 2, 48, 1, 100, 128, True, 0, 0.0, "float32"),
    ("llama4_fp32", 2, 40, 8, 100, 128, True, 0, 0.0, "float32"),
    ("paligemma_fp32", 2, 8, 1, 288, 256, True, 0, 0.0, "float32"),
    ("musicgen_fp32", 2, 24, 24, 100, 64, True, 0, 0.0, "float32"),
]
# Per-row bound on max|kernel - plain| / rms(plain row).  The absolute 2e-2
# is about half a typical output in rows that see thousands of keys (their
# outputs are ~1/sqrt(keys)); rounding alone leaves ~1e-2 here, while a
# dropped or doubled 32-key tile in such a row leaves ~0.3.
ROW_REL_TOL = 0.1
MAIN_PATH_CASE = "granite_prefill"

# (name, B, H, S, hd, strong): tests/test_kernels.py WKV_CASES, the rwkv6-3b
# prefill shape (phase 7) and the ragged phase-8 shape on the reference's
# decays; then the prefill shape and a small ragged one on strong decays
# (``wkv_inputs``), which overflow the chunk form's exp without its guard.
WKV_CASES = [
    ("wkv_case0", 2, 2, 64, 16, False),
    ("wkv_case1", 1, 4, 128, 64, False),
    ("wkv_case2", 2, 1, 96, 32, False),
    ("wkv_case3", 1, 2, 256, 64, False),
    ("rwkv_prefill", 4, 40, 2048, 64, False),
    ("phase8_ragged", 2, 40, 100, 64, False),
    ("rwkv_prefill_strong", 4, 40, 2048, 64, True),
    ("ragged_strong", 2, 3, 100, 64, True),
]
WKV_TOL = 2e-4             # the reference's bound (tests/test_kernels.py)
# Per-row bound on max|kernel - plain| / rms(plain row): fp32 rounding in
# another summation order leaves up to ~4e-4 of a row's size in rows whose
# sums cancel (the fp32 plain version is as far from a float64 run), ~1e-6
# elsewhere; a dropped or doubled chunk, or a wrong decay, moves a row by O(1).
WKV_ROW_REL_TOL = 1e-3
WKV_MAIN_PATH_CASE = "rwkv_prefill"
# (name, B, S, di, N, dtype, model layout): tests/test_kernels.py MAMBA_CASES,
# the jamba prefill shape (phase 10) and the phase-11 shape; then the edges of
# the kernel's split (one token, S just past a 32-token chunk, d_inner no
# multiple of the 128-channel block, several chunks with a ragged tail, and
# d_inner no multiple of 8, whose bf16 rows take plain loads in place of
# cp.async).  In the model layout x is as given and B / C are column slices of
# one [B, S, R + 2N] tensor (R = 256, jamba's dt rank), as the model passes
# them.
MAMBA_CASES = [
    ("mamba_case0", 2, 64, 128, 8, "float32", False),
    ("mamba_case1", 1, 128, 256, 16, "float32", False),
    ("mamba_case2", 1, 96, 64, 4, "float32", False),
    ("jamba_prefill", 4, 2048, 8192, 16, "bfloat16", True),
    ("phase11_fp32", 2, 100, 8192, 16, "float32", True),
    ("one_token", 4, 1, 8192, 16, "bfloat16", True),
    ("past_one_chunk", 2, 33, 8192, 16, "bfloat16", True),
    ("ragged_block", 2, 100, 200, 16, "float32", True),
    ("chunks_ragged_tail", 2, 1000, 1000, 16, "bfloat16", True),
    ("unaligned_rows", 1, 70, 130, 8, "bfloat16", True),
]
SFU_EXP2_PER_CLOCK = 16    # exponentials per clock per SM (special-function unit)
MAMBA_TOL = 2e-4           # the reference's bound (tests/test_kernels.py)
# Per-row bound on max|kernel - plain| / rms(plain row): the two differ only
# in fp32 rounding (expf, fused multiply-adds, the order of the N-term sum);
# a dropped, repeated or misplaced token moves a row by O(1).
MAMBA_ROW_REL_TOL = 1e-3
MAMBA_MAIN_PATH_CASE = "jamba_prefill"
# (name, M, N, K, out dtype): tests/test_kernels.py's qmatmul shapes,
# benchmarks/kernel_bench.py's 256 x 512 x 256 (2 output tiles: fewer than
# SMs), ragged shapes of the byte-staged mma.sync path (K % 16 nonzero),
# ragged tiles of the wgmma / TMA path (M no multiple of 128, N of 256, K of
# 128; one row; fewer tiles than SMs), bf16 output, and the main path's.
QMM_CASES = [
    ("qmm_case0", 128, 128, 128, "float32"),
    ("qmm_case1", 256, 128, 384, "float32"),
    ("qmm_case2", 128, 256, 256, "float32"),
    ("kernel_bench", 256, 256, 512, "float32"),
    ("ragged_small", 1, 40, 100, "float32"),
    ("ragged_large", 8193, 12801, 4100, "float32"),
    ("tma_ragged", 8193, 12808, 4112, "float32"),
    ("tma_few_tiles", 200, 300, 272, "float32"),
    ("bf16_out", 300, 200, 160, "bfloat16"),
    ("bf16_out_ragged", 1, 40, 100, "bfloat16"),
    ("bf16_out_one_row", 1, 4096, 4096, "bfloat16"),
]
QMM_MAIN = (8192, 12800, 4096)    # granite-3-8b FFN up-projection, B=4 x S=2048
QMM_CLOSE_TOL = 0.02              # the reference's bound (test_qmatmul_quantized_close_to_fp)
KERNEL_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "wkv6.cu", "wkv6_bwd.cu",
                  "mamba_scan.cu", "mamba_scan_bwd.cu", "qmatmul.cu")
# Phase 14: the facade's problem, the llm pair of BENCH_serving.json on the
# runtime bridge's default package tpu_v5e(16, (1, 16)), and what the solve
# and deploy(global_batch=4) must give for it (tests/test_torch_api.py pins
# the same on the CPU): per model (p1, p2, transition_repeat, quota_chips,
# co_mode).
FACADE_MODELS = ("granite-3-8b", "gemma2-9b")
FACADE_WEIGHTS = (1.0, 2.0)
FACADE_SEQ = 2048
FACADE_EXPECTED = {"strategy": "coschedule", "mode": "merged", "plans": {
    "granite-3-8b": ("WSP", "WSP", None, 4, "partitioned"),
    "gemma2-9b": ("WSP", "WSP", None, 12, "partitioned")}}
FACADE_BATCHES = (1, 4)           # measure_service_models' two-point fit
FACADE_ITERS = 3
# granite-3-8b's measured b=4 prefill against phase 3's median at the same
# B=4 x S=2048 shape: the two time the same model, so only the host's spread
# separates them (phase 3's runs moved 2-3 % between calls)
FACADE_PREFILL_TOL = 0.25
# Phase 15: the flash backward kernel against attention_bwd_ref at (name, B,
# H, KV, S, hd, causal, window, softcap), each in fp32 and bf16: granite-3-8b's
# training shape, gemma2-9b's local and global layers at an S its 4096 window
# bites, granite-20b's MQA (48 query heads on one kv head), and gemma2's
# softcap and a window at hd 128 (the wgmma kernels' softcap path); times of
# each in bf16.  Then granite-3-8b trains at full width cut to TRAIN_LAYERS
# layers.
FA_BWD_CASES = [
    ("granite_train", 4, 32, 8, 2048, 128, True, 0, 0.0),
    ("gemma2_local", 1, 16, 8, 8192, 256, True, 4096, 50.0),
    ("gemma2_global", 1, 16, 8, 8192, 256, True, 0, 50.0),
    ("granite20b_mqa", 1, 48, 1, 2048, 128, True, 0, 0.0),
    ("softcap_hd128", 1, 16, 8, 2048, 128, True, 1024, 50.0),
]
FA_BWD_MAIN = ("granite_train", "bfloat16")
# Per-row bound of the backward, over rows whose rms reaches FA_BWD_ROW_FLOOR
# of the tensor's.  fp32: where one key holds nearly all of a row's softmax
# (the softcap cases' scaled q), dP - D cancels and the fp32 plain version
# itself is ~2e-3 off an fp64 one in such rows; a dropped softcap chain
# factor leaves errors of several times the rms.  bf16: as ROW_REL_TOL.
FA_BWD_ROW_REL_TOL = {"float32": 1e-2, "bfloat16": ROW_REL_TOL}
FA_BWD_ROW_FLOOR = 1e-3
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 4, 2048, 6
# Phases 16-17: the configs first run on the card, (arch, layers run; None =
# full depth).  llama4 at 48 layers is ~735 GiB of bf16 weights; its first two
# are one dense layer and one MoE layer of 128 experts (34.3 GiB).
A16_ARCHS = (("starcoder2-15b", None), ("granite-20b", None), ("llama4-maverick-400b-a17b", 2))
FRONTEND_ARCHS = ("paligemma-3b", "musicgen-medium")
PREFILL_B, PREFILL_S = 4, 2048
# The fp32 prefill-vs-decode checks (TF32 off): layers (llama4 keeps its 2),
# B x S (llama4's B*S <= 512 leaves one token a dispatch group: nothing is
# dropped on either path), paligemma's text tokens in its prefix prefill and
# then decoded, after its 256 patches.
FP32_LAYERS, FP32_B, FP32_S, VISION_TEXT = 4, 2, 100, (16, 16)
LAUNCHER_STEPS = 4
# Phase 18: the WKV-6 backward kernel against wkv6_bwd_ref, (name, B, H, S,
# hd, strong decays, a cotangent of S_last): rwkv6-3b's training shape on
# both decay ranges, then a ragged S over two segments with dS_last, and an
# S below 64 (one ragged chunk ring, one segment) on strong decays with
# dS_last.  Then rwkv6-3b trains at full size (32 layers, AdamW) on the card.
WKV_BWD_CASES = [
    ("rwkv_train", 4, 40, 2048, 64, False, False),
    ("rwkv_train_strong", 4, 40, 2048, 64, True, False),
    ("ragged_ds_last", 2, 40, 300, 64, False, True),
    ("short_strong_ds_last", 2, 40, 40, 64, True, True),
]
WKV_BWD_MAIN = "rwkv_train"
RWKV_TRAIN_STEPS = 5
# Phase 19: the selective-scan backward kernel against mamba_scan_bwd_ref,
# (name, B, S, di, N, dtype, model layout, strong decays, a cotangent of
# h_last): tests/test_kernels.py MAMBA_CASES, jamba's training shape in the
# model layout (bf16 x, B / C column slices of one [B, S, R + 2N] tensor) on
# the reference's test draw and on strong decays, a ragged S with dh_last,
# an S below one 64-token chunk on strong decays with dh_last, d_inner no
# multiple of the 128-channel block, and N = 4 and 8.  Then jamba trains at
# full width cut to one period with a dense FFN (JAMBA_TRAIN), and one
# period with its experts takes one gradient.
MAMBA_BWD_CASES = [
    ("mamba_case0", 2, 64, 128, 8, "float32", False, False, False),
    ("mamba_case1", 1, 128, 256, 16, "float32", False, False, False),
    ("mamba_case2", 1, 96, 64, 4, "float32", False, False, False),
    ("jamba_train", 4, 2048, 8192, 16, "bfloat16", True, False, False),
    ("jamba_train_strong", 4, 2048, 8192, 16, "bfloat16", True, True, False),
    ("ragged_dh_last", 2, 1000, 8192, 16, "bfloat16", True, False, True),
    ("short_strong_dh_last", 2, 40, 8192, 16, "bfloat16", True, True, True),
    ("ragged_block", 2, 100, 200, 16, "float32", True, False, True),
    ("state_4", 2, 300, 256, 4, "float32", True, False, True),
    ("state_8", 2, 300, 384, 8, "bfloat16", True, False, False),
]
MAMBA_BWD_MAIN = "jamba_train"
MAMBA_BWD_NAMES = ("ddt", "dx", "dA", "dB", "dC", "dD")
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_STEPS = 8, 5
# Phase 20: the dry-run on the meta device held to the card.  (b) one call of
# each kernel function at its main-path shape (PERF.md's table), the forwards
# with and without what training keeps, and the backward at granite-20b's MQA,
# whose split allocates fp32 partial sums: (name, kernel, args) built by
# ``p20_kernel_calls``.  (c) whole steps, (name, arch, layers or None for all,
# kind, B, S): a full prefill and the training runs of phases 15(d), 18(c) and
# 19(c) (jamba: one period, a dense FFN).  The predicted peak within
# P20_PEAK_TOL of the measured one.
P20_CELLS = [
    ("granite_prefill", "granite-3-8b", None, "prefill", 4, 2048),
    ("granite_train", "granite-3-8b", TRAIN_LAYERS, "train", TRAIN_BATCH, TRAIN_SEQ),
    ("rwkv_train", "rwkv6-3b", None, "train", PREFILL_B, PREFILL_S),
    ("jamba_period_dense", "jamba-v0.1-52b", JAMBA_TRAIN_LAYERS, "train", PREFILL_B, PREFILL_S),
]
P20_PEAK_TOL = 0.05
# (d) and (e): processes started beside (a)-(c).  The front doors (the CLI's
# four commands, the two model examples with few steps) and the dry-run of
# every registry cell.
P20_COMMANDS = [
    ("cli solve", ["-m", "repro_torch", "solve", "--mix", "alexnet", "--hw", "mcm16", "--json"]),
    ("cli serve --mix", ["-m", "repro_torch", "serve", "--mix", "alexnet:1,resnet18:1",
                         "--hw", "mcm16", "--requests", "200"]),
    ("cli serve --llm", ["-m", "repro_torch", "serve", "--llm", "granite-3-8b:1,gemma2-9b:1",
                         "--llm-smoke", "--hw", "mcm16", "--requests", "100"]),
    ("cli strategies", ["-m", "repro_torch", "strategies"]),
]
# the two that use the card start once (a)-(c) has read the card's free memory
P20_EXAMPLES = [
    ("serve_batched_torch.py", ["examples/serve_batched_torch.py"]),
    ("train_lm_torch.py", ["examples/train_lm_torch.py", "--steps", "40"]),
]
P20_DRYRUN = ["-m", "repro_torch.launch.dryrun", "--all"]
# Phase 21: the serving steps on a (data, model) mesh of ranks, 4 processes
# that share the one card and meet over gloo (one start for every cell: the
# (2, 2) mesh is built over the same 4 processes).  (arch, layers, B, S,
# mesh shape, plans): each plan by name ("dse" is the one plan_for_cell(...,
# model_axis=m) chooses, run unless it is one of the others).  Granite's
# mixed plan turns at repeat 2 of 4; gemma2 at 4 layers (2 repeats of local
# + global, so that a transition exists) at S=8192, so that a WSP rank's
# window reaches into another rank's positions.  Depth is cut to keep the
# phase near 90 s: every layer's collectives cross the host.
P21_AXES = ("data", "model")
P21_WORLD = (1, 4)
P21_CELLS = [
    ("granite-3-8b", 4, 4, 2048, (2, 2), ("ISP", "WSP", "mixed", "dse")),
    ("granite-3-8b", 4, 4, 2048, (1, 4), ("ISP", "WSP", "mixed", "dse")),
    ("gemma2-9b", 4, 1, 8192, (1, 4), ("mixed",)),
]
P21_STEPS = 8
# Mesh logits against the one-rank logits of the same bf16 weights, both on
# the card: max abs difference within the flash kernel's bf16 bound times the
# largest one-rank logit.  The two differ only in the order of bf16 sums (the
# row-parallel partials added in fp32, other product shapes); a wrong mask,
# position, shard or cache entry moves logits by O(1) of that scale.
P21_LOGIT_TOL = 2e-2
# The flash kernel with a query offset against its plain version, in fp32 and
# bf16 (2e-3 / 2e-2, and phase 2's per-row bound): (name, B, H, KV, Sq, Skv,
# q_offset, hd, window, softcap).  The WSP ranks' calls of the cells above
# (the last rank's, and a middle one), gemma2's local layer at an offset
# inside its 4096 window and its global layer, and a ragged small case.
P21_FA_CASES = [
    ("granite_2x2_rank1", 2, 32, 8, 1024, 2048, 1024, 128, 0, 0.0),
    ("granite_1x4_rank3", 4, 32, 8, 512, 2048, 1536, 128, 0, 0.0),
    ("granite_1x4_rank1", 4, 32, 8, 512, 1024, 512, 128, 0, 0.0),
    ("gemma2_local_rank3", 1, 16, 8, 2048, 8192, 6144, 256, 4096, 50.0),
    ("gemma2_global_rank2", 1, 16, 8, 2048, 6144, 4096, 256, 0, 50.0),
    ("ragged_window", 1, 4, 2, 100, 137, 37, 64, 64, 0.0),
]
# Phase 22: the merged pipeline (runtime/pipeline.py), the 4 ranks of phase
# 21 sharing the card over gloo.  (a) psum_compressed over a data axis of 4,
# one granite-3-8b FFN weight's gradient a rank (bf16, rank i's drawn at
# scale 0.01 (i + 1), so the ranks' int8 scales differ).  (b) granite-3-8b
# at full size, B=8 x S=2048 as n_micro = 4 microbatches of 2 rows, on each
# (stage, data) mesh; each rank's logits against the one-rank forward of its
# rows within P21_LOGIT_TOL.  (c) SGD steps at full width, depth cut by the
# meta sizing (p22_meta_peak): at 8 layers the 4 ranks' steps hold 48.1 GiB
# together and one rank's plain step, taken while the others hold only their
# stages, 39.5 GiB; at 12 layers 62.7-66.5 and 54.0, too close to the card's
# 78 GiB with 4 CUDA contexts and gloo's fp32 copies on top.  On each mesh:
# (shape, steps).
P22_AXES = ("stage", "data")
P22_WORLD = (4, 1)
P22_ARCH = "granite-3-8b"
P22_N_MICRO, P22_MB, P22_S = 4, 2, 2048
P22_FWD_MESHES = ((4, 1), (2, 2))
P22_TRAIN_LAYERS = 8
P22_TRAIN = (((4, 1), 3), ((2, 2), 1))
P22_LR = 5e-2                             # the reference's test step
P22_PSUM_SHAPE = (4096, 12800)            # granite-3-8b's w1 [d, d_ff]
# (c) the first pipelined step against the one-rank step (loss_fn, autograd,
# the same SGD update) of the same bf16 weights and batch.  The two sum the
# same products in another order: the one-rank step's products span all 8
# rows, the pipeline's one microbatch at a time, accumulated into .grad in
# bf16 and summed over data in fp32.  So each gradient leaf within
# P22_GRAD_TOL of its largest element (phase 21's logit bound: bf16 sums in
# another order); the loss within one bf16 rounding (2^-8) of its value, as
# the logits it averages carry one; each updated parameter within one bf16
# ulp of its value (2^-7 |p|: the rounding of p - lr g may fall on the other
# side) plus lr times the gradient bound.  A gradient counted once a stage,
# or missing a stage's part, moves a leaf by O(1) of its scale.
P22_GRAD_TOL = 2e-2
P22_LOSS_RTOL = 2 ** -8


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls between two events,
    after one warm-up call (which also builds a kernel at first use)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(fn, reps: int) -> float:
    """Median over ``reps`` launches, each between its own two events."""
    import torch

    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


_TEMPLATE_ARG = r"L([ib])(\d+)E|(f)|13(__nv_bfloat16)"   # int / bool literal, float, bf16


def _template_args(tail: str) -> str:
    args = []
    for kind, v, f, bf16 in re.findall(_TEMPLATE_ARG, tail):
        if kind:
            args.append(("true" if v == "1" else "false") if kind == "b" else v)
        else:
            args.append("float" if f else bf16)
    return "<" + ", ".join(args) + ">"


def kernel_name(mangled: str) -> str:
    """``fa_fwd_bf16<128>`` or ``qmatmul_tma<float>`` from a mangled kernel
    symbol of the port: the last of its length-prefixed names (after any
    namespace, whose generated name may hold digits) followed by template
    arguments (``I...E``)."""
    m = re.match(r"_ZN?", mangled)
    pos, name = (m.end(), None) if m else (0, None)
    while m and pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        pos += len(digits)
        name, pos = mangled[pos:pos + int(digits)], pos + int(digits)
    if name and re.fullmatch(r"[A-Za-z_]\w*", name):
        tail = re.match(rf"I((?:{_TEMPLATE_ARG})+)E", mangled[pos:])
        return name + (_template_args(tail.group(1)) if tail else "")
    return mangled          # not walked: the SASS and ptxas checks then fail by name


def ptxas_report(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, spill line) for each kernel in a ptxas -v log."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = kernel_name(line.split("'")[1]), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            rows.append((name, line.split("info    :")[-1].strip(), spill))
            name = None
    return rows


# bf16 / int8 wgmma, TMA load / store, mma.sync, then the fp64 FMA, multiply and add
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "HMMA", "DFMA", "DMUL", "DADD")


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Instructions of ``SASS_OPS`` in each kernel of a built library, from
    ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                counts[name][op] += op in line
    return counts


def row_rel_err(out, ref, floor: float = 0.0) -> float:
    """max over rows of max|out - ref| / rms(ref) within the row, in fp32
    (fp64 where either is fp64), over the rows whose rms reaches ``floor``
    times the whole tensor's rms (a gradient row that is 0 up to rounding
    has no scale to be relative to; the absolute bound holds it)."""
    import torch

    dt = torch.promote_types(torch.promote_types(out.dtype, ref.dtype), torch.float32)
    d = (out.to(dt) - ref.to(dt)).abs().amax(dim=-1)
    rms = ref.to(dt).pow(2).mean(dim=-1).sqrt()
    if floor > 0:
        keep = rms >= floor * ref.to(dt).pow(2).mean().sqrt()
        d, rms = d[keep], rms[keep]
        if d.numel() == 0:
            return 0.0
    return (d / rms.clamp_min(1e-30)).max().item()


def fa_bwd_inputs(dev, B, H, KV, S, hd, cap, dtype, seed=0):
    """q, k, v as the model passes them (transposed [B, S, n, hd] views) and
    a contiguous dO, normal; under a softcap q is scaled by cap / 3, so the
    logits' std is a third of the cap and the chain factor 1 - tanh^2 is
    below 0.79 in about a tenth of the pairs (with unit q it stays within
    4e-4 of 1, and a kernel that dropped it would pass)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev) for n in (H, KV, KV))
    if cap > 0:
        q = q * (cap / 3)
    do = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    return (*(t.to(dtype).transpose(1, 2) for t in (q, k, v)), do)


def fa_bwd_errors(got, want, dtype) -> tuple[dict, list[str]]:
    """The backward's (dq, dk, dv) against attention_bwd_ref: readings, and
    the bounds they miss.  Each gradient is held elementwise to the
    reference's flash bound (2e-3 fp32, 2e-2 bf16, relative and absolute)
    and per row to FA_BWD_ROW_REL_TOL of the row's rms, over the rows whose
    rms reaches FA_BWD_ROW_FLOOR of the tensor's."""
    import torch

    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    row_tol = FA_BWD_ROW_REL_TOL[str(dtype).removeprefix("torch.")]
    res, missed = {"tol": tol, "row_tol": row_tol}, []
    for gname, a, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        err = (a.float() - w.float()).abs().max().item()
        rel = row_rel_err(a, w, floor=FA_BWD_ROW_FLOOR)
        if not bool(torch.isfinite(a).all()):
            missed.append(f"{gname}: non-finite")
        if not torch.allclose(a.float(), w.float(), rtol=tol, atol=tol):
            missed.append(f"{gname}: max abs err {err} (tol {tol})")
        if not rel <= row_tol:
            missed.append(f"{gname}: per-row error {rel} / rms (tol {row_tol})")
        res[f"{gname}_max_abs_err"] = err
        res[f"{gname}_row_rel_err"] = rel
    res["max_abs_err"] = max(res[f"{x}_max_abs_err"] for x in ("dq", "dk", "dv"))
    return res, missed


STRONG_W_MIN = 1e-3        # strong decays: w log-uniform in [1e-3, 0.999] ...
STRONG_PINNED_LOGW = -50.0  # ... and every 16th channel at this log w


def wkv_inputs(dev, B, H, S, hd, seed=0, strong=False):
    """The reference's test distribution: r, k, v normal, decay uniform in
    (0.7, 0.999) as log w, u * 0.3.  ``strong``: decay log-uniform in
    [1e-3, 0.999] instead, with channels 3, 19, ... pinned at log w = -50,
    decays whose 32-token sums overflow ``exp`` in fp32."""
    import math

    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device=dev) for _ in range(3))
    u_draw = torch.rand(B, H, S, hd, generator=g, device=dev)
    if strong:
        lo, hi = math.log(STRONG_W_MIN), math.log(0.999)
        logw = lo + (hi - lo) * u_draw
        logw[..., 3::16] = STRONG_PINNED_LOGW
    else:
        logw = torch.log(0.7 + 0.299 * u_draw)
    u = 0.3 * torch.randn(H, hd, generator=g, device=dev)
    return r, k, v, logw, u


def mamba_inputs(dev, B, S, di, N, dtype, model_layout, seed=0, strong=False):
    """The reference's test distribution: dt = softplus(normal), x, B, C
    normal, A = -exp(0.5 normal), D = 1; x, B and C in ``dtype``.
    ``strong``: dt log-uniform in [1e-2, 8] and A = -(1 .. N) on every
    channel (the models' init) instead, so that exp(dt A) underflows to 0 on
    some state-tokens."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if strong:
        lo, hi = math.log(1e-2), math.log(8.0)
        dt = torch.exp(lo + (hi - lo) * torch.rand(B, S, di, generator=g, device=dev))
    else:
        dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g, device=dev))
    x = torch.randn(B, S, di, generator=g, device=dev).to(dtype)
    A = -torch.exp(0.5 * torch.randn(di, N, generator=g, device=dev))
    if strong:
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    if model_layout:
        dbc = torch.randn(B, S, 256 + 2 * N, generator=g, device=dev).to(dtype)
        _, Bc, Cc = dbc.split([256, N, N], dim=-1)
    else:
        Bc, Cc = (torch.randn(B, S, N, generator=g, device=dev).to(dtype) for _ in range(2))
    return dt, x, A, Bc, Cc, torch.ones(di, device=dev)


def decode_step_profile(cfg, model, dev, sync) -> str:
    """One decode step of the launcher's flow (batch 4, position 64 of a
    96-position cache) counted and traced: the operations the eager step
    dispatches (views included), its wall time unprofiled (median of 9), and
    the device's busy time under the profiler (sum of kernel durations)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import init_kv_cache
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step

    plan = plan_for_cell(cfg, 96, 4, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=4, max_len=96, device=dev)
    caches = init_kv_cache(cfg, 4, 96, torch.bfloat16, dev)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), 64, dtype=torch.int64, device=dev)
    n_layers = cfg.n_layers

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    for _ in range(3):
        dstep(model, tok, pos, caches)
    sync()
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        dstep(model, tok, pos, caches)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    ops = OpCount()
    with ops:
        dstep(model, tok, pos, caches)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dstep(model, tok, pos, caches)
        sync()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = (f"{len(kern)} device kernels busy "
            f"{sum(e.time_range.elapsed_us() for e in kern) / 1e3:.3f} ms"
            if kern else "device busy time not measured (the profiler saw no kernels)")
    return (f"{statistics.median(times):.3f} ms wall (median of 9, "
            f"{min(times):.3f}-{max(times):.3f}), {ops.n} operations dispatched "
            f"({ops.n / n_layers:.1f} per layer), {busy}")


def prefill_breakdown(prefill, model, tokens, kernel_tags: tuple[str, ...], sync,
                      top: int = 8) -> str:
    """One prefill step under the profiler: device time summed over each
    hand-written kernel (its symbol contains one of ``kernel_tags``), the
    dense products (cuBLAS / CUTLASS symbols) and everything else
    (elementwise passes, reductions, copies); then the ``top`` PyTorch
    operators by the device time of the kernels they launched themselves."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prefill(model, tokens)
        sync()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return "device time by kind not measured (the profiler saw no kernels)"
    groups = {tag: [0, 0.0] for tag in kernel_tags}
    groups.update({"dense products": [0, 0.0], "other": [0, 0.0]})
    for e in kern:
        name = e.name.lower()
        kind = next((tag for tag in kernel_tags if tag in name), None) or (
            "dense products" if any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma"))
            else "other")
        groups[kind][0] += 1
        groups[kind][1] += e.time_range.elapsed_us() / 1e3
    total = sum(ms for _, ms in groups.values())
    ops = sorted(((a.key, a.count, a.self_device_time_total / 1e3) for a in prof.key_averages()
                  if a.key.startswith("aten::") and a.self_device_time_total > 0),
                 key=lambda r: -r[2])
    return (f"{len(kern)} device kernels busy {total:.3f} ms: " + ", ".join(
        f"{kind} {ms:.3f} ms ({n} kernels)" for kind, (n, ms) in groups.items())
        + "; top aten operators by device time: "
        + ", ".join(f"{key} {ms:.3f} ms ({n} calls)" for key, n, ms in ops[:top]))


def timed_prefills(prefill, model, tokens, sync) -> list[float]:
    """Wall times (ms) of three prefill steps, each ending in a synchronise."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(model, tokens)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def autograd_overhead(prefill, model, tokens, sync) -> dict[str, float]:
    """The serving prefill with the autograd functions on its path (the
    flash call, the MoE experts' fp32 products; their backward is a kernel
    or a hand-written rule) as they are, and with the kernels called
    directly, in turns (direct, function, function, direct), each turn one
    untimed call then ``timed_prefills``: the median ms of each over its
    turns."""
    import torch

    import repro_torch.models.attention as attention
    import repro_torch.models.moe as moe
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel

    def direct_products(xe, w):
        return torch.bmm(xe, w, out_dtype=torch.float32)

    def direct_flash(q, k, v, causal=True, window=0, softcap=0.0):
        return flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=softcap)

    as_is = (moe._products_fp32, attention.flash_attention)
    variants = {"direct": (direct_products, direct_flash), "autograd_function": as_is}
    times = {name: [] for name in variants}
    try:
        for turn in range(4):
            for name in (variants if turn % 2 == 0 else reversed(variants)):
                moe._products_fp32, attention.flash_attention = variants[name]
                prefill(model, tokens)
                sync()
                times[name] += timed_prefills(prefill, model, tokens, sync)
    finally:
        moe._products_fp32, attention.flash_attention = as_is
    return {f"{name}_ms": statistics.median(t) for name, t in times.items()}


def check_reproducible(prefill, model, tokens, first, name: str) -> None:
    """Fails unless one more prefill of ``tokens`` gives logits bit-identical
    to ``first``, an earlier call's logits at every 64th position."""
    again = prefill(model, tokens)[:, ::64]
    check(again.equal(first), f"two {name} prefills of the same tokens differ: "
          f"max |diff| {(again.float() - first.float()).abs().max().item()}")


def decode_from_prefill(cfg, model, prompt, steps: int, dev, sync):
    """Prefill ``prompt`` with the state collected, move that state into
    full-length caches (k / v into the first positions; recurrent states as
    they are), then ``steps`` greedy decode steps; checks every logit is
    finite and returns the tokens [B, steps]."""
    import torch
    from repro_torch.models import init_kv_cache
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step, greedy_generate

    B, P = prompt.shape
    with torch.inference_mode():
        logits, pre_caches = model(prompt.to(dev), collect_cache=True)
    check(bool(torch.isfinite(logits).all()), f"non-finite {cfg.name} prefill logits")
    last = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits
    plan = plan_for_cell(cfg, P + steps, B, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=B, max_len=P + steps, device=dev)
    caches = init_kv_cache(cfg, B, P + steps, torch.bfloat16, dev)
    with torch.inference_mode():
        for full, pre in zip(caches, pre_caches):
            check(set(full) == set(pre), f"state keys {set(full)} vs {set(pre)}")
            for n in full:
                if n in ("k", "v"):
                    full[n][:, :, :P] = pre[n]
                else:
                    full[n].copy_(pre[n])
    del pre_caches
    captured = []

    def logged_step(m, tok, pos, c):
        lg, c = dstep(m, tok, pos, c)
        captured.append(lg)
        return lg, c

    out, caches = greedy_generate(cfg, model, logged_step, caches, last, P, steps)
    sync()
    check(tuple(out.shape) == (B, steps), f"{cfg.name} generated {tuple(out.shape)}")
    check(all(bool(torch.isfinite(lg).all()) for lg in captured), "non-finite decode logits")
    check(all(bool(torch.isfinite(t).all()) for c in caches for t in c.values()),
          "non-finite decode state")
    return out


def decode_token_by_token(cfg, model, tokens, dev):
    """Feed ``tokens`` [B, S] one at a time through the decode step from zero
    fp32 caches of S positions; returns (logits [B, S, vocab], caches)."""
    import torch
    from repro_torch.models import init_kv_cache
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step

    B, S = tokens.shape
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="decode")
    dstep = build_decode_step(cfg, plan, batch=B, max_len=S, device=dev)
    caches = init_kv_cache(cfg, B, S, torch.float32, dev)
    logits = []
    for t in range(S):
        lg, caches = dstep(model, tokens[:, t:t + 1], torch.full((B,), t), caches)
        logits.append(lg)
    return torch.cat(logits, dim=1), caches


def launcher_flow(serve, cfg, model, card: str) -> None:
    """The launcher's flow: batch 4, prompt 64 ingested through the decode
    step, 32 greedy tokens; prints its times and peak memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, model, batch=4, prompt_len=64, tokens=32, cache_dtype=torch.bfloat16)
    out = res["tokens"]
    check(tuple(out.shape) == (4, 32), f"generated {tuple(out.shape)}")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab, "token out of range")
    print(f"  launcher flow (batch 4, prompt 64, 32 tokens): prompt ingest "
          f"{1e3 * res['prompt_s']:.3f} ms, decode {res['decode_tok_s']:.1f} tok/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")


def _report_line(rep) -> str:
    per = "; ".join(
        f"{m}: completed {pm.completed_requests}/{pm.arrived_requests}, p50 "
        f"{pm.latency_p50_s:.6f} p95 {pm.latency_p95_s:.6f} p99 {pm.latency_p99_s:.6f} s, "
        f"utilization {pm.utilization:.4f}, SLO attainment {pm.slo_attainment}"
        for m, pm in rep.per_model.items())
    return (f"goodput {rep.goodput:.4f}/s, throughput {rep.throughput:.4f}/s, p95 "
            f"{rep.latency_p95_s:.6f} s, utilization {rep.utilization:.4f}, makespan "
            f"{rep.makespan_s:.4f} s, arrived {rep.total_arrived}, conserved {rep.conserved}; "
            + per)


def facade_phase(get_config, card: str, granite_prefill_ms: float, reset_launches,
                 kernels, device: str = "cuda") -> dict[str, int]:
    """Phase 14: solve -> deploy -> measured serving through the port's
    facade.  Returns each kernel's launches on this path."""
    import torch

    from repro_torch import scope
    from repro_torch.core.hw import tpu_v5e
    from repro_torch.serving import service_from_assignment

    cfgs = [get_config(name) for name in FACADE_MODELS]
    print(f"phase 14: the facade, {' + '.join(FACADE_MODELS)} at full size and depth "
          f"({' + '.join(str(c.n_layers) for c in cfgs)} layers), S={FACADE_SEQ}, "
          f"weights {FACADE_WEIGHTS}, bf16")
    held = torch.cuda.memory_allocated() if device == "cuda" else 0
    print(f"  {held / 2**30:.3f} GiB allocated before the phase")
    check(held < 2 * 2**30, "an earlier phase's model is still on the card")
    t0 = time.perf_counter()
    sol = scope.solve(scope.problem(
        scope.WorkloadSpec.lm(cfgs, seq_len=FACADE_SEQ, weights=list(FACADE_WEIGHTS)),
        tpu_v5e(16, (1, 16))))
    solve_s = time.perf_counter() - t0
    check(sol.feasible, "the facade's full-size solve is infeasible")
    check((sol.strategy, sol.multi.mode) == (FACADE_EXPECTED["strategy"], FACADE_EXPECTED["mode"]),
          f"solve picked {sol.strategy}/{sol.multi.mode}")
    print(f"  solve: strategy {sol.strategy}, mode {sol.multi.mode}, weighted throughput "
          f"{sol.multi.weighted_throughput} /s, dse_s {sol.diagnostics['dse_s']:.3f} s, "
          f"{solve_s:.3f} s in all (host seconds; the cost model's TPU v5e constants, "
          "not this card)")
    t0 = time.perf_counter()
    dep = sol.deploy(global_batch=4)
    deploy_s = time.perf_counter() - t0
    plans = {name: (p.p1, p.p2, p.transition_repeat, p.meta["quota_chips"], p.meta["co_mode"])
             for name, p in dep.plans.items()}
    check(plans == FACADE_EXPECTED["plans"], f"deploy plans {plans}")
    how = "re-planned" if dep.multi is not sol.multi else "reused the solve's"
    print(f"  deploy(global_batch=4): {deploy_s:.3f} s (host), {how} {dep.multi.mode} co-schedule")
    for name, (p1, p2, rep, quota, mode) in plans.items():
        print(f"    ShardPlan {name}: p1 {p1}, p2 {p2}, transition_repeat {rep}, "
              f"quota_chips {quota}, co_mode {mode}")

    modeled = {a.model: service_from_assignment(a) for a in sol.as_multimodel().assignments}
    reset_launches()
    t0 = time.perf_counter()
    rep = sol.serve(n_requests=1000, seed=0, measure=True, seq_len=FACADE_SEQ, device=device)
    serve_s = time.perf_counter() - t0
    launches = {k.__name__.removesuffix("_kernel"): k.launches for k in kernels}
    calls = (1 + FACADE_ITERS) * len(FACADE_BATCHES)
    want = calls * sum(c.n_layers for c in cfgs)
    check(launches["flash_attention"] == want,
          f"{launches['flash_attention']} flash launches in the measured serve, expected {want}")
    check(sum(launches.values()) == launches["flash_attention"],
          f"another kernel launched on the facade path: {launches}")
    source = rep.meta["service_source"]
    check(set(source) == set(modeled) and set(source.values()) == {"measured"},
          f"servers not on their measured service law: {source}")
    check(rep.conserved, "measured serving report does not conserve requests")
    print(f"  serve(measure=True): {serve_s:.3f} s (host, both models built and timed), "
          f"{launches['flash_attention']} flash launches ({calls} prefills a model) {card}")
    for name, measured in rep.meta["service"].items():
        timed = rep.meta["measured_s"][name]
        mod = modeled[name]
        print(f"    {name}: modeled beat {mod.beat:.6e} s, overhead {mod.overhead_s} s, "
              f"stages {mod.stages}, samples/beat {mod.samples_per_beat} | measured beat "
              f"{measured.beat:.6f} s, overhead {measured.overhead_s:.6f} s (timed "
              + ", ".join(f"b={b} {1e3 * s:.3f} ms" for b, s in timed.items()) + f") {card}")
    g_name = next(n for n in rep.meta["measured_s"] if n.startswith(cfgs[0].name + "@"))
    g_b4_ms = 1e3 * rep.meta["measured_s"][g_name][FACADE_BATCHES[1]]
    rel = g_b4_ms / granite_prefill_ms - 1.0
    check(abs(rel) <= FACADE_PREFILL_TOL,
          f"granite-3-8b measured b=4 prefill {g_b4_ms:.3f} ms vs phase 3's "
          f"{granite_prefill_ms:.3f} ms ({rel:+.1%}, tol {FACADE_PREFILL_TOL:.0%})")
    print(f"  granite-3-8b b=4: {g_b4_ms:.3f} ms measured vs {granite_prefill_ms:.3f} ms phase 3 "
          f"({rel:+.2%}, tol {FACADE_PREFILL_TOL:.0%}) {card}")
    print(f"  measured report: {_report_line(rep)}")
    base = sol.serve(n_requests=1000, seed=0)
    check(base.conserved, "modeled serving report does not conserve requests")
    check(base.total_arrived == rep.total_arrived, "the two runs served different traces")
    check((base.goodput, base.latency_p95_s, base.makespan_s)
          != (rep.goodput, rep.latency_p95_s, rep.makespan_s),
          "measured report equals the modeled one: the measurements were dropped")
    print(f"  modeled report (measure=False): {_report_line(base)}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def train_breakdown(prof, hand=(("flash forward", "fa_fwd"), ("flash backward", "fa_bwd"))
                    ) -> dict[str, list]:
    """Device time of one profiled train step by kind: the hand kernels
    (``hand``: kind and symbol part; by default the flash forward and
    backward), dense products (cuBLAS / CUTLASS symbols), the optimizer
    (kernels launched under the step's ``optimizer`` range: compression,
    clipping, the update) and everything else."""
    import torch

    # kernels and copies; not the device-side span of the ``optimizer`` range
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != "optimizer"]
    groups = {k: [0, 0.0] for k in (*(kind for kind, _ in hand), "dense products",
                                    "optimizer", "other")}

    def under_optimizer(e) -> bool:
        while e is not None:
            if e.name == "optimizer":
                return True
            e = e.cpu_parent
        return False

    opt_us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels and under_optimizer(e):
            for k in e.kernels:
                opt_us[k.name] = opt_us.get(k.name, 0.0) + k.duration
    opt_total = sum(opt_us.values()) / 1e3
    opt_n = sum(len(e.kernels) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU and e.kernels
                and under_optimizer(e))
    for e in kern:
        name = e.name.lower()
        kind = next((k for k, sym in hand if sym in name), None) or (
            "dense products" if any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma"))
            else "other")
        groups[kind][0] += 1
        groups[kind][1] += e.time_range.elapsed_us() / 1e3
    groups["optimizer"] = [opt_n, opt_total]
    groups["other"][0] -= opt_n
    groups["other"][1] -= opt_total
    return groups


def bwd_split(prof) -> dict[str, float]:
    """Device ms of each kind of the flash backward's kernels in a trace (D,
    dq, dk / dv with their partial sums' addition)."""
    import torch

    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "fa_bwd_" in e.name:
            kind = next(x for x in ("delta", "prep", "dkdv", "dq") if f"fa_bwd_{x}" in e.name)
            split[kind] = split.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    return split


def training_phase(get_config, card: str, reset_launches, kernels, cuda_ms, cuda_ms_median,
                   sync) -> dict:
    """Phase 15: the flash backward kernel against its plain version, the
    model's gradients through the kernels against plain attention, the
    training path (granite-3-8b at full width, 16 layers) and the
    train -> failure -> restart -> decode story.  Returns the backward's
    results at the main-path shape and each kernel's launches on the
    training path."""
    import dataclasses
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.ft import ResilientTrainer
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cost,
                                                            flash_attention_bwd_kernel,
                                                            flash_attention_kernel)
    from repro_torch.kernels.cost import visible_pairs
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.launch.hlo_analysis import kernel_bound
    from repro_torch.models import init_kv_cache, init_params, loss_fn
    from repro_torch.tree import leaf_layers
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step, greedy_generate
    from repro_torch.runtime.train import build_train_step

    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()
    print(f"phase 15: training: the flash backward kernel, granite-3-8b training at full "
          f"width, train -> failure -> restart -> decode ({held / 2**30:.3f} GiB allocated "
          "before the phase)")
    check(held < 2 * 2**30, "an earlier phase's model is still on the card")

    # (a) the backward kernel, on what a training forward keeps, against
    # attention_bwd_ref; (b) its times in bf16 beside SDPA's backward and the
    # bound (five products)
    bwd = {}
    for name, B, H, KV, S, hd, causal, window, cap in FA_BWD_CASES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q, k, v, do = fa_bwd_inputs(dev, B, H, KV, S, hd, cap, dtype)
            saved = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=cap,
                                           with_lse=True)

            def call():
                return flash_attention_bwd_kernel(q, k, v, do, saved, causal=causal,
                                                  window=window, softcap=cap)

            got = call()
            want = attention_bwd_ref(q, k, v, do, causal, window, cap)
            sync()
            res, missed = fa_bwd_errors(got, want, dtype)
            check(not missed, f"{name} {dt}: kernel vs plain: {'; '.join(missed)}")
            again = call()
            check(all(torch.equal(a, b_) for a, b_ in zip(got, again, strict=True)),
                  f"{name} {dt}: two calls differ")
            del got, want, again
            if dt == "bfloat16":
                res["ms"] = cuda_ms_median(call, 21)
                pairs = visible_pairs(S, S, causal, window)
                cost = flash_attention_bwd_cost(q, k, v, causal, window)
                bound_s, bound_by = kernel_bound(cost)
                res.update(bound_ms=1e3 * bound_s, bound_by=bound_by,
                           bound_arithmetic=f"5 products x 2 x B*H*hd*pairs = 10 x {B}*{H}*{hd}*"
                           f"{pairs} = {cost.flops:.4e} FLOP / {BF16_PEAK_FLOPS:.3e} FLOP/s = "
                           f"{1e3 * cost.flops / BF16_PEAK_FLOPS:.4f} ms; {cost.bytes} bytes / "
                           f"{HBM_BYTES_PER_S:.3e} B/s = {1e3 * cost.bytes / HBM_BYTES_PER_S:.4f} ms")
                # SDPA has no softcap and takes a window only as a dense mask:
                # under them its causal backward is a different function
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                     enable_gqa=H != KV)
                sdpa_ms = cuda_ms_median(
                    lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 21)
                del out, leaves
                if window == 0 and cap == 0.0:
                    res["library_ms"] = sdpa_ms
                else:
                    res["library_ms"] = None
                    res["sdpa_causal_bwd_other_function_ms"] = sdpa_ms
            if (name, dt) == FA_BWD_MAIN:
                res["plain_ms"] = cuda_ms(
                    lambda: attention_bwd_ref(q, k, v, do, causal, window, cap), 3)
                # the forward's serving and training instantiations
                res["fwd_ms"] = cuda_ms_median(lambda: flash_attention_kernel(q, k, v), 21)
                res["fwd_training_ms"] = cuda_ms_median(
                    lambda: flash_attention_kernel(q, k, v, with_lse=True), 21)
            bwd[(name, dt)] = res
            print(f"  (a) {name} B={B} H={H} KV={KV} S={S} hd={hd} causal={causal} "
                  f"window={window} softcap={cap} {dt}: {json.dumps(res)} {card}")
            del q, k, v, do, saved
            torch.cuda.empty_cache()

    # (c) the model's gradients through the kernels against plain attention
    cfg = get_config("granite-3-8b")
    cfg_c = dataclasses.replace(cfg, n_layers=2)
    print(f"  (c) {cfg.name} full width, bf16, reduced: n_layers {cfg.n_layers}→{cfg_c.n_layers}; "
          "B=4 x S=2048, loss and every leaf's gradient through the kernels vs plain attention")
    model = init_params(cfg_c, torch.Generator(device=dev).manual_seed(0), dev).train_params()
    def named_flat(m):
        """(key, tensor) per layer of every leaf, in the reference's order."""
        return [(key, t) for key, leaf in tree.flatten_with_path(m.param_tree())
                for t in leaf_layers(leaf)]

    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 2048), generator=gen).to(dev)
    labels = torch.randint(0, cfg.vocab, (4, 2048), generator=gen).to(dev)
    reset_launches()
    loss_k = loss_fn(model, tokens, labels)
    grads_k = torch.autograd.grad(loss_k, model.flat_params())
    check(flash_attention_bwd_kernel.launches == cfg_c.n_layers,
          f"{flash_attention_bwd_kernel.launches} backward launches, expected {cfg_c.n_layers}")
    loss_p = loss_fn(model, tokens, labels, plain_attention=True)
    grads_p = torch.autograd.grad(loss_p, model.flat_params())
    # per layer of every leaf: ||kernels - plain|| / ||plain||, held to the
    # bf16 bound; the largest difference over the leaf's largest entry beside
    # it (the two paths' bf16 forwards differ by rounding, which the network
    # carries into every gradient, not only attention's)
    worst, worst_max = (0.0, ""), (0.0, "")
    for (key, _), gk, gp in zip(named_flat(model), grads_k, grads_p, strict=True):
        d = gk.float() - gp.float()
        rel = (d.norm() / gp.float().norm()).item()
        worst = max(worst, (rel, key))
        worst_max = max(worst_max, ((d.abs().max() / gp.float().abs().max()).item(), key))
        check(rel <= 2e-2, f"{key}: gradient through the kernels vs plain attention, relative "
              f"norm {rel:.3e} (tol 2e-2)")
    for (key, _), gk in zip(named_flat(model), grads_k, strict=True):
        if key.endswith(("['wq']", "['wk']", "['wv']")):
            check(gk.abs().max().item() > 0, f"zero {key} gradient through attention")
    # both bf16 paths against the same weights in fp32 (plain attention, TF32
    # off): the kernels must add no error beyond bf16's own, each leaf's
    # distance from fp32 within 10 % of the plain path's (+1e-3)
    cfg_32 = dataclasses.replace(cfg_c, param_dtype="float32")
    m32 = init_params(cfg_32, torch.Generator(device=dev).manual_seed(0), dev).train_params()
    with torch.no_grad():
        for a, b in zip(m32.flat_params(), model.flat_params(), strict=True):
            a.copy_(b.float())
    grads_32 = torch.autograd.grad(loss_fn(m32, tokens, labels, plain_attention=True),
                                   m32.flat_params())
    worst_ratio = (0.0, "", 0.0, 0.0)
    for (key, _), gk, gp, g32 in zip(named_flat(model), grads_k, grads_p, grads_32,
                                     strict=True):
        rk = ((gk.float() - g32).norm() / g32.norm()).item()
        rp = ((gp.float() - g32).norm() / g32.norm()).item()
        worst_ratio = max(worst_ratio, (rk / rp, key, rk, rp))
        check(rk <= 1.1 * rp + 1e-3, f"{key}: kernels {rk:.3e} from fp32, plain attention "
              f"{rp:.3e}")
    del m32, grads_32
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(rel_loss <= 2e-2, f"loss through the kernels {loss_k.item()} vs plain {loss_p.item()}")
    print(f"      loss {loss_k.item():.6f} (kernels) vs {loss_p.item():.6f} (plain); worst "
          f"relative norm {worst[0]:.3e} at {worst[1]} (tol 2e-2); worst max difference "
          f"{worst_max[0]:.3e} of the leaf's largest gradient at {worst_max[1]}; from the "
          f"fp32 run the kernels are at most {worst_ratio[0]:.4f}x the plain path's distance "
          f"({worst_ratio[2]:.3e} vs {worst_ratio[3]:.3e} at {worst_ratio[1]}); every "
          f"wq/wk/wv gradient non-zero {card}")
    del model, grads_k, grads_p, loss_k, loss_p
    torch.cuda.empty_cache()

    # (d) the slice's path: granite-3-8b, full width, 16 layers, AdamW
    cfg_d = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    print(f"  (d) {cfg.name} full width, bf16, AdamW, B={B} x S={S}, reduced: n_layers "
          f"{cfg.n_layers}→{cfg_d.n_layers} (weights + grads + AdamW moments at 12 bytes a "
          "parameter fit 80 GB at 16 layers, not at 40)")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg_d, torch.Generator(device=dev).manual_seed(0), dev).train_params()
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_optimizer(cfg_d.optimizer)[0](model.param_tree())
    plan = plan_for_cell(cfg_d, S, B, ("data", "model"), 1, kind="train")
    print(f"      {n_params / 1e9:.3f} B params; DSE plan (model_axis 1, kind train): p1 {plan.p1}, "
          f"p2 {plan.p2}, dse {plan.meta.get('dse')}; {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB allocated with the optimizer state")
    step = build_train_step(cfg_d, plan, base_lr=3e-4, warmup=2, total_steps=100, device=dev)
    it = make_batch_iterator(cfg_d, batch=B, seq=S, seed=0)
    batches = {}

    def batch_fn(s):
        while s not in batches:
            i, b = next(it)
            batches[i] = b
        return batches[s]

    for s in range(TRAIN_STEPS + 1):
        batch_fn(s)                                  # host data made before the timed run
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = ResilientTrainer(train_step=step, batch_fn=batch_fn, ckpt_dir=ckpt,
                                   ckpt_every=10 * TRAIN_STEPS)
        reset_launches()
        model, opt, hist = trainer.run(model, opt, n_steps=TRAIN_STEPS)
        sync()
        launches = {k.__name__.removesuffix("_kernel"): k.launches for k in kernels}
    check(len(hist) == TRAIN_STEPS, f"{len(hist)} steps ran")
    check(launches["flash_attention"] == 2 * TRAIN_STEPS * cfg_d.n_layers,
          f"{launches['flash_attention']} flash forward launches (remat recomputes each "
          f"layer's forward: expected {2 * TRAIN_STEPS * cfg_d.n_layers})")
    check(launches["flash_attention_bwd"] == TRAIN_STEPS * cfg_d.n_layers,
          f"{launches['flash_attention_bwd']} flash backward calls, expected "
          f"{TRAIN_STEPS * cfg_d.n_layers}")
    check(launches["wkv6"] == launches["mamba_scan"] == launches["qmatmul"] == 0,
          f"another kernel launched on the training path: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(math.isfinite(x) for x in losses + norms), f"non-finite loss {losses} or "
          f"grad norm {norms}")
    times = [1e3 * h["time"] for h in hist]
    step_ms = statistics.median(times[1:])
    # one more step traced, then the gradient of every leaf checked
    b = batch_fn(TRAIN_STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model, opt, m = step(model, opt, b)
        sync()
    gnorm = m["grad_norm"].item()
    check(math.isfinite(gnorm) and math.isfinite(m["loss"].item()), "non-finite traced step")
    groups = train_breakdown(prof)
    split = bwd_split(prof)
    busy = sum(ms for _, ms in groups.values())
    del prof
    flat = model.flat_params()
    toks = torch.as_tensor(b["tokens"]).to(dev, torch.int64)
    labs = torch.as_tensor(b["labels"]).to(dev, torch.int64)
    grads = torch.autograd.grad(loss_fn(model, toks, labs), flat)
    bad = [i for i, g in enumerate(grads)
           if not (bool(torch.isfinite(g).all()) and g.abs().max().item() > 0)]
    check(not bad, f"{len(bad)} of {len(grads)} per-layer gradients are zero or non-finite")
    del grads, flat
    # model FLOPs: 6 x (parameters in products) x tokens, plus attention's
    # 3 x 4 x B*H*hd*pairs a layer (forward 2 products, backward 4); remat's
    # recomputed forward is not counted
    n_mm = n_params - model.embed.numel() - sum(
        p.numel() for n_, p in model.named_parameters() if "ln" in n_)
    pairs = visible_pairs(S, S, True, 0)
    attn = 12 * B * cfg.n_heads * cfg.head_dim * pairs * cfg_d.n_layers
    model_flops = 6 * n_mm * B * S + attn
    mfu = model_flops / (step_ms / 1e3) / BF16_PEAK_FLOPS
    print(f"      losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}, of the traced step {gnorm:.4f}; "
          f"all {len(model.flat_params())} per-layer gradients finite and non-zero")
    print(f"      step wall {step_ms:.3f} ms (median of steps 2-{TRAIN_STEPS}; all "
          f"{[round(t, 3) for t in times]}), {B * S / (step_ms / 1e3):.1f} tokens/s, MFU "
          f"{mfu:.4f} (model FLOPs 6 x {n_mm} x {B * S} + 12 x B*H*hd*pairs x L = "
          f"{model_flops:.4e} per step / step wall / 989e12), peak {peak:.2f} GiB, per step "
          f"{launches['flash_attention'] // TRAIN_STEPS} flash forward launches, "
          f"{launches['flash_attention_bwd'] // TRAIN_STEPS} flash backward calls {card}")
    print(f"      traced step: device busy {busy:.3f} ms: " + ", ".join(
        f"{kind} {ms:.3f} ms ({n} kernels)" for kind, (n, ms) in groups.items())
        + f"; the flash backward {100 * groups['flash backward'][1] / busy:.2f} % of it, per call: "
        + ", ".join(
            f"{kind} {ms / cfg_d.n_layers:.3f} ms" for kind, ms in split.items()) + f" {card}")
    train = {"step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3), "mfu": mfu,
             "peak_gib": peak, "launches": launches, "busy": groups, "bwd_split": split}
    del model, opt, step
    torch.cuda.empty_cache()

    # (e) the test_system story on the card: train -> failure at step 12 ->
    # restart from the step-10 checkpoint -> decode; bit-identical to an
    # uninterrupted run
    cfg_e = dataclasses.replace(get_smoke_config("granite-3-8b"), d_head=64,
                                param_dtype="bfloat16")
    print(f"  (e) {cfg_e.name} (reduced: d_head 16→64, the flash kernel's smallest; "
          "param_dtype float32→bfloat16), 20 steps, B=8 x S=32, checkpoints every 5, a failure "
          "injected at step 12, deterministic algorithms on")
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for label, fail_at in (("restarted", 12), ("uninterrupted", None)):
            plan = plan_for_cell(cfg_e, 32, 8, ("data", "model"), 1, kind="train", use_dse=False)
            step = build_train_step(cfg_e, plan, base_lr=5e-3, warmup=5, device=dev)
            model = init_params(cfg_e, torch.Generator(device=dev).manual_seed(0),
                                dev).train_params()
            opt = make_optimizer(cfg_e.optimizer)[0](model.param_tree())
            it_e = make_batch_iterator(cfg_e, batch=8, seq=32, seed=0)
            cache = {}

            def batch_e(s, it_e=it_e, cache=cache):
                while s not in cache:
                    i, bb = next(it_e)
                    cache[i] = bb
                return cache[s]

            fired = []

            def injector(s, fail_at=fail_at, fired=fired):
                if s == fail_at and not fired:
                    fired.append(s)
                    raise RuntimeError("injected failure")

            with tempfile.TemporaryDirectory() as ckpt:
                trainer = ResilientTrainer(train_step=step, batch_fn=batch_e, ckpt_dir=ckpt,
                                           ckpt_every=5)
                model, opt, hist = trainer.run(model, opt, n_steps=20, failure_injector=injector)
            runs[label] = (model, opt, hist, fired)
        model, opt, hist, fired = runs["restarted"]
        check(fired == [12], "the failure was not injected")
        check([h["step"] for h in hist].count(11) == 2, "no replay from the step-10 checkpoint")
        losses = [h["loss"] for h in hist]
        check(losses[-1] < losses[0], f"loss did not drop: {losses}")
        m2, o2, _, _ = runs["uninterrupted"]
        pairs_ = list(zip(tree.leaves((model.param_tree(), opt)), tree.leaves((m2.param_tree(), o2)),
                          strict=True))
        same = all(torch.equal(x, y) for a, b_ in pairs_
                   for x, y in zip(leaf_layers(a), leaf_layers(b_), strict=True))
        check(same, "the restarted run's parameters or optimizer state differ from the "
              "uninterrupted run's")
        dplan = plan_for_cell(cfg_e, 16, 4, ("data", "model"), 1, kind="decode")
        dstep = build_decode_step(cfg_e, dplan, batch=4, max_len=16, device=dev)
        caches = init_kv_cache(cfg_e, 4, 16, torch.bfloat16, dev)
        toks, _ = greedy_generate(cfg_e, model, dstep, caches,
                                  prompt_last_token=torch.ones(4, 1, dtype=torch.int64),
                                  start_pos=0, steps=8)
        sync()
        check(tuple(toks.shape) == (4, 8) and int(toks.max()) < cfg_e.padded_vocab,
              f"decoded {tuple(toks.shape)}")
        print(f"      restarted run: losses {losses[0]:.4f} → {losses[-1]:.4f} over "
              f"{len(hist)} recorded steps (step 11 and 12 replayed); parameters and optimizer "
              f"state bit-identical to the uninterrupted run ({len(pairs_)} leaves); decoded "
              f"{toks[0].tolist()} {card}")
    finally:
        torch.use_deterministic_algorithms(False)
    del runs
    torch.cuda.empty_cache()

    # (f) the train launcher as a process, granite-moe-1b-a400m at full size
    # (the MoE dispatch's backward; no checkpoint within its steps)
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "granite-moe-1b-a400m", "--steps", "4", "--ckpt-every", "100", "--ckpt-dir", ckpt]
        proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
                              capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0 and "final loss" in proc.stdout,
          f"{' '.join(cmd[1:6])} exited {proc.returncode}: {proc.stdout}{proc.stderr[-3000:]}")
    print(f"  (f) python {' '.join(cmd[1:8])}: " + " | ".join(
        line for line in proc.stdout.strip().splitlines() if not line.startswith("plan:"))
        + f" {card}")
    return {"bwd": bwd[FA_BWD_MAIN], "train": train}


def prefill_inputs(cfg, B: int, S: int, seed: int, dev) -> tuple:
    """The data pipeline's batch of S positions a row as the prefill step's
    inputs after the model, on ``dev``: (tokens,), for ``audio_stub``
    (frame embeddings,), for ``vision_stub`` (tokens, patch embeddings)."""
    import torch

    from repro_torch.data import make_batch_iterator

    _, batch = next(make_batch_iterator(cfg, batch=B, seq=S, seed=seed))
    toks = (torch.as_tensor(batch["tokens"]).long().to(dev),) if "tokens" in batch else ()
    emb = batch.get("frontend_embeds")
    return toks + (() if emb is None else (torch.as_tensor(emb).to(dev),))


def arch_prefill_phase(cfg, full_layers: int, seed: int, card: str, reset_launches, kernels,
                       sync) -> dict:
    """Phases 16-17 in bf16 at full width: the prefill step at B=4 x S=2048
    (one flash launch per attention layer and no other kernel; logits of the
    expected shape and finite), its wall time (median of 3) and its device
    time by kind, then one batch-4 decode step, wall beside device busy.
    Returns the prefill's median ms and flash launches."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_prefill_step

    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()
    print(f"  {cfg.name}: full width, {cfg.n_layers} layers, frontend {cfg.frontend}, bf16 "
          f"({held / 2**30:.3f} GiB allocated before)")
    check(held < 2 * 2**30, "an earlier phase's model is still on the card")
    if cfg.n_layers != full_layers:
        print(f"  reduced: n_layers {full_layers}→{cfg.n_layers}")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sync()
    print(f"    init {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = PREFILL_B, PREFILL_S
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(cfg, plan, dev)
    inputs = prefill_inputs(cfg, B, S, seed + 1, dev)

    def step(m, x):
        return prefill(m, *x)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = step(model, inputs)
    sync()
    launches = {k.__name__.removesuffix("_kernel"): k.launches for k in kernels}
    n_attn = sum(kind in ("attn", "local") for kind in cfg.block_kinds())
    check(launches["flash_attention"] == n_attn,
          f"{launches['flash_attention']} flash launches in one {cfg.name} prefill, "
          f"expected {n_attn}")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"another kernel launched in a {cfg.name} prefill: {launches}")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), f"non-finite {cfg.name} prefill logits")
    del logits
    times = timed_prefills(step, model, inputs, sync)
    print(f"    prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {n_attn} flash launches per call, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    print(f"    prefill traced: {prefill_breakdown(step, model, inputs, ('fa_fwd',), sync)} "
          f"{card}")
    prof = decode_step_profile(cfg, model, dev, sync)
    print(f"    decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()
    return {"prefill_ms": statistics.median(times), "flash_launches": n_attn}


def fp32_prefill_vs_decode(cfg, full_layers: int, seed: int, reset_launches, kernels,
                           sync) -> None:
    """Phases 16-17 in fp32 at full width and reduced depth, TF32 off: the
    prefill step against token-by-token decode from zero caches.  audio:
    the prefill's frames are the embedded tokens, which decode embeds;
    vision: a prefill of the patches and the first text tokens (caches
    collected), then decode of the rest, against one prefill of it all.
    Each logit within 1e-3 of the logits' scale (phase 4's bound)."""
    import torch

    from repro_torch.models import init_kv_cache, init_params
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, n_layers=min(FP32_LAYERS, cfg.n_layers),
                                param_dtype="float32")
    held = torch.cuda.memory_allocated()
    check(held < 2 * 2**30, "an earlier phase's model is still on the card")
    print(f"  {cfg.name}: fp32 prefill vs decode, TF32 off, full width")
    print(f"  reduced: n_layers {full_layers}→{cfg32.n_layers}")
    model = init_params(cfg32, torch.Generator(device=dev).manual_seed(seed), dev)
    flash = kernels[0]
    n_attn = sum(kind in ("attn", "local") for kind in cfg32.block_kinds())
    B = FP32_B
    g = torch.Generator().manual_seed(seed + 1)
    if cfg.frontend == "vision_stub":
        P, (T1, T2) = cfg.frontend_tokens, VISION_TEXT
        S = P + T1 + T2
        toks = torch.randint(0, cfg.vocab, (B, T1 + T2), generator=g).to(dev)
        patches = (0.02 * torch.randn(B, P, cfg.d_model, generator=g)).to(dev)
        plan = plan_for_cell(cfg32, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
        reset_launches()
        whole = build_prefill_step(cfg32, plan, dev)(model, toks, patches)
        with torch.inference_mode():
            pre_logits, pre = model(toks[:, :T1], patches, collect_cache=True)
        check(flash.launches == 2 * n_attn, f"{flash.launches} flash launches, expected "
              f"{2 * n_attn}")
        dplan = plan_for_cell(cfg32, S, B, ("data", "model"), 1, kind="decode")
        dstep = build_decode_step(cfg32, dplan, batch=B, max_len=S, device=dev)
        caches = init_kv_cache(cfg32, B, S, torch.float32, dev)
        for full, c in zip(caches, pre):
            for n in full:
                full[n][:, :, :P + T1] = c[n]
        dec = []
        for t in range(T2):
            lg, caches = dstep(model, toks[:, T1 + t:T1 + t + 1],
                               torch.full((B,), P + T1 + t), caches)
            dec.append(lg)
        pairs = [(f"prefix prefill ({P} patches + {T1} tokens)", pre_logits, whole[:, :P + T1]),
                 (f"decode of the last {T2} tokens", torch.cat(dec, dim=1), whole[:, P + T1:])]
        shape = f"B={B}, {P} patches + {T1 + T2} tokens"
    else:
        S = FP32_S
        toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
        plan = plan_for_cell(cfg32, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
        inputs = ((model.embed[toks.to(dev)].detach(),) if cfg.frontend == "audio_stub"
                  else (toks,))
        reset_launches()
        whole = build_prefill_step(cfg32, plan, dev)(model, *inputs)
        check(flash.launches == n_attn, f"{flash.launches} flash launches, expected {n_attn}")
        dec, _ = decode_token_by_token(cfg32, model, toks, dev)
        what = "frames = embed[tokens]" if cfg.frontend == "audio_stub" else "tokens"
        pairs = [(f"token-by-token decode vs prefill of {what}", dec, whole)]
        shape = f"B={B} S={S}"
    sync()
    check(all(k.launches == 0 for k in kernels[1:]), "another kernel launched")
    report = []
    for name, a, b in pairs:
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        check(bool(torch.isfinite(a).all()), f"{cfg.name} {name}: non-finite logits")
        check(err <= 1e-3 * scale, f"{cfg.name} {name}: max abs err {err} > 1e-3 x {scale}")
        report.append(f"{name}: max |diff| {err:.3e} (tol 1e-3 x max|logit| = "
                      f"{1e-3 * scale:.3e})")
    print(f"    {shape}: " + "; ".join(report))
    del model, whole, pairs
    torch.cuda.empty_cache()


def launcher_training(arch: str, card: str, reset_launches, kernels, sync) -> None:
    """``python -m repro_torch.launch.train --arch <arch>`` as a process at
    full size, B=4 x S=2048 (it exits non-zero on a non-finite loss or grad
    norm); then, in this process, the gradient of the same full-size config
    on the pipeline's first batch: every per-layer gradient finite and
    non-zero (``check_gradients``), one flash backward launch per attention
    layer and one WKV-6 backward launch per rwkv layer."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.train import check_gradients
    from repro_torch.models import init_params

    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--steps",
               str(LAUNCHER_STEPS), "--batch", str(PREFILL_B), "--seq", str(PREFILL_S),
               "--ckpt-every", "100", "--ckpt-dir", ckpt]
        proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
                              capture_output=True, text=True, timeout=600)
    shown = " ".join(cmd[1:11])                     # the checkpoint flags left out
    check(proc.returncode == 0 and "final loss" in proc.stdout,
          f"{shown} exited {proc.returncode}: {proc.stdout}{proc.stderr[-3000:]}")
    print(f"  python {shown}: " + " | ".join(
        line for line in proc.stdout.strip().splitlines() if not line.startswith("plan:"))
        + f" {card}")
    cfg = get_config(arch)
    dev = torch.device("cuda")
    check(torch.cuda.memory_allocated() < 2 * 2**30,
          "an earlier phase's model is still on the card")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev).train_params()
    _, batch = next(make_batch_iterator(cfg, batch=PREFILL_B, seq=PREFILL_S))
    reset_launches()
    n = check_gradients(model, batch, dev)
    sync()
    launches = {k.__name__.removesuffix("_kernel"): k.launches for k in kernels}
    n_attn = sum(kind in ("attn", "local") for kind in cfg.block_kinds())
    n_rwkv = sum(kind == "rwkv" for kind in cfg.block_kinds())
    check(launches["flash_attention_bwd"] == n_attn,
          f"{launches['flash_attention_bwd']} flash backward launches in one {cfg.name} "
          f"gradient, expected {n_attn}")
    check(launches["wkv6_bwd"] == n_rwkv,
          f"{launches['wkv6_bwd']} wkv6 backward launches in one {cfg.name} gradient, "
          f"expected {n_rwkv}")
    print(f"    gradient on the first batch (B={PREFILL_B} x S={PREFILL_S}): all {n} per-layer "
          f"gradients finite and non-zero, {n_attn} flash backward launches, {n_rwkv} wkv6 "
          "backward launches")
    del model
    torch.cuda.empty_cache()


def wkv6_training_phase(get_config, card: str, reset_launches, kernels, cuda_ms,
                        cuda_ms_median, sync) -> dict:
    """Phase 18: the WKV-6 backward kernel against its plain version, then
    rwkv6-3b trained at full size on the card.  Returns the backward's
    results at the main-path shape and its launches on the training path."""
    import tempfile

    import torch

    from repro_torch.data import make_batch_iterator
    from repro_torch.ft import ResilientTrainer
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_cost, wkv6_bwd_kernel, wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_ref
    from repro_torch.launch.hlo_analysis import kernel_bound
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.train import build_train_step

    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()
    print(f"phase 18: the WKV-6 backward kernel, rwkv6-3b training at full size "
          f"({held / 2**30:.3f} GiB allocated before the phase)")
    check(held < 2 * 2**30, "an earlier phase's model is still on the card")
    names = ("dr", "dk", "dv", "dlogw", "du")

    # (a) the kernel on what the forward keeps, against wkv6_bwd_ref: the
    # forward's bound 2e-4 on every gradient and its per-row bound over rows
    # that are not ~0 (dlogw's last row is 0 without dS_last); two calls
    # bit-identical.  (b) times, at the training shape.
    bwd = {}
    for name, B, H, S, hd, strong, with_ds in WKV_BWD_CASES:
        args = wkv_inputs(dev, B, H, S, hd, strong=strong)
        g = torch.Generator(device=dev).manual_seed(1)
        dout = torch.randn(B, H, S, hd, generator=g, device=dev)
        ds = torch.randn(B, H, hd, hd, generator=g, device=dev) if with_ds else None
        _, _, seg_state = wkv6_kernel(*args, with_states=True)

        def call():
            return wkv6_bwd_kernel(*args, seg_state, dout, ds)

        got = call()
        want = wkv6_bwd_ref(*args, dout, ds)
        again = call()
        sync()
        res, missed = {"tol": WKV_TOL, "row_tol": WKV_ROW_REL_TOL}, []
        for gname, a, w in zip(names, got, want, strict=True):
            err = (a - w).abs().max().item()
            rel = row_rel_err(a, w, floor=FA_BWD_ROW_FLOOR)
            if not bool(torch.isfinite(a).all()):
                missed.append(f"{gname}: non-finite")
            if not torch.allclose(a, w, rtol=WKV_TOL, atol=WKV_TOL):
                missed.append(f"{gname}: max abs err {err} (tol {WKV_TOL})")
            if not rel <= WKV_ROW_REL_TOL:
                missed.append(f"{gname}: per-row error {rel} / rms (tol {WKV_ROW_REL_TOL})")
            res[f"{gname}_max_abs_err"] = err
            res[f"{gname}_row_rel_err"] = rel
        check(not missed, f"{name}: kernel vs plain: {'; '.join(missed)}")
        check(all(torch.equal(a, b) for a, b in zip(got, again, strict=True)),
              f"{name}: two calls differ")
        res["max_abs_err"] = max(res[f"{g}_max_abs_err"] for g in names)
        rounding = ""
        if name == WKV_BWD_MAIN:
            # How far each is from the float64 plain version (max abs error),
            # dlogw the ill-conditioned one
            want64 = wkv6_bwd_ref(*(a.double() for a in args), dout.double(),
                                  None if ds is None else ds.double())
            rounding = "; vs the fp64 plain version: " + ", ".join(
                f"{who} {g} {(x.double() - y).abs().max().item():.3e}"
                for who, got_ in (("fp32 plain", want), ("kernel", got))
                for g, x, y in zip(names, got_, want64))
            del want64
        del got, want, again
        if name == WKV_BWD_MAIN:
            res["ms"] = cuda_ms_median(call, 21)
            # each pass (one launch a call): the mean of its traced launches
            call()
            sync()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                sync()
            passes = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA and "wkv6_bwd_" in e.name:
                    kind = e.name.split("wkv6_bwd_")[1].split("(")[0]     # e.g. sweep<64, 2>
                    passes.setdefault(kind, []).append(e.time_range.elapsed_us() / 1e3)
            res["passes_ms"] = {kind: statistics.mean(ms) for kind, ms in passes.items()}
            res["passes_traced"] = {kind: len(ms) for kind, ms in passes.items()}
            del prof
            # plain: autograd of the plain forward, the backward alone
            leaves = [a.detach().requires_grad_(True) for a in args]
            out, _ = wkv6_ref(*leaves)
            res["plain_ms"] = cuda_ms(
                lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), 2)
            del out, leaves
            res["bwd_ref_ms"] = cuda_ms(lambda: wkv6_bwd_ref(*args, dout, ds), 1)
            res["fwd_ms"] = cuda_ms_median(lambda: wkv6_kernel(*args), 21)
            res["fwd_with_states_ms"] = cuda_ms_median(
                lambda: wkv6_kernel(*args, with_states=True), 21)
            res["library_ms"] = None
            # the least work: drs, dks, dv (three mat-vecs) and the S and G
            # updates, 2 hd^2 operations each a token-head, in fp32 (the
            # inputs' type; the kernel's sweeps run fp64, 2x slower on the
            # card, for dlogw's accuracy); r, k, v, logw, dout, u and the
            # segment states read once, dr, dk, dv, dlogw, du written once
            cost = wkv6_bwd_cost(*args, seg_state)
            bound_s, bound_by = kernel_bound(cost)
            res.update(bound_ms=1e3 * bound_s, bound_by=bound_by,
                       bound_arithmetic=f"10 x B*H*S*hd^2 = {cost.flops:.4e} FLOP / "
                       f"{FP32_PEAK_FLOPS:.3e} FLOP/s = {1e3 * cost.flops / FP32_PEAK_FLOPS:.4f} "
                       f"ms; {cost.bytes} bytes / {HBM_BYTES_PER_S:.3e} B/s = "
                       f"{1e3 * cost.bytes / HBM_BYTES_PER_S:.4f} ms")
        bwd[name] = res
        print(f"  (a) {name} B={B} H={H} S={S} hd={hd}{', strong decays' if strong else ''}"
              f"{', dS_last' if with_ds else ''}: {json.dumps(res)}{rounding} {card}")
        del args, dout, ds, seg_state
        torch.cuda.empty_cache()

    # (c) rwkv6-3b at full size: 32 layers, bf16, AdamW, B=4 x S=2048
    cfg = get_config("rwkv6-3b")
    B, S = PREFILL_B, PREFILL_S
    print(f"  (c) {cfg.name} full size ({cfg.n_layers} layers), bf16, AdamW, B={B} x S={S}, "
          f"{RWKV_TRAIN_STEPS} steps through ResilientTrainer")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev).train_params()
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="train")
    print(f"      {n_params / 1e9:.3f} B params; DSE plan (model_axis 1, kind train): p1 {plan.p1}, "
          f"p2 {plan.p2}, dse {plan.meta.get('dse')}; {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB allocated with the optimizer state")
    step = build_train_step(cfg, plan, base_lr=3e-4, warmup=2, total_steps=100, device=dev)
    it = make_batch_iterator(cfg, batch=B, seq=S, seed=0)
    batches = {}

    def batch_fn(s):
        while s not in batches:
            i, b = next(it)
            batches[i] = b
        return batches[s]

    for s in range(RWKV_TRAIN_STEPS + 1):
        batch_fn(s)                                  # host data made before the timed run
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = ResilientTrainer(train_step=step, batch_fn=batch_fn, ckpt_dir=ckpt,
                                   ckpt_every=10 * RWKV_TRAIN_STEPS)
        reset_launches()
        model, opt, hist = trainer.run(model, opt, n_steps=RWKV_TRAIN_STEPS)
        sync()
        launches = {k.__name__.removesuffix("_kernel"): k.launches for k in kernels}
    check(len(hist) == RWKV_TRAIN_STEPS, f"{len(hist)} steps ran")
    check(launches["wkv6_bwd"] == RWKV_TRAIN_STEPS * cfg.n_layers,
          f"{launches['wkv6_bwd']} wkv6 backward calls, expected "
          f"{RWKV_TRAIN_STEPS * cfg.n_layers}")
    check(launches["wkv6"] == 2 * RWKV_TRAIN_STEPS * cfg.n_layers,
          f"{launches['wkv6']} wkv6 forward calls (remat recomputes each layer's forward: "
          f"expected {2 * RWKV_TRAIN_STEPS * cfg.n_layers})")
    check(all(n == 0 for k, n in launches.items() if k not in ("wkv6", "wkv6_bwd")),
          f"another kernel launched on the rwkv training path: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(math.isfinite(x) for x in losses + norms), f"non-finite loss {losses} or "
          f"grad norm {norms}")
    times = [1e3 * h["time"] for h in hist]
    step_ms = statistics.median(times[1:])
    b = batch_fn(RWKV_TRAIN_STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model, opt, m = step(model, opt, b)
        sync()
    check(math.isfinite(m["grad_norm"].item()) and math.isfinite(m["loss"].item()),
          "non-finite traced step")
    groups = train_breakdown(prof, hand=(("wkv6 backward", "wkv6_bwd_"),
                                         ("wkv6 forward", "wkv6_")))
    busy = sum(ms for _, ms in groups.values())
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "wkv6_bwd_" in e.name:
            kind = e.name.split("wkv6_bwd_")[1].split("(")[0]     # e.g. sweep<64, 2>
            split[kind] = split.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    del prof
    # model FLOPs: 6 x (parameters in products) x tokens, plus the WKV
    # recurrence's 14 hd^2 a token-head a layer (forward 4: r S and the
    # update; backward 10); remat's recomputed forward is not counted
    n_mm = sum(p.numel() for n_, p in model.named_parameters()
               if p.dim() == 2 and not n_.endswith(("embed", ".mu", ".u")))
    hd = cfg.rwkv_head_dim
    wkv = 14 * B * S * (cfg.d_model // hd) * hd * hd * cfg.n_layers
    model_flops = 6 * n_mm * B * S + wkv
    mfu = model_flops / (step_ms / 1e3) / BF16_PEAK_FLOPS
    print(f"      losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}")
    print(f"      step wall {step_ms:.3f} ms (median of steps 2-{RWKV_TRAIN_STEPS}; all "
          f"{[round(t, 3) for t in times]}), {B * S / (step_ms / 1e3):.1f} tokens/s, MFU "
          f"{mfu:.4f} (model FLOPs 6 x {n_mm} x {B * S} + 14 x B*S*H*hd^2 x L = "
          f"{model_flops:.4e} per step / step wall / 989e12), peak {peak:.2f} GiB, per step "
          f"{launches['wkv6'] // RWKV_TRAIN_STEPS} wkv6 forward calls, "
          f"{launches['wkv6_bwd'] // RWKV_TRAIN_STEPS} wkv6 backward calls {card}")
    print(f"      traced step: device busy {busy:.3f} ms: " + ", ".join(
        f"{kind} {ms:.3f} ms ({n} kernels)" for kind, (n, ms) in groups.items())
        + f"; the wkv6 backward {100 * groups['wkv6 backward'][1] / busy:.2f} % of it, per call: "
        + ", ".join(f"{kind} {ms / cfg.n_layers:.3f} ms" for kind, ms in split.items())
        + f" {card}")
    train = {"step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3), "mfu": mfu,
             "peak_gib": peak, "launches": launches, "busy": groups, "bwd_split": split}
    del model, opt, step, m
    torch.cuda.empty_cache()

    # (d) the train launcher as a process at full size, then every
    # per-layer gradient through the kernels in this process
    launcher_training("rwkv6-3b", card, reset_launches, kernels, sync)
    return {"bwd": bwd[WKV_BWD_MAIN], "train": train}


def mamba_bwd_errors(got, want) -> tuple[dict, list[str]]:
    """The scan backward's six gradients against mamba_scan_bwd_ref: the
    forward's bound 2e-4 on every one, and its per-row bound over rows whose
    rms reaches FA_BWD_ROW_FLOOR of the tensor's (dD is one row)."""
    import torch

    res, missed = {"tol": MAMBA_TOL, "row_tol": MAMBA_ROW_REL_TOL}, []
    for gname, a, w in zip(MAMBA_BWD_NAMES, got, want, strict=True):
        err = (a.float() - w.float()).abs().max().item()
        rel = row_rel_err(a, w, floor=FA_BWD_ROW_FLOOR)
        if not bool(torch.isfinite(a).all()):
            missed.append(f"{gname}: non-finite")
        if not torch.allclose(a.float(), w.float(), rtol=MAMBA_TOL, atol=MAMBA_TOL):
            missed.append(f"{gname}: max abs err {err} (tol {MAMBA_TOL})")
        if not rel <= MAMBA_ROW_REL_TOL:
            missed.append(f"{gname}: per-row error {rel} / rms (tol {MAMBA_ROW_REL_TOL})")
        res[f"{gname}_max_abs_err"] = err
        res[f"{gname}_row_rel_err"] = rel
    res["max_abs_err"] = max(res[f"{g}_max_abs_err"] for g in MAMBA_BWD_NAMES)
    return res, missed


def mamba_bwd_kernel_checks(card: str, cuda_ms, cuda_ms_median, sync) -> dict:
    """Phase 19 (a) and (b): the selective-scan backward kernel on the chunk
    states the forward keeps, against mamba_scan_bwd_ref at every case of
    MAMBA_BWD_CASES (the forward's bounds; two calls bit-identical; with bf16
    x the kernel's fp32 dx / dB / dC held to them, and its bf16 ones equal
    to those rounded), then its times at the training shape (each of its
    two kernels' is traced in the training step, phase 19(c)).  Returns the
    results per case."""
    import torch

    from repro_torch.kernels.mamba.kernel import (mamba_scan_bwd_cost, mamba_scan_bwd_kernel,
                                                  mamba_scan_kernel, n_state_slots)
    from repro_torch.kernels.mamba.ref import mamba_scan_bwd_ref
    from repro_torch.launch.hlo_analysis import kernel_bound

    dev = torch.device("cuda")
    out = {}
    for name, B, S, di, N, dt_name, model_layout, strong, with_dh in MAMBA_BWD_CASES:
        dtype = getattr(torch, dt_name)
        args = mamba_inputs(dev, B, S, di, N, dtype, model_layout, strong=strong)
        g = torch.Generator(device=dev).manual_seed(1)
        dy = torch.randn(B, S, di, generator=g, device=dev)
        dh = torch.randn(B, di, N, generator=g, device=dev) if with_dh else None
        y, h_last, states = mamba_scan_kernel(*args, with_states=True)
        y0, h0 = mamba_scan_kernel(*args)
        check(torch.equal(y, y0) and torch.equal(h_last, h0),
              f"{name}: the forward with states differs from the one without")
        check(tuple(states.shape) == (B, di, n_state_slots(S), N), f"{name}: states {states.shape}")
        slots = n_state_slots(S)
        for k in sorted({1, slots}) if slots else ():       # h at token 64k, bit for bit
            prefix = [t[:, :64 * k] if t.dim() == 3 else t for t in args]
            check(torch.equal(states[:, :, k - 1], mamba_scan_kernel(*prefix)[1]),
                  f"{name}: chunk state {k - 1} is not the forward's h at token {64 * k}")
        del y, h_last, y0, h0

        def call(grad_dtype=None):
            return mamba_scan_bwd_kernel(*args, states, dy, dh, grad_dtype=grad_dtype)

        got32 = call(torch.float32)
        got = call() if dtype != torch.float32 else got32
        again = call()
        want = mamba_scan_bwd_ref(*args, dy, dh)
        sync()
        res, missed = mamba_bwd_errors(got32, want)
        check(not missed, f"{name}: kernel vs plain: {'; '.join(missed)}")
        check(all(torch.equal(a, b) for a, b in zip(got, again, strict=True)),
              f"{name}: two calls differ")
        check(all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, got32, strict=True)),
              f"{name}: the gradients in {dt_name} are not the fp32 ones rounded")
        check([t.dtype for t in got] == [torch.float32, dtype, torch.float32, dtype, dtype,
                                         torch.float32], f"{name}: gradient dtypes")
        rounding = ""
        if name == MAMBA_BWD_MAIN:
            # How far each is from the float64 plain version: max abs error /
            # per-row error
            want64 = mamba_scan_bwd_ref(*(a.double() for a in args), dy.double(),
                                        None if dh is None else dh.double())
            rounding = "; vs the fp64 plain version: " + ", ".join(
                f"{who} {gn} {(x.double() - w64).abs().max().item():.3e} / "
                f"{row_rel_err(x, w64, floor=FA_BWD_ROW_FLOOR):.3e}"
                for who, got_ in (("fp32 plain", want), ("kernel", got32))
                for gn, x, w64 in zip(MAMBA_BWD_NAMES, got_, want64))
            del want64
        del got, got32, again, want
        if name == MAMBA_BWD_MAIN:
            # each of its two kernels' time: traced in the training step, (c)
            res["ms"] = cuda_ms_median(call, 21)
            res["plain_ms"] = cuda_ms(lambda: mamba_scan_bwd_ref(*args, dy, dh), 1)
            res["fwd_ms"] = cuda_ms_median(lambda: mamba_scan_kernel(*args), 21)
            res["fwd_with_states_ms"] = cuda_ms_median(
                lambda: mamba_scan_kernel(*args, with_states=True), 21)
            res["library_ms"] = None
            # the least work: per state-token a_t (2), g (2), a h and h_t (3),
            # the term and its dA (3), the sums over n for ddt and dx (4) and
            # over the channels for dB and dC (4); per channel-token dt x, ddt,
            # dx and dD (8).  Bytes: every input read once (B, C: the views'
            # own elements), the chunk states read, every gradient written.
            cost = mamba_scan_bwd_cost(*args, states)
            bound_s, bound_by = kernel_bound(cost)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            clk = float(subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True, text=True,
                check=True, timeout=60).stdout)
            res.update(bound_ms=1e3 * bound_s, bound_by=bound_by,
                       bound_arithmetic=f"(18 N + 8) x B*S*di = {cost.flops:.4e} FLOP / "
                       f"{FP32_PEAK_FLOPS:.3e} FLOP/s = {1e3 * cost.flops / FP32_PEAK_FLOPS:.4f} "
                       f"ms; {cost.bytes} bytes / {HBM_BYTES_PER_S:.3e} B/s = "
                       f"{1e3 * cost.bytes / HBM_BYTES_PER_S:.4f} ms",
                       context={"exp_floor_ms_per_pass": 1e3 * B * S * di * N
                                / (sms * SFU_EXP2_PER_CLOCK * clk * 1e6),
                                # the chunk's forward over all but its last
                                # sub-chunk, then every sub-chunk's recompute
                                "exp_passes": 2 - 1 / 8, "sm_clock_max_mhz": clk})
        out[name] = res
        print(f"  (a) {name} B={B} S={S} di={di} N={N} x {dt_name}"
              f"{', B/C strided views' if model_layout else ''}"
              f"{', strong decays' if strong else ''}{', dh_last' if with_dh else ''}: "
              f"{json.dumps(res)}{rounding} {card}")
        del args, dy, dh, states
        torch.cuda.empty_cache()
    return out


def mamba_training_phase(get_config, card: str, reset_launches, kernels, cuda_ms,
                         cuda_ms_median, sync) -> dict:
    """Phase 19: the selective-scan backward kernel against its plain
    version, then jamba-v0.1-52b trained on the card at full width, one
    period of its layer pattern.  Returns the backward's results at the
    main-path shape and its launches on the training path."""
    import tempfile

    import torch

    from repro_torch.data import make_batch_iterator
    from repro_torch.ft import ResilientTrainer
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_kernel
    from repro_torch.kernels.cost import visible_pairs
    from repro_torch.kernels.mamba.kernel import mamba_scan_bwd_kernel
    from repro_torch.launch.train import check_gradients
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.train import build_train_step

    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()
    print(f"phase 19: the selective-scan backward kernel, jamba-v0.1-52b training at full "
          f"width ({held / 2**30:.3f} GiB allocated before the phase)")
    check(held < 2 * 2**30, "an earlier phase's model is still on the card")
    bwd = mamba_bwd_kernel_checks(card, cuda_ms, cuda_ms_median, sync)

    # (c) one period of jamba at full width, its experts as one dense FFN:
    # bf16, AdamW, B=4 x S=2048
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_TRAIN_LAYERS, moe=None)
    kinds = cfg.block_kinds()
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    B, S = PREFILL_B, PREFILL_S
    print(f"  (c) {full.name} full width, {cfg.n_layers} layers ({n_mamba} mamba, {n_attn} "
          f"attention), bf16, AdamW, B={B} x S={S}, {JAMBA_TRAIN_STEPS} steps through "
          "ResilientTrainer")
    print(f"      reduced: n_layers {full.n_layers}→{cfg.n_layers}, moe "
          f"{full.moe.n_experts}×top-{full.moe.top_k} → dense d_ff {cfg.d_ff}")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(60), dev).train_params()
    n_params = sum(p.numel() for p in model.parameters())
    opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="train")
    print(f"      {n_params / 1e9:.3f} B params; DSE plan (model_axis 1, kind train): p1 {plan.p1}, "
          f"p2 {plan.p2}, dse {plan.meta.get('dse')}; {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB allocated with the optimizer state")
    step = build_train_step(cfg, plan, base_lr=3e-4, warmup=2, total_steps=100, device=dev)
    it = make_batch_iterator(cfg, batch=B, seq=S, seed=0)
    batches = {}

    def batch_fn(s):
        while s not in batches:
            i, b = next(it)
            batches[i] = b
        return batches[s]

    for s in range(JAMBA_TRAIN_STEPS + 2):
        batch_fn(s)                                  # host data made before the timed run
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = ResilientTrainer(train_step=step, batch_fn=batch_fn, ckpt_dir=ckpt,
                                   ckpt_every=10 * JAMBA_TRAIN_STEPS)
        reset_launches()
        model, opt, hist = trainer.run(model, opt, n_steps=JAMBA_TRAIN_STEPS)
        sync()
        launches = {k.__name__.removesuffix("_kernel"): k.launches for k in kernels}
    check(len(hist) == JAMBA_TRAIN_STEPS, f"{len(hist)} steps ran")
    want = {"mamba_scan": 2 * n_mamba, "mamba_scan_bwd": n_mamba,
            "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    for k, per_step in want.items():
        check(launches[k] == JAMBA_TRAIN_STEPS * per_step,
              f"{launches[k]} {k} launches in {JAMBA_TRAIN_STEPS} steps, expected "
              f"{JAMBA_TRAIN_STEPS * per_step} (remat runs each forward twice)")
    check(all(n == 0 for k, n in launches.items() if k not in want),
          f"another kernel launched on the jamba training path: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(math.isfinite(x) and x > 0 for x in losses + norms),
          f"non-finite or zero loss {losses} or grad norm {norms}")
    times = [1e3 * h["time"] for h in hist]
    step_ms = statistics.median(times[1:])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model, opt, m = step(model, opt, batch_fn(JAMBA_TRAIN_STEPS))
        sync()
    check(math.isfinite(m["grad_norm"].item()) and math.isfinite(m["loss"].item()),
          "non-finite traced step")
    groups = train_breakdown(prof, hand=(("scan backward", "mamba_scan_bwd"),
                                         ("scan forward", "mamba_scan_fwd"),
                                         ("flash backward", "fa_bwd"),
                                         ("flash forward", "fa_fwd")))
    busy = sum(ms for _, ms in groups.values())
    # the backward's two kernels a call (chunk: the sweep; sum: the partials'
    # sums).  A short trace of the calls alone, begun at a profile's start,
    # kept none of their launches after the earlier phases; this one keeps all.
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "mamba_scan_bwd_" in e.name:
            kind = e.name.split("mamba_scan_bwd_")[1].split("<")[0]
            split[kind] = split.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / n_mamba
    del prof
    # model FLOPs: 6 x (parameters in products) x tokens, plus attention's
    # 12 x B*H*hd*pairs a layer and the scan's (7 N + 3) forward and
    # (18 N + 8) backward a channel-token a layer; remat's recomputed
    # forward is not counted
    n_mm = sum(p.numel() for n_, p in model.named_parameters()
               if p.dim() == 2 and not n_.endswith(("embed", "conv_w", "A_log")))
    N, di = cfg.mamba_d_state, cfg.mamba_expand * cfg.d_model
    attn = 12 * B * cfg.n_heads * cfg.head_dim * visible_pairs(S, S, True, 0) * n_attn
    scan = (25 * N + 11) * B * S * di * n_mamba
    model_flops = 6 * n_mm * B * S + attn + scan
    mfu = model_flops / (step_ms / 1e3) / BF16_PEAK_FLOPS
    print(f"      losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}")
    print(f"      step wall {step_ms:.3f} ms (median of steps 2-{JAMBA_TRAIN_STEPS}; all "
          f"{[round(t, 3) for t in times]}), {B * S / (step_ms / 1e3):.1f} tokens/s, MFU "
          f"{mfu:.4f} (model FLOPs 6 x {n_mm} x {B * S} + 12 x B*H*hd*pairs x {n_attn} + "
          f"(25 N + 11) x B*S*di x {n_mamba} = {model_flops:.4e} per step / step wall / "
          f"989e12), peak {peak:.2f} GiB, per step " + ", ".join(
              f"{launches[k] // JAMBA_TRAIN_STEPS} {k}" for k in want) + f" launches {card}")
    print(f"      traced step: device busy {busy:.3f} ms: " + ", ".join(
        f"{kind} {ms:.3f} ms ({n} kernels)" for kind, (n, ms) in groups.items())
        + f"; the scan backward {100 * groups['scan backward'][1] / busy:.2f} % of it, per "
        "call: " + ", ".join(f"{kind} {ms:.3f} ms" for kind, ms in split.items()) + f" {card}")
    reset_launches()
    n = check_gradients(model, batch_fn(JAMBA_TRAIN_STEPS + 1), dev)
    sync()
    check(mamba_scan_bwd_kernel.launches == n_mamba
          and flash_attention_bwd_kernel.launches == n_attn,
          "scan / flash backward launches in one gradient")
    print(f"      gradient after training (B={B} x S={S}): all {n} per-layer gradients finite "
          f"and non-zero, {n_mamba} scan backward launches")
    train = {"step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3), "mfu": mfu,
             "peak_gib": peak, "launches": launches, "busy": groups, "bwd_split": split}
    del model, opt, step, m, batches, it
    torch.cuda.empty_cache()

    # (d) the same period with its experts: one gradient at B=1 x S=2048,
    # no optimizer
    cfg_moe = dataclasses.replace(full, n_layers=JAMBA_TRAIN_LAYERS)
    check(torch.cuda.memory_allocated() < 2 * 2**30, "the training model is still on the card")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg_moe, torch.Generator(device=dev).manual_seed(61), dev).train_params()
    n_params = sum(p.numel() for p in model.parameters())
    held = torch.cuda.memory_allocated() / 2**30
    _, batch = next(make_batch_iterator(cfg_moe, batch=1, seq=S, seed=1))
    reset_launches()
    n = check_gradients(model, batch, dev)
    sync()
    check(mamba_scan_bwd_kernel.launches == n_mamba
          and flash_attention_bwd_kernel.launches == n_attn,
          "scan / flash backward launches in the MoE gradient")
    print(f"  (d) {full.name} full width, {cfg_moe.n_layers} layers with "
          f"{full.moe.n_experts}×top-{full.moe.top_k} experts on every second layer, "
          f"{n_params / 1e9:.3f} B params ({held:.2f} GiB of bf16 weights), one gradient at "
          f"B=1 x S={S}: all {n} per-layer gradients finite and non-zero, {n_mamba} scan "
          f"backward launches, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    print(f"      reduced: n_layers {full.n_layers}→{cfg_moe.n_layers}, batch 1, no optimizer")
    del model
    torch.cuda.empty_cache()

    # (e) the train launcher on the smoke config, as a process on the card
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", full.name, "--smoke",
               "--device", "cuda", "--steps", str(LAUNCHER_STEPS), "--ckpt-every", "100",
               "--ckpt-dir", ckpt]
        proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
                              capture_output=True, text=True, timeout=600)
    shown = " ".join(cmd[1:10])                     # the checkpoint flags left out
    check(proc.returncode == 0 and "final loss" in proc.stdout,
          f"{shown} exited {proc.returncode}: {proc.stdout}{proc.stderr[-3000:]}")
    print(f"  (e) python {shown}: " + " | ".join(
        line for line in proc.stdout.strip().splitlines() if not line.startswith("plan:"))
        + f" {card}")
    return {"bwd": bwd[MAMBA_BWD_MAIN], "train": train}


def p20_kernel_calls(dev):
    """(name, kernel, args, kwargs) of phase 20(b)'s calls on ``dev``."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (SavedForward,
                                                            flash_attention_bwd_kernel,
                                                            flash_attention_kernel)
    from repro_torch.kernels.mamba.kernel import mamba_scan_bwd_kernel, mamba_scan_kernel
    from repro_torch.kernels.qmatmul.kernel import qmatmul_kernel
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_kernel, wkv6_kernel

    calls = []
    for name, B, H, KV, S, hd, causal, window, cap in FA_BWD_CASES:
        if name not in ("granite_train", "granite20b_mqa"):
            continue
        *qkv, do = fa_bwd_inputs(dev, B, H, KV, S, hd, cap, torch.bfloat16)
        mask = dict(causal=causal, window=window, softcap=cap)
        saved = SavedForward(*flash_attention_kernel(*qkv, with_lse=True, **mask))
        if name == "granite_train":
            calls += [("flash_attention", flash_attention_kernel, qkv, mask),
                      ("flash_attention with_lse", flash_attention_kernel, qkv,
                       dict(with_lse=True, **mask))]
        calls.append((f"flash_attention_bwd {name}", flash_attention_bwd_kernel,
                      [*qkv, do, saved], mask))
    args = wkv_inputs(dev, 4, 40, 2048, 64)
    seg_state = wkv6_kernel(*args, with_states=True)[2]
    calls += [("wkv6", wkv6_kernel, args, {}),
              ("wkv6 with_states", wkv6_kernel, args, dict(with_states=True)),
              ("wkv6_bwd", wkv6_bwd_kernel, [*args, seg_state, torch.randn_like(args[0])], {})]
    args = mamba_inputs(dev, 4, 2048, 8192, 16, torch.bfloat16, True)
    states = mamba_scan_kernel(*args, with_states=True)[2]
    dy = torch.randn(args[1].shape, dtype=torch.float32, device=dev)
    calls += [("mamba_scan", mamba_scan_kernel, args, {}),
              ("mamba_scan with_states", mamba_scan_kernel, args, dict(with_states=True)),
              ("mamba_scan_bwd", mamba_scan_bwd_kernel, [*args, states, dy], {})]
    M, N, K = QMM_MAIN
    g = torch.Generator(device=dev).manual_seed(20)
    calls.append(("qmatmul", qmatmul_kernel,
                  [torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8),
                   torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
                   torch.rand(M, generator=g, device=dev), torch.rand(N, generator=g, device=dev)],
                  {}))
    return calls


def phase20_card(default_allocator: bool = False) -> int:
    """Phase 20 (a)-(c), in a process of its own whose allocator maps
    expandable segments, where each block is its request rounded up to 512
    bytes (the rule the dry-run's tracker counts by); prints its lines and,
    last, a JSON object of the kernel calls each cell's step made.  With
    ``default_allocator`` only (c), under the default allocator.  Either
    way each step's reserved peak is held to ``RESERVED_MARGIN`` above the
    dry-run's peak."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = (                # before CUDA starts
        f"expandable_segments:{not default_allocator}")
    import gc

    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import (CARD_TOTAL_MEMORY, CARD_USABLE_MEMORY,
                                                 RESERVED_MARGIN)
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.planner import plan_for_cell

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    card = f"[{nvidia_smi_line()}]"
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:     # built already by phase 1
        list(pool.map(_build.build, KERNEL_SOURCES))
    # cuBLAS' workspaces, before any baseline: one a thread, so also the
    # autograd engine's backward thread
    x = torch.ones(256, 256, device=dev, dtype=torch.bfloat16, requires_grad=True)
    ((x @ x).float() @ x.float().detach()).sum().backward()
    del x
    sync()
    meta = torch.device("meta")
    if not default_allocator:
        p20_kernels(dev, sync, meta)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) whole steps: the predicted peak against the measured one
    held = int(os.environ.get("P20_HELD_ELSEWHERE", 0))     # by the script's main process
    usable = torch.cuda.mem_get_info()[0] + held
    print(f"  (c) usable: mem_get_info() reads {usable - held} bytes free, every kernel loaded "
          f"and cuBLAS' workspaces made, {held} more held by the parent process; the dry-run's "
          f"CARD_USABLE_MEMORY {CARD_USABLE_MEMORY}")
    calls, bad, margins = {}, [], {}
    for cell, arch, layers, kind, B, S in P20_CELLS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        if cell == "jamba_period_dense":
            cfg = dataclasses.replace(cfg, moe=None)
        plan = plan_for_cell(cfg, S, B, dryrun.MESH_AXES, 1, kind=kind, use_dse=False)
        t0 = time.perf_counter()
        pred = dryrun.trace_step(cfg, S, B, kind, plan)
        trace_s = time.perf_counter() - t0
        sync()
        base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt = None
        if kind == "train":
            model.train_params()
            opt = make_optimizer(cfg.optimizer)[0](model.param_tree())
        g = torch.Generator(device=dev).manual_seed(1)
        inputs = {n: (torch.randint(0, cfg.vocab, t.shape, generator=g, device=dev,
                                    dtype=t.dtype) if not t.is_floating_point()
                      else torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
                  for n, t in dryrun.cell_inputs(cfg, S, B, kind, meta).items()}
        sync()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernel_functions():
            fn.launches = 0
        out = dryrun.run_step(cfg, plan, kind, S, B, model, opt, inputs, dev)
        sync()
        measured = torch.cuda.max_memory_allocated() - base
        reserved = torch.cuda.max_memory_reserved() - base_reserved
        launched = {fn.__name__: fn.launches for fn in kernel_functions() if fn.launches}
        del model, opt, inputs, out
        gc.collect()
        torch.cuda.empty_cache()
        peak = pred["memory_analysis"]["peak_bytes"]
        calls[cell] = pred["kernel_calls"]
        margins[cell] = reserved / peak - 1
        off = margins[cell] > RESERVED_MARGIN or (not default_allocator
                                                  and abs(peak / measured - 1) > P20_PEAK_TOL)
        if launched != pred["kernel_calls"] or off:
            bad.append(cell)
        print(f"  (c{' default allocator' if default_allocator else ''}) {cell} ({arch}, "
              f"{cfg.n_layers} layers, {kind} B={B} x S={S}): predicted "
              f"peak {peak} bytes ({peak / 2**30:.3f} GiB), measured {measured} bytes "
              f"({measured / 2**30:.3f} GiB), predicted / measured {peak / measured:.5f} "
              f"(tol {P20_PEAK_TOL:.0%}); reserved {reserved} bytes ({reserved / 2**30:.3f} "
              f"GiB), {margins[cell]:+.5f} of the prediction; kernel_calls "
              f"{pred['kernel_calls']}, the card's launches {launched}; trace {trace_s:.2f} s; "
              f"roofline {pred['roofline']['dominant']} "
              f"{pred['roofline']['bound_s'] * 1e3:.3f} ms {card}")
    if default_allocator:
        check(not bad, f"(c) under the default allocator the reserved peak is more than "
                       f"RESERVED_MARGIN {RESERVED_MARGIN} above the prediction, or the "
                       f"kernel calls disagree, for {bad}")
    else:
        check(not bad, f"(c) predicted and measured peaks, the reserved peak or the kernel "
                       f"calls disagree for {bad}")
        check(0 <= usable - CARD_USABLE_MEMORY <= 0.01 * CARD_TOTAL_MEMORY,
              f"CARD_USABLE_MEMORY {CARD_USABLE_MEMORY} is not within 1 % below the "
              f"{usable} bytes this process can allocate")
    print(json.dumps({"p20_kernel_calls": calls, "p20_reserved_margins": margins}))
    return 0


def p20_kernels(dev, sync, meta) -> None:
    """Phase 20 (a) the card's constants and the split rule; (b) one call of
    each kernel function, the allocator's rise against the tracker's peak."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (_DTYPE_CODES, H100_SMS, _bwd_split,
                                                            kv_split)
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import CARD_NAME, CARD_TOTAL_MEMORY

    # (a) the card's constants and the split rule
    props = torch.cuda.get_device_properties(dev)
    name = torch.cuda.get_device_name(dev)
    print(f"  (a) {name}: {props.multi_processor_count} SMs, total_memory {props.total_memory} "
          f"bytes; the dry-run's constants: {CARD_NAME}, {H100_SMS} SMs, {CARD_TOTAL_MEMORY} bytes")
    check(name == CARD_NAME and props.total_memory == CARD_TOTAL_MEMORY
          and props.multi_processor_count == H100_SMS,
          "the dry-run's card constants (launch/hlo_analysis.py, flash kernel.py) are not this card's")
    grid = [(dt, hd, B, H, KV, S) for dt in (torch.float32, torch.bfloat16) for hd in (64, 128, 256)
            for B in (1, 2, 4) for H, KV in ((32, 8), (48, 1), (16, 8), (40, 8), (24, 24), (8, 1))
            for S in (64, 256, 1000, 2048, 8192)]
    split = _bwd_split()
    bad = [c for c in grid if split(_DTYPE_CODES[c[0]], *c[1:]) != kv_split(*c)]
    splits = sorted({kv_split(*c) for c in grid})
    check(not bad, f"kv_split's Python copy differs from the C rule at {bad[:5]}")
    print(f"  (a) kv_split: the Python copy equals repro_flash_attention_bwd_split at {len(grid)} "
          f"(dtype, hd, B, H, KV, Skv), granite-20b's MQA among them; splits seen {splits}")

    # (b) one call of each kernel function: the allocator's rise against the
    # tracker's peak on meta

    def on_meta(a):
        if isinstance(a, torch.Tensor):
            return a.to(meta)
        if isinstance(a, tuple):                       # SavedForward
            return type(a)(*(None if t is None else t.to(meta) for t in a))
        return a

    bad = []
    for what, fn, args, kw in p20_kernel_calls(dev):
        fn(*args, **kw)                                          # first call: nothing lazy left
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kw)
        sync()
        rise = torch.cuda.max_memory_allocated() - base
        del out
        margs = [on_meta(a) for a in args]
        with dryrun.StorageTracker() as t:
            out = fn(*margs, **kw)
        del out
        if t.peak != rise:
            bad.append(what)
        print(f"  (b) {what}: the allocator rose {rise} bytes on the card, the meta tracker's "
              f"peak {t.peak} bytes ({'equal' if t.peak == rise else 'DIFFERENT'})")
        del args, margs
    check(not bad, f"(b) the meta tracker's peak is not the card's allocation for {bad}")


def kernel_functions() -> tuple:
    """The seven kernel functions; the dry-run names them by ``__name__``."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                            flash_attention_kernel)
    from repro_torch.kernels.mamba.kernel import mamba_scan_bwd_kernel, mamba_scan_kernel
    from repro_torch.kernels.qmatmul.kernel import qmatmul_kernel
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_kernel, wkv6_kernel

    return (flash_attention_kernel, flash_attention_bwd_kernel, wkv6_kernel, wkv6_bwd_kernel,
            mamba_scan_kernel, mamba_scan_bwd_kernel, qmatmul_kernel)


def dryrun_phase(card: str, phase_launches: dict) -> None:
    """Phase 20: (a)-(c) in a process of its own (``phase20_card``), then (c)
    again under the default allocator in another; beside them (d) the
    dry-run of every registry cell and (e) the CLI and the two model
    examples as processes; every one must exit 0.  ``phase_launches``:
    the launches a step of each (c) cell made in the earlier phases, which
    the dry-run's kernel_calls must equal."""
    import gc

    import torch

    print("phase 20: the dry-run on the meta device against the card; the CLI and the "
          "examples")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    # what this process still holds on the card (its context, its kernels),
    # which (c) adds back to the free memory it reads
    env = dict(os.environ, PYTHONPATH=str(SRC), P20_HELD_ELSEWHERE=str(total - free))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(P20_COMMANDS) + len(P20_EXAMPLES) + 1) as pool:
        def start(commands):
            return {name: pool.submit(subprocess.run, [sys.executable, *cmd], cwd=REPO, env=env,
                                      capture_output=True, text=True, timeout=900)
                    for name, cmd in commands}

        side = start([("dryrun --all", P20_DRYRUN), *P20_COMMANDS])
        for mode in ([], ["default"]):       # expandable segments, then the default allocator
            child = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--phase-20",
                                    *mode], cwd=REPO, env=env, capture_output=True, text=True,
                                   timeout=900)
            print(child.stdout.rstrip())
            check(child.returncode == 0, f"phase 20 {mode or '(a)-(c)'} exited "
                                         f"{child.returncode}: {child.stderr[-3000:]}")
            if not mode:
                calls = json.loads(child.stdout.strip().splitlines()[-1])["p20_kernel_calls"]
                side.update(start(P20_EXAMPLES))
        for cell, want in phase_launches.items():
            check(calls[cell] == want, f"(c) {cell}: the dry-run's kernel_calls {calls[cell]}, "
                                       f"the launches a step made in its phase {want}")
        print("  (c) kernel_calls = the launches a step made in phases 3, 15(d), 18(c), 19(c): "
              + "; ".join(f"{c} {w}" for c, w in phase_launches.items()))
        done = {name: f.result() for name, f in side.items()}
    dr = done.pop("dryrun --all")
    check(dr.returncode == 0 and "all cells passed" in dr.stdout,
          f"dryrun --all exited {dr.returncode}: {dr.stdout[-2000:]}{dr.stderr[-2000:]}")
    lines = dr.stdout.splitlines()
    cells = [(a.removeprefix("=== "), b.strip().removeprefix("ok: "))
             for a, b in zip(lines, lines[1:]) if a.startswith("=== ")]
    for tag, line in cells:
        print(f"  (d) {tag}: {line}")
    print(f"  (d) python -m repro_torch.launch.dryrun --all: {len(cells)} cells, all passed")
    for name, proc in done.items():
        check(proc.returncode == 0, f"(e) {name} exited {proc.returncode}: "
                                    f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}")
        tail = " | ".join(proc.stdout.strip().splitlines()[-3:])
        print(f"  (e) {name}: exit 0; {tail[:300]}")
    print(f"  phase 20 wall {time.perf_counter() - t0:.1f} s {card}")


def mesh_plan_kwargs(cfg, B: int, S: int, m: int, names) -> dict:
    """Each named plan of a phase-21 cell as ShardPlan keywords: ISP, WSP,
    mixed (WSP, then ISP from the middle repeat) and "dse", the plan
    plan_for_cell chooses at model axis m (left out where it is one of the
    others, which the caller prints)."""
    from repro_torch.runtime.planner import plan_for_cell

    fixed = {"ISP": {"p1": "ISP", "p2": "ISP", "transition_repeat": None},
             "WSP": {"p1": "WSP", "p2": "WSP", "transition_repeat": None},
             "mixed": {"p1": "WSP", "p2": "ISP",
                       "transition_repeat": cfg.pattern_repeats // 2}}
    plans = {n: fixed[n] for n in names if n != "dse"}
    if "dse" in names:
        p = plan_for_cell(cfg, S, B, P21_AXES, model_axis=m, kind="prefill")
        kw = {"p1": p.p1, "p2": p.p2, "transition_repeat": p.transition_repeat}
        same = [n for n, v in plans.items() if v == kw]
        print(f"  {cfg.name} ({cfg.n_layers} layers) at model axis {m}: plan_for_cell "
              f"chooses {kw} (t_layers {p.meta['t_layers']})"
              + (f" = the {same[0]} plan" if same else ""))
        if not same:
            plans["dse"] = kw
    return plans


def p21_rank(world, cells: list, steps: int) -> list:
    """One rank of phase 21 (a process of its own on the shared card): each
    cell, ``(arch, layers, B, S, mesh shape, plans, seed)``, on its mesh
    over the same processes; its :func:`p21_cell` results."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    out = []
    for arch, layers, B, S, shape, plans, seed in cells:
        mesh = world if tuple(shape) == world.dims else make_mesh(shape, P21_AXES, world.device)
        out.append(p21_cell(mesh, arch, layers, B, S, plans, seed, steps))
        torch.cuda.empty_cache()
    return out


def p21_cell(mesh, arch: str, layers: int, B: int, S: int, plans: dict, seed: int,
             steps: int) -> dict:
    """One rank of a phase-21 cell.

    The whole model from the seed, then, one rank at a time (each holds a
    full-vocab fp32 logit tensor meanwhile), its one-rank prefill and
    ``steps`` decode steps from the prefill's caches: this rank's rows and
    vocab columns of their logits.  Then per plan: the rank's shard, the
    mesh prefill (wall time, flash launches, the allocator's rise, the
    collectives) and the decode steps from the rank's pieces of the same
    caches, each against the one-rank logits, and the dry-run's prediction
    for this rank (``trace_step`` on a meta rank at these coordinates):
    its collectives and its peak.  Raises on any failed check."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_kv_cache, init_params
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.runtime.sharding import ShardPlan, rank_shard, shard_caches, shard_model

    dev = mesh.device
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    whole = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(seed + 1))
    dtoks = torch.randint(0, cfg.vocab, (steps, B, 1),
                          generator=torch.Generator().manual_seed(seed + 2))
    place = rank_shard(cfg, ShardPlan(P21_AXES), mesh)     # rows and vocab: the same for all
    rows = slice(place.dpi * B // place.dp, (place.dpi + 1) * B // place.dp)
    v0, v1 = place.vocab
    for turn in range(mesh.size):
        if turn == mesh.rank:
            with torch.inference_mode():
                logits, pre = whole(tokens.to(dev), collect_cache=True)
                ref = logits[rows, :, v0:v1].clone()
                del logits
                caches = init_kv_cache(cfg, B, S + steps, torch.bfloat16, dev)
                for full, part in zip(caches, pre):
                    for n in full:
                        full[n][:, :, :S] = part[n]
                del pre
                start = tuple({n: t.clone() for n, t in c.items()} for c in caches)
                dref = []
                for t in range(steps):
                    lg, caches = whole.decode_step(dtoks[t].to(dev),
                                                   torch.full((B,), S + t, device=dev), caches)
                    dref.append(lg[rows, :, v0:v1].clone())
                del caches, lg
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    scale = ref.abs().max().item()
    dscale = max(d.abs().max().item() for d in dref)
    out = {}
    for name, kw in plans.items():
        plan = ShardPlan(P21_AXES, **kw)
        model = shard_model(whole, plan, mesh)
        prefill = build_prefill_step(cfg, plan, dev, mesh)
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        mesh.comm.reset()
        flash_attention_kernel.launches = 0
        t0 = time.perf_counter()
        local = prefill(model, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention_kernel.launches
        rise = torch.cuda.max_memory_allocated() - before
        calls = dict(mesh.comm.calls)
        stats = mesh.comm.stats()
        check(bool(torch.isfinite(local).all()), f"{arch} {name}: non-finite mesh logits")
        err = (local - ref).abs().max().item()
        del local
        decode = build_decode_step(cfg, plan, B, S + steps, dev, mesh)
        state = shard_caches(start, model.shard)
        derr, dcalls = 0.0, None
        dist.barrier()
        t0 = time.perf_counter()
        for t in range(steps):
            mesh.comm.reset()
            lg, state = decode(model, dtoks[t], torch.full((B,), S + t), state)
            if t == 0:
                dcalls = dict(mesh.comm.calls)
            derr = max(derr, (lg - dref[t]).abs().max().item())
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
        del state, model
        meta = make_mesh(mesh.dims, mesh.axis_names, meta=True, coords=mesh.coords)
        pred = dryrun.trace_step(cfg, S, B, "prefill", plan, meta)
        pcalls = dict(meta.comm.calls)
        meta = make_mesh(mesh.dims, mesh.axis_names, meta=True, coords=mesh.coords)
        dryrun.trace_step(cfg, S + steps, B, "decode", plan, meta)
        where = f"{arch} {tuple(mesh.dims)} {name} rank {mesh.rank}"
        check(launches == layers, f"{where}: {launches} flash launches, expected {layers}")
        check(err <= P21_LOGIT_TOL * scale,
              f"{where}: prefill logits max abs err {err} > {P21_LOGIT_TOL} x {scale}")
        check(derr <= P21_LOGIT_TOL * dscale,
              f"{where}: decode logits max abs err {derr} > {P21_LOGIT_TOL} x {dscale}")
        check(calls == pcalls, f"{where}: prefill collectives {calls} vs the dry-run's {pcalls}")
        check(dcalls == dict(meta.comm.calls),
              f"{where}: decode collectives {dcalls} vs the dry-run's {meta.comm.calls}")
        mem = pred["memory_analysis"]
        out[name] = {"wall_s": wall, "decode_s": dwall, "launches": launches, "err": err,
                     "scale": scale, "decode_err": derr, "decode_scale": dscale,
                     "bytes_by_kind": stats["bytes_by_kind"],
                     "count_by_kind": stats["count_by_kind"], "rise": rise,
                     "pred_temp": mem["temp_size_bytes"], "pred_peak": mem["peak_bytes"],
                     "args": mem["argument_size_bytes"]}
    return out


def mesh_phase(get_config, card: str, sync) -> int:
    """Phase 21; returns the flash launches of one rank's WSP prefill of
    granite-3-8b on the (1, 4) mesh (the phase's main path)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (flash_attention_cost,
                                                            flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.hlo_analysis import kernel_bound
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    print("phase 21: the serving steps on (data, model) meshes of ranks sharing the card "
          "over gloo; the flash kernel with a query offset")
    for name, B, H, KV, Sq, Skv, off, hd, window, cap in P21_FA_CASES:
        for dt, tol in (("float32", 2e-3), ("bfloat16", 2e-2)):
            dtype = getattr(torch, dt)
            g = torch.Generator(device=dev).manual_seed(21)
            q = torch.randn(B, H, Sq, hd, generator=g, device=dev).to(dtype)
            k = torch.randn(B, KV, Skv, hd, generator=g, device=dev).to(dtype)
            v = torch.randn(B, KV, Skv, hd, generator=g, device=dev).to(dtype)
            with torch.inference_mode():
                got = flash_attention_kernel(q, k, v, causal=True, window=window, softcap=cap,
                                             q_offset=off)
                want = attention_ref(q, k, v, True, window, cap, q_offset=off)
            sync()
            err = (got.float() - want.float()).abs().max().item()
            rel = row_rel_err(got, want)
            check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                  f"{name} {dt}: offset kernel vs plain max abs err {err} (tol {tol})")
            check(rel <= ROW_REL_TOL, f"{name} {dt}: per-row error {rel} (tol {ROW_REL_TOL})")
            timed = ""
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=True, window=window,
                                                            softcap=cap, q_offset=off), 20)
                bound_s, by = kernel_bound(flash_attention_cost(q, k, v, True, window,
                                                                q_offset=off))
                timed = f"; {ms:.4f} ms, bound {1e3 * bound_s:.4f} ms ({by}) {card}"
            print(f"  flash q_offset {name}: B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} "
                  f"offset={off} hd={hd} window={window} softcap={cap} {dt}: max abs err "
                  f"{err:.3e} (tol {tol}), row {rel:.3e} (tol {ROW_REL_TOL}){timed}")
            del q, k, v, got, want
    torch.cuda.empty_cache()
    cells = []
    for i, (arch, layers, B, S, shape, names) in enumerate(P21_CELLS):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        cells.append((arch, layers, B, S, shape, mesh_plan_kwargs(cfg, B, S, shape[1], names),
                      210 + i))
    n = P21_WORLD[0] * P21_WORLD[1]
    t0 = time.perf_counter()
    ranks = run_ranks(p21_rank, P21_WORLD, P21_AXES, cells, P21_STEPS, device="cuda",
                      threads=2)
    print(f"  {n} ranks ran every cell in {time.perf_counter() - t0:.1f} s (start, init, "
          f"one-rank references, every plan)")
    mesh_launches = None
    for i, (arch, layers, B, S, shape, plans, _) in enumerate(cells):
        full = get_config(arch)
        print(f"  {arch} full width, layers {full.n_layers}→{layers}, bf16, B={B} x S={S} on a "
              f"{shape} (data, model) mesh: {n} ranks sharing one card over gloo")
        for name, kw in plans.items():
            per = [r[i][name] for r in ranks]
            wall = max(p["wall_s"] for p in per)
            print(f"  {name} {kw}: prefill wall {wall * 1e3:.1f} ms (slowest rank), "
                  f"{P21_STEPS} decode steps {max(p['decode_s'] for p in per) * 1e3:.1f} ms; "
                  f"max abs err vs one rank: prefill {max(p['err'] for p in per):.3e} "
                  f"(scale {per[0]['scale']:.3e}), decode "
                  f"{max(p['decode_err'] for p in per):.3e}; flash launches a rank "
                  f"{per[0]['launches']}; {n} ranks sharing one card over gloo {card}")
            print(f"    collectives a rank (result bytes by kind, = the dry-run's count): "
                  f"{json.dumps(per[0]['bytes_by_kind'])} calls "
                  f"{json.dumps(per[0]['count_by_kind'])}")
            print("    prefill memory rise a rank (measured / dry-run temp): " + ", ".join(
                f"r{r} {p['rise'] / 2**30:.3f} / {p['pred_temp'] / 2**30:.3f} GiB"
                for r, p in enumerate(per))
                + f"; dry-run peak {per[0]['pred_peak'] / 2**30:.3f} GiB (args "
                  f"{per[0]['args'] / 2**30:.3f})")
            if arch == "granite-3-8b" and shape == (1, 4) and name == "WSP":
                mesh_launches = per[0]["launches"]
    print(f"  phase 21: {time.perf_counter() - t_phase:.1f} s")
    return mesh_launches


def p22_expected_calls(cfg, shape: tuple, stage: int, n_micro: int, mb: int, S: int,
                       train: bool, dt: int = 2) -> dict:
    """{(kind, axis, tag): [calls, bytes]} of one rank's pipelined forward or
    train step on a (stage, data) ``shape``, counted from the shapes: per
    stage boundary ``n_micro`` forward edges (and in training ``n_micro``
    gradient edges) of ``mb / n_data x S x d`` values, the hidden states'
    all-reduce over ``stage``; in training the gradients' all-reduces over
    ``data`` (the stage's layers, each an attention block with a gated FFN,
    the final norm and the head; stage 0 also the embedding lookup's part),
    the lookup's part over ``stage`` and the loss."""
    ns, nd = shape
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    act = (mb // nd) * S * d * dt
    calls = {}
    if stage > 0:
        calls[("collective-permute", "stage", "fwd")] = [n_micro, n_micro * act]
    if ns > 1:
        calls[("all-reduce", "stage", "hidden")] = [1, n_micro * act]
    if not train:
        return calls
    if stage < ns - 1:
        calls[("collective-permute", "stage", "bwd")] = [n_micro, n_micro * act]
    table = cfg.padded_vocab * d * dt
    if nd > 1:
        layers = cfg.n_layers // ns
        weights = layers * [d * H * hd, d * KV * hd, d * KV * hd, H * hd * d, d * ff, ff * d,
                            d * ff] + [d * cfg.padded_vocab] + [cfg.padded_vocab * d] * (stage == 0)
        norms = 2 * layers + 1                   # ln1, ln2 a layer, final_ln: fp32
        calls[("all-reduce", "data", "grad")] = [len(weights) + norms,
                                                 sum(weights) * dt + norms * d * 4]
        calls[("all-reduce", "data", "loss")] = [1, 4]
    if ns > 1:
        calls[("all-reduce", "stage", "grad")] = [1, table]
    return calls


def p22_psum(mesh, shape: tuple, seed: int) -> dict:
    """(a) One rank's ``psum_compressed`` over the data axis, then the
    reference's formula reckoned on the host in numpy from every rank's
    gradient and residual (drawn again here from their seeds): the int8
    values under each rank's scale, their int32 sum, then this rank's mean
    ``sum * s / n`` and residual ``corrected - q * s`` (rounded once, as the
    reference's compiled form); both bit for bit."""
    import numpy as np
    import torch

    from repro_torch.runtime.compression import psum_compressed

    dev, n, me = mesh.device, mesh.shape["data"], mesh.index("data")

    def drawn(i):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        grad = (torch.randn(shape, generator=g, device=dev) * (0.01 * (i + 1))).bfloat16()
        return grad, 1e-4 * torch.randn(shape, generator=g, device=dev)

    grad, resid = drawn(me)
    mesh.comm.reset()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    mean, new_res = psum_compressed(grad, resid, "data", mesh.comm)
    sync()
    wall = time.perf_counter() - t0
    calls = dict(mesh.comm.calls)
    summed, mine = 0, None
    for i in range(n):
        g, r = (t.float().cpu().numpy() for t in drawn(i))
        corrected = g + r
        s = np.maximum(np.abs(corrected).max(), np.float32(1e-12)) / np.float32(127)
        q = np.clip(np.rint(corrected / s), -127, 127).astype(np.int32)
        summed = summed + q
        if i == me:
            mine = corrected, q, s
    corrected, q, s = mine
    want_mean = torch.from_numpy((summed.astype(np.float32) * s) / np.float32(n)).bfloat16()
    want_res = (corrected.astype(np.float64) - q.astype(np.float64) * np.float64(s)).astype(
        np.float32)
    exact = (torch.equal(mean.cpu(), want_mean)
             and np.array_equal(new_res.cpu().numpy(), want_res))
    check(exact, f"psum_compressed on data rank {me}: mean or residual differ from the host's "
                 f"reckoning (mean max abs diff "
                 f"{(mean.cpu().float() - want_mean.float()).abs().max().item()})")
    want_calls = {("all-reduce", "data", "psum_compressed"): [1, q.size * 4]}
    check(calls == want_calls, f"psum_compressed recorded {calls}, expected {want_calls}")
    return {"scale": float(s), "wall_s": wall, "int32_bytes": q.size * 4,
            "mean_head": mean.flatten()[:4].float().tolist()}


def p22_forward(mesh, cfg, n_micro: int, mb: int, S: int, seed: int, time_one_rank: bool) -> dict:
    """(b) One rank of a pipelined forward.  In turns, each rank builds the
    whole model from the seed, runs the one-rank forward of its rows of
    each microbatch, keeps those logits and its stage (``StageModel``) and
    drops the rest; with ``time_one_rank`` rank 0 also times the one-rank
    forward of the whole batch.  Then the pipelined forward twice: the
    first run's logits against the one-rank ones, its flash launches and
    collectives against a count from the shapes, both runs' walls."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.models import init_params
    from repro_torch.runtime.pipeline import StageModel, pipeline_forward

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ns, nd = mesh.shape["stage"], mesh.shape["data"]
    s, d = mesh.index("stage"), mesh.index("data")
    rows = slice(d * mb // nd, (d + 1) * mb // nd)
    tokens = torch.randint(0, cfg.vocab, (n_micro, mb, S),
                           generator=torch.Generator().manual_seed(seed + 1))
    ref, one_rank, stage = [], [], None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
            with torch.inference_mode():
                ref = [whole(tokens[m, rows].to(dev))[0] for m in range(n_micro)]
                if time_one_rank and mesh.rank == 0:
                    flat = tokens.reshape(-1, S).to(dev)
                    for _ in range(3):
                        sync()
                        t0 = time.perf_counter()
                        out = whole(flat)[0]
                        sync()
                        one_rank.append(time.perf_counter() - t0)
                        del out
            stage = StageModel(whole, ns, s)
            del whole
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    walls = []
    for run in range(2):
        sync()
        dist.barrier()
        flash_attention_kernel.launches = 0
        mesh.comm.reset()
        t0 = time.perf_counter()
        local = pipeline_forward(stage, tokens, mesh, ns)
        sync()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = flash_attention_kernel.launches
            calls = dict(mesh.comm.calls)
            check(tuple(local.shape) == (n_micro, mb // nd, S, cfg.padded_vocab)
                  and bool(torch.isfinite(local).all()),
                  f"pipelined logits {tuple(local.shape)} or non-finite")
            err = max((local[m] - ref[m]).abs().max().item() for m in range(n_micro))
            scale = max(r.abs().max().item() for r in ref)
            equal = all(torch.equal(local[m], ref[m]) for m in range(n_micro))
        del local
    where = f"{tuple(mesh.dims)} rank {mesh.rank} (stage {s}, data {d})"
    layers = len(stage.layers)
    want = p22_expected_calls(cfg, mesh.dims, s, n_micro, mb, S, False,
                              stage.embed.element_size())
    check(err <= P21_LOGIT_TOL * scale,
          f"{where}: pipelined logits max abs err {err} > {P21_LOGIT_TOL} x {scale}")
    check(calls == want, f"{where}: collectives {calls}, counted from the shapes {want}")
    if cuda:
        check(launches == layers * n_micro,
              f"{where}: {launches} flash launches, expected {layers} x {n_micro}")
    del stage, ref
    if cuda:
        torch.cuda.empty_cache()
    return {"walls_s": walls, "launches": launches, "calls": calls, "err": err, "scale": scale,
            "bit_equal": equal, "layers": layers, "one_rank_s": one_rank}


def p22_meta_peak(cfg, dims: tuple, coords: tuple, n_micro: int, mb: int, S: int,
                  lr: float) -> tuple[int, dict]:
    """(c)'s prediction for the rank at ``coords``: one train step of its
    stage on the meta device under the dry-run's storage tracker, the peak
    bytes (the stage's parameters, held before the step, plus the most the
    step holds above them) and the collectives it records."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.runtime.pipeline import StageModel, build_pipeline_train_step

    mesh = make_mesh(dims, P22_AXES, meta=True, coords=coords)
    stage = StageModel(init_params(cfg, None, "meta"), dims[0], coords[0])
    held = sum(dryrun.StorageTracker.rounded(p.untyped_storage().nbytes())
               for p in stage.parameters())
    tokens = torch.zeros((n_micro, mb, S), dtype=torch.int64)
    step = build_pipeline_train_step(cfg, mesh, dims[0], n_micro, lr)
    with dryrun.StorageTracker() as t:
        step(stage, {"tokens": tokens, "labels": tokens})
    return held + t.peak, dict(mesh.comm.calls)


def p22_train(mesh, cfg, n_micro: int, mb: int, S: int, steps: int, seed: int) -> dict:
    """(c) One rank of the pipelined SGD step.  The meta prediction of its
    peak first; then in turns each rank builds the model, runs the one-rank
    plain step (``loss_fn``, autograd, the same update) and keeps its
    stage's gradients and updated parameters on the host, and its stage.
    Then ``steps`` pipelined steps: the first against the plain one (loss,
    every gradient leaf, every parameter; the bounds above), its flash
    launches, collectives and peak; every step's loss finite and every
    gradient non-zero."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                            flash_attention_kernel)
    from repro_torch.models import init_params, loss_fn
    from repro_torch.runtime.pipeline import StageModel, build_pipeline_train_step

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ns, nd = mesh.shape["stage"], mesh.shape["data"]
    s, d = mesh.index("stage"), mesh.index("data")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (n_micro, mb, S), generator=gen)
    labels = torch.randint(0, cfg.vocab, (n_micro, mb, S), generator=gen)
    predicted, pred_calls = p22_meta_peak(cfg, mesh.dims, mesh.coords, n_micro, mb, S, P22_LR)
    plain, stage, plain_loss = {}, None, None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
            whole.train_params()
            stage = StageModel(whole, ns, s)
            mine = {id(p) for p in stage.parameters()}
            flat = list(whole.parameters())
            loss = loss_fn(whole, tokens.reshape(-1, S).to(dev), labels.reshape(-1, S).to(dev))
            grads = torch.autograd.grad(loss, flat)
            plain_loss = loss.item()
            with torch.no_grad():
                for p, g in zip(flat, grads):
                    if id(p) in mine:
                        new = (p.float() - P22_LR * g.float()).to(p.dtype)
                        plain[id(p)] = (g.cpu(), new.cpu())
            del whole, flat, grads, loss
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    step = build_pipeline_train_step(cfg, mesh, ns, n_micro, P22_LR)
    batch = {"tokens": tokens, "labels": labels}
    params = list(stage.parameters())
    held = sum(p.untyped_storage().nbytes() for p in params)
    if cuda:
        sync()
        base = torch.cuda.memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
    where = f"{tuple(mesh.dims)} rank {mesh.rank} (stage {s}, data {d})"
    walls, losses = [], []
    for i in range(steps):
        sync()
        dist.barrier()
        flash_attention_kernel.launches = flash_attention_bwd_kernel.launches = 0
        mesh.comm.reset()
        t0 = time.perf_counter()
        stage, loss = step(stage, batch)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), f"{where}: step {i} loss {losses[-1]}")
        zero = [n for n, p in stage.named_parameters() if not bool(p.grad.ne(0).any())]
        check(not zero, f"{where}: step {i}: zero gradients {zero}")
        if i:
            continue
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        launches = (flash_attention_kernel.launches, flash_attention_bwd_kernel.launches)
        calls = dict(mesh.comm.calls)
        worst = {"grad": 0.0, "grad_leaf": None, "param_excess": 0.0}
        bad = []
        with torch.no_grad():
            for name, p in stage.named_parameters():
                g_plain, p_plain = (t.to(dev) for t in plain[id(p)])
                gscale = g_plain.float().abs().max().item()
                gerr = (p.grad.float() - g_plain.float()).abs().max().item()
                bound = 2 ** -7 * p_plain.float().abs() + P22_LR * P22_GRAD_TOL * gscale
                excess = ((p.float() - p_plain.float()).abs() - bound).max().item()
                if gerr / gscale > worst["grad"]:
                    worst["grad"], worst["grad_leaf"] = gerr / gscale, name
                worst["param_excess"] = max(worst["param_excess"], excess)
                if gerr > P22_GRAD_TOL * gscale or excess > 0:
                    bad.append((name, gerr / gscale, excess))
                del g_plain, p_plain, bound
        check(not bad, f"{where}: first step's leaves out of bound against the one-rank step "
                       f"(name, grad err / scale, param excess): {bad[:5]}")
        check(abs(losses[0] - plain_loss) <= P22_LOSS_RTOL * abs(plain_loss),
              f"{where}: loss {losses[0]} vs the one-rank step's {plain_loss}")
    layers = len(stage.layers)
    want = p22_expected_calls(cfg, mesh.dims, s, n_micro, mb, S, True,
                              stage.embed.element_size())
    check(calls == want, f"{where}: collectives {calls}, counted from the shapes {want}")
    check(calls == pred_calls, f"{where}: collectives {calls}, the meta step's {pred_calls}")
    if cuda:
        check(launches == (layers * n_micro,) * 2,
              f"{where}: flash launches (forward, backward) {launches}, expected "
              f"{layers} x {n_micro} each")
    del stage, plain
    if cuda:
        torch.cuda.empty_cache()
    return {"walls_s": walls, "losses": losses, "plain_loss": plain_loss, "launches": launches,
            "calls": calls, "worst": worst, "peak": peak, "predicted": predicted,
            "layers": layers}


def p22_rank(world, specs: dict) -> dict:
    """One rank of phase 22 (a process of its own on the shared card): (a),
    (b) on each forward mesh, (c) on each training mesh, each mesh over the
    same processes; their results."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    def on(shape):
        return world if tuple(shape) == world.dims else make_mesh(shape, P22_AXES, world.device)

    out = {"psum": p22_psum(make_mesh((1, world.size), P22_AXES, world.device),
                            specs["psum_shape"], 220)}
    n_micro, mb, S = specs["batch"]
    out["forward"] = [p22_forward(on(shape), specs["forward_cfg"], n_micro, mb, S, 221, i == 0)
                      for i, shape in enumerate(specs["forward_meshes"])]
    if world.device.type == "cuda":
        torch.cuda.empty_cache()
    out["train"] = [p22_train(on(shape), specs["train_cfg"], n_micro, mb, S, steps, 222)
                    for shape, steps in specs["train"]]
    return out


def pipeline_phase(get_config, card: str) -> int:
    """Phase 22; returns the flash launches of one rank's pipelined prefill
    of granite-3-8b on the (4, 1) mesh (the phase's main path)."""
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    full = get_config(P22_ARCH)
    specs = {"batch": (P22_N_MICRO, P22_MB, P22_S), "psum_shape": P22_PSUM_SHAPE,
             "forward_cfg": full,
             "forward_meshes": P22_FWD_MESHES, "train": P22_TRAIN,
             "train_cfg": dataclasses.replace(full, n_layers=P22_TRAIN_LAYERS, remat=False)}
    print(f"phase 22: the merged pipeline (runtime/pipeline.py): {P22_ARCH}, B="
          f"{P22_N_MICRO * P22_MB} x S={P22_S} as {P22_N_MICRO} microbatches of {P22_MB} rows, "
          f"on (stage, data) meshes of 4 ranks sharing the card over gloo: every byte crosses "
          f"the host, so no time here is a multi-GPU time")
    return p22_report(run_ranks(p22_rank, P22_WORLD, P22_AXES, specs, device="cuda",
                                threads=2), specs, card, t_phase)


def p22_report(ranks: list, specs: dict, card: str, t_phase: float) -> int:
    """Print phase 22's readings from every rank's results; the cross-rank
    checks.  Returns the flash launches of rank 0's first forward mesh."""
    n_micro, mb, S = specs["batch"]
    psum = [r["psum"] for r in ranks]
    scales = [p["scale"] for p in psum]
    check(len(set(scales)) == len(scales), f"(a) the ranks' int8 scales do not differ: {scales}")
    print(f"  (a) psum_compressed over a data axis of {len(ranks)}, a {specs['psum_shape']} bf16 "
          f"gradient a rank: each rank's mean and residual bit-equal to the reference's formula "
          f"reckoned on the host (int32 sum, then sum * own scale / n); scales "
          f"{[f'{x:.6e}' for x in scales]}, so the means differ ({[p['mean_head'][0] for p in psum]}"
          f" first element); int32 bytes moved a rank {psum[0]['int32_bytes']} (recorded); wall "
          f"{max(p['wall_s'] for p in psum) * 1e3:.1f} ms {card}")
    cfg = specs["forward_cfg"]
    for i, shape in enumerate(specs["forward_meshes"]):
        per = [r["forward"][i] for r in ranks]
        walls = [max(p["walls_s"][k] for p in per) for k in range(2)]
        print(f"  (b) {cfg.name} full size ({cfg.n_layers} layers, {cfg.param_dtype}) on (stage, data) "
              f"{shape}: {per[0]['layers']} layers a stage, {n_micro + shape[0] - 1} beats; "
              f"pipelined forward wall {walls[0] * 1e3:.1f} / {walls[1] * 1e3:.1f} ms (runs 1 / "
              f"2, slowest rank); logits vs the one-rank forward of each rank's rows: max abs "
              f"err {max(p['err'] for p in per):.3e} (bound {P21_LOGIT_TOL} x "
              f"{max(p['scale'] for p in per):.3e}), bit-equal on "
              f"{sum(p['bit_equal'] for p in per)} of {len(per)} ranks; flash launches a rank "
              f"{[p['launches'] for p in per]}; {len(ranks)} ranks sharing one card over gloo "
              f"{card}")
        for r, p in enumerate(per):
            print(f"    rank {r} collectives (result bytes, = the count from the shapes): "
                  + json.dumps({f"{k}/{a}/{t}": v for (k, a, t), v in p["calls"].items()}))
        if i == 0 and per[0]["one_rank_s"]:
            print(f"    one rank's {cfg.n_layers}-layer forward of the whole B="
                  f"{n_micro * mb} x S={S} (no pipeline, no host hop), 3 runs: "
                  + ", ".join(f"{w * 1e3:.1f}" for w in per[0]["one_rank_s"]) + f" ms {card}")
    tcfg = specs["train_cfg"]
    print(f"  (c) SGD steps (lr {P22_LR}), {tcfg.name} full width, reduced: n_layers "
          f"{cfg.n_layers}→{tcfg.n_layers} (the meta sizing: the 4 ranks' steps, and one rank's "
          f"plain step beside the other stages, fit the card), {tcfg.param_dtype}, "
          f"B={n_micro * mb} x S={S}, no remat; bounds: each "
          f"gradient leaf within {P22_GRAD_TOL} of its largest element, the loss within "
          f"{P22_LOSS_RTOL:.4g} of its value, each parameter within one bf16 ulp + lr x that")
    for i, (shape, steps) in enumerate(specs["train"]):
        per = [r["train"][i] for r in ranks]
        print(f"  (c) {shape}: {per[0]['layers']} layers a stage, {steps} step(s): step walls "
              + ", ".join(f"{max(p['walls_s'][k] for p in per) * 1e3:.1f}" for k in range(steps))
              + f" ms (slowest rank); losses {per[0]['losses']} (one-rank step "
              f"{per[0]['plain_loss']:.6f}); worst gradient err / scale "
              + ", ".join(f"r{r} {p['worst']['grad']:.3e} ({p['worst']['grad_leaf']})"
                          for r, p in enumerate(per))
              + f"; worst parameter excess over its "
              f"bound {max(p['worst']['param_excess'] for p in per):.3e}; flash launches a rank "
              f"(forward, backward) {[p['launches'] for p in per]}; {len(ranks)} ranks sharing "
              f"one card over gloo {card}")
        for r, p in enumerate(per):
            kinds = {}
            for (k, a, t), (n, b) in p["calls"].items():
                kinds[f"{k}/{a}/{t}"] = [n, b]
            print(f"    rank {r}: peak predicted {p['predicted']} B ({p['predicted'] / 2**30:.3f} "
                  f"GiB), measured {p['peak']} B ({p['peak'] / 2**30:.3f} GiB); collectives "
                  f"(= the count from the shapes and the meta step's): {json.dumps(kinds)}")
    print(f"  phase 22: {time.perf_counter() - t_phase:.1f} s")
    return ranks[0]["forward"][0]["launches"]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {Path(__file__).name}: run from a checkout",
              file=sys.stderr)
        return 2
    # phase 15(e) replays training bit for bit: cuBLAS is deterministic only
    # with a fixed workspace, which must be set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                            flash_attention_cost,
                                                            flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba.kernel import (mamba_scan_bwd_kernel, mamba_scan_cost,
                                                  mamba_scan_kernel)
    from repro_torch.kernels.mamba.ref import mamba_scan_ref
    from repro_torch.kernels.qmatmul.kernel import qmatmul_cost, qmatmul_kernel, tma_path
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref, quantize_cols, quantize_rows
    from repro_torch.kernels.rwkv6.kernel import wkv6_bwd_kernel, wkv6_cost, wkv6_kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.launch.hlo_analysis import HwConstants, kernel_bound
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params
    from repro_torch.runtime.planner import plan_for_cell
    from repro_torch.runtime.serve import build_prefill_step

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    hw = HwConstants()
    check((hw.peak_flops, hw.int8_ops, hw.fp32_flops, hw.hbm_bw)
          == (BF16_PEAK_FLOPS, INT8_PEAK_OPS, FP32_PEAK_FLOPS, HBM_BYTES_PER_S),
          "the script's peaks are not the dry-run's (launch/hlo_analysis.py HwConstants)")

    def reset_launches() -> None:
        flash_attention_kernel.launches = flash_attention_bwd_kernel.launches = 0
        wkv6_kernel.launches = wkv6_bwd_kernel.launches = 0
        mamba_scan_kernel.launches = mamba_scan_bwd_kernel.launches = 0
        qmatmul_kernel.launches = 0

    # ------------------------------------------------------------ phase 1
    smi = nvidia_smi_line()
    card = f"[{smi}]"
    print(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:     # one nvcc per source
        took = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    print("kernel build: " + ", ".join(f"{src} {t:.3f} s" for src, t in took.items())
          + f" (wall {time.perf_counter() - t0:.3f} s, in parallel)")
    fwd_smem = _build.load_library("flash_attention.cu").repro_flash_attention_smem_bytes
    fwd_smem.argtypes = [ctypes.c_int]                                # head dim
    bwd_smem = _build.load_library("flash_attention_bwd.cu").repro_flash_attention_bwd_smem_bytes
    bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]                  # head dim, dk/dv kernel
    smem = {"wkv6_segment": _build.load_library("wkv6.cu").repro_wkv6_smem_bytes}
    smem["wkv6_segment"].argtypes = [ctypes.c_int, ctypes.c_int]      # head dim, output pass
    smem["wkv6_bwd_sweep"] = _build.load_library("wkv6_bwd.cu").repro_wkv6_bwd_smem_bytes
    smem["wkv6_bwd_sweep"].argtypes = [ctypes.c_int, ctypes.c_int]    # head dim, pass
    scan_bwd_smem = _build.load_library("mamba_scan_bwd.cu").repro_mamba_scan_bwd_smem_bytes
    scan_bwd_smem.argtypes = [ctypes.c_int] * 3                       # state size, x, out dtype
    qmm_smem = _build.load_library("qmatmul.cu").repro_qmatmul_smem_bytes
    qmm_smem.argtypes = []
    for fn in (*smem.values(), qmm_smem, fwd_smem, bwd_smem, scan_bwd_smem):
        fn.restype = ctypes.c_longlong
    smem["mamba_scan_bwd_chunk"] = lambda n, x_bf16, f32_out: scan_bwd_smem(
        n, x_bf16, x_bf16 and not f32_out)
    smem["qmatmul_tma"] = lambda *_: qmm_smem()                       # one size for both outputs
    smem["fa_fwd_bf16"] = lambda hd, stats: fwd_smem(hd)              # both instantiations
    smem["fa_bwd_dq_bf16"] = lambda hd: bwd_smem(hd, 0)
    smem["fa_bwd_dkdv_bf16"] = lambda hd, resid: bwd_smem(hd, 1)
    spills = {}
    for src in KERNEL_SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            for name, regs, spill in ptxas_report(log.read_text()):
                spills[name] = spill
                base = name.split("<")[0]
                targs = [int(a) if a.isdigit() else int(a in ("true", "__nv_bfloat16"))
                         for a in name.split("<")[-1].rstrip(">").split(", ")]
                dyn = (f", {smem[base](*targs)} bytes dynamic shared memory"
                       if base in smem else "")
                print(f"  ptxas {src} {name}: {regs}{dyn}; {spill or 'no spill report'}")
            for line in log.read_text().splitlines():
                if "Potential Performance Loss" in line:
                    print(f"  ptxas {src}: {line.split('info    :')[-1].strip()[:160]}")
    # The bf16 flash kernel and the qmatmul_tma kernel must run on wgmma and
    # TMA: count both in their SASS.
    counts = sass_counts(_build.library_path("flash_attention.cu"))
    bf16 = {k: v for k, v in counts.items() if k.startswith("fa_fwd_bf16")}
    print("  SASS of flash_attention.cu (HGMMA, UTMALDG): " + ", ".join(
        f"{k} {v['HGMMA']}, {v['UTMALDG']}" for k, v in sorted(bf16.items())))
    check(len(bf16) == 6 and all(v["HGMMA"] > 0 and v["UTMALDG"] > 0 for v in bf16.values()),
          f"bf16 flash kernels without wgmma (HGMMA) or TMA (UTMALDG) in their SASS: {bf16}")
    counts = sass_counts(_build.library_path("qmatmul.cu"))
    tma = {k: v for k, v in counts.items() if k.startswith("qmatmul_tma")}
    print("  SASS of qmatmul.cu (IGMMA, UTMALDG, UTMASTG): " + ", ".join(
        f"{k} {v['IGMMA']}, {v['UTMALDG']}, {v['UTMASTG']}" for k, v in sorted(counts.items())))
    check(len(tma) == 4 and all(v["IGMMA"] > 0 and v["UTMALDG"] > 0 for v in tma.values()),
          f"qmatmul_tma kernels without int8 wgmma (IGMMA) or TMA (UTMALDG) in their SASS: {tma}")
    check(all("0 bytes spill stores, 0 bytes spill loads" in spills.get(k, "") for k in tma),
          f"qmatmul_tma kernels spill: { {k: spills.get(k) for k in tma} }")
    # The WKV-6 backward's fp64 instructions by kernel (its S and G sweeps
    # run in float64 for dlogw's accuracy; a fact, not a check).
    counts = sass_counts(_build.library_path("wkv6_bwd.cu"))
    print("  SASS of wkv6_bwd.cu (DFMA, DMUL, DADD): " + ", ".join(
        f"{k} {v['DFMA']}, {v['DMUL']}, {v['DADD']}" for k, v in sorted(counts.items())))
    # The scan backward stages its ring and stores ddt / dx by TMA (UTMALDG,
    # UTMASTG) and must not spill: its sweep holds 128 registers a thread.
    counts = sass_counts(_build.library_path("mamba_scan_bwd.cu"))
    chunk = {k: v for k, v in counts.items() if k.startswith("mamba_scan_bwd_chunk")}
    print("  SASS of mamba_scan_bwd.cu (UTMALDG, UTMASTG, DADD): " + ", ".join(
        f"{k} {v['UTMALDG']}, {v['UTMASTG']}, {v['DADD']}" for k, v in sorted(chunk.items())))
    check(len(chunk) == 9 and all(v["UTMALDG"] > 0 and v["UTMASTG"] > 0 for v in chunk.values()),
          f"scan backward kernels without TMA (UTMALDG, UTMASTG) in their SASS: {chunk}")
    check(all("0 bytes spill stores, 0 bytes spill loads" in spills.get(k, "") for k in chunk),
          f"scan backward kernels spill: { {k: spills.get(k) for k in chunk} }")
    # The bf16 backward at hd 64 and 128 must run on wgmma and TMA; at hd 256
    # it keeps mma.sync.
    counts = sass_counts(_build.library_path("flash_attention_bwd.cu"))
    print("  SASS of flash_attention_bwd.cu (HGMMA, UTMALDG, HMMA): " + ", ".join(
        f"{k} {v['HGMMA']}, {v['UTMALDG']}, {v['HMMA']}" for k, v in sorted(counts.items())))
    wg_bwd = {k: v for k, v in counts.items() if k.startswith(("fa_bwd_dq_bf16", "fa_bwd_dkdv_bf16"))}
    check(len(wg_bwd) == 6 and all(v["HGMMA"] > 0 and v["UTMALDG"] > 0 for v in wg_bwd.values()),
          f"bf16 flash backward kernels at hd 64 / 128 without wgmma (HGMMA) or TMA (UTMALDG) "
          f"in their SASS: {wg_bwd}")
    mma_bwd = {k: v for k, v in counts.items()
               if k.startswith(("fa_bwd_dq<", "fa_bwd_dkdv<")) and "bfloat16" in k}
    check(len(mma_bwd) == 2 and all(v["HMMA"] > 0 for v in mma_bwd.values()),
          f"bf16 flash backward kernels at hd 256 without mma.sync (HMMA): {mma_bwd}")

    # ------------------------------------------------------------ phase 2
    print("phase 2: flash_attention kernel vs plain version on the card")
    results = {}
    for name, B, H, KV, S, hd, causal, window, cap, dt in FA_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
        out = flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=cap)
        ref = attention_ref(q, k, v, causal, window, cap)
        sync()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
              f"{name}: kernel vs plain max abs err {err} (tol {tol})")
        check(rel <= ROW_REL_TOL,
              f"{name}: kernel vs plain per-row error {rel} / rms (tol {ROW_REL_TOL})")
        del out, ref
        big = B * H * S * S > 2 ** 28
        ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=causal, window=window,
                                                    softcap=cap), 10 if big else 50)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal, window, cap), 2 if big else 10)
        library_ms = None
        if cap == 0.0:      # SDPA has no softcap; windows go in as a boolean mask
            mask = None
            if window > 0:
                pos = torch.arange(S, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=H != KV), 10 if big else 50)
        bound_s, bound_by = kernel_bound(flash_attention_cost(q, k, v, causal, window))
        results[name] = {
            "max_abs_err": err, "row_rel_err": rel, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
        }
        print(f"  {name}: B={B} H={H} KV={KV} S={S} hd={hd} causal={causal} "
              f"window={window} softcap={cap} {dt}: tol {tol}, row tol {ROW_REL_TOL} {json.dumps(results[name])} "
              f"{card}")
        del q, k, v
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 3
    cfg = get_config("granite-3-8b")
    print(f"phase 3: {cfg.name} full width and depth ({cfg.n_layers} layers), bf16")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    # The DSE branch, as Solution.deploy plans a one-chip package: the model
    # axis is one chip, priced with the reference's TPU v5e cost model.
    plan = plan_for_cell(cfg, S, B, ("data", "model"), 1, kind="prefill")
    check(plan.meta["dse"] and (plan.p1, plan.p2) == ("ISP", "ISP"),
          f"DSE plan {plan.p1}/{plan.p2} meta {plan.meta}")
    print(f"  DSE plan (model_axis 1): p1 {plan.p1}, p2 {plan.p2}, t_layers "
          f"{plan.meta['t_layers']}, cost-model latency {plan.meta['latency']} s "
          f"(TPU v5e constants, not this card), dse_s {plan.meta['dse_s']:.6f} s (host)")
    prefill = build_prefill_step(cfg, plan, dev)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = prefill(model, tokens)
    sync()
    launches = flash_attention_kernel.launches
    check(launches == cfg.n_layers,
          f"{launches} flash-attention launches in one prefill, expected {cfg.n_layers}")
    check(wkv6_kernel.launches == mamba_scan_kernel.launches == qmatmul_kernel.launches == 0,
          "wkv6 / mamba_scan / qmatmul launched in a granite prefill")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    granite_prefill_ms = statistics.median(times)
    check(flash_attention_kernel.launches == 4 * cfg.n_layers, "launches over 4 prefills")
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3), "
          f"{launches} kernel launches per call, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    print(f"  prefill traced: {prefill_breakdown(prefill, model, tokens, ('fa_fwd',), sync)} {card}")
    launcher_flow(serve, cfg, model, card)
    # One step of the same decode flow, counted and traced.
    prof = decode_step_profile(cfg, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 4
    cfg4 = dataclasses.replace(cfg, n_layers=4, param_dtype="float32")
    print(f"phase 4: prefill vs decode, {cfg.name} full width, fp32, TF32 off")
    print(f"  reduced: n_layers {cfg.n_layers}→{cfg4.n_layers}")
    model = init_params(cfg4, torch.Generator(device=dev).manual_seed(2), dev)
    B, S = 2, 100
    tokens = torch.randint(0, cfg4.vocab, (B, S), generator=torch.Generator().manual_seed(3))
    plan = plan_for_cell(cfg4, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    flash_attention_kernel.launches = 0
    logits_p = build_prefill_step(cfg4, plan, dev)(model, tokens)
    check(flash_attention_kernel.launches == cfg4.n_layers, "fp32 prefill launches")
    logits_d, caches = decode_token_by_token(cfg4, model, tokens, dev)
    scale = logits_p.abs().max().item()
    err = (logits_p - logits_d).abs().max().item()
    # fp32 throughout: the two paths differ only in summation order (flash
    # tiles vs one softmax over the cache; cuBLAS at M=B*S vs M=B), which
    # leaves ~1e-6 relative; 1e-3 of the logit scale flags any wrong mask,
    # position or cache entry, which moves logits by O(1).
    tol = 1e-3 * scale
    check(err <= tol, f"prefill vs decode logits: max abs err {err} > {tol}")
    print(f"  B={B} S={S}: max |prefill - decode| {err:.3e} (tol 1e-3 x max|logit| "
          f"= {tol:.3e})")
    del model, caches, logits_p, logits_d
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 5
    gcfg = get_config("gemma2-9b")
    cfg5 = dataclasses.replace(gcfg, n_layers=2)
    print(f"phase 5: {gcfg.name} full width, bf16, layers {cfg5.block_kinds()}")
    print(f"  reduced: n_layers {gcfg.n_layers}→{cfg5.n_layers}")
    model = init_params(cfg5, torch.Generator(device=dev).manual_seed(4), dev)
    B, S, steps = 1, 8192, 8
    tokens = torch.randint(0, cfg5.vocab, (B, S), generator=torch.Generator().manual_seed(5))
    flash_attention_kernel.launches = 0
    out = decode_from_prefill(cfg5, model, tokens, steps, dev, sync)
    check(flash_attention_kernel.launches == cfg5.n_layers, "gemma2 prefill launches")
    print(f"  prefill S={S} ({flash_attention_kernel.launches} kernel launches), "
          f"{steps} decode steps: tokens {out[0].tolist()}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 6
    print("phase 6: wkv6 kernel vs plain version on the card (fp32)")
    wkv_results = {}
    for name, B, H, S, hd, strong in WKV_CASES:
        args = wkv_inputs(dev, B, H, S, hd, strong=strong)
        out = wkv6_kernel(*args)
        ref = wkv6_ref(*args)
        sync()
        check(bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()),
              f"{name}: {int((~torch.isfinite(out[0])).sum())} non-finite outputs")
        errs, rels = [], []
        for what, o, rf in (("out", out[0], ref[0]), ("S_last", out[1], ref[1])):
            err = (o - rf).abs().max().item()
            rel = row_rel_err(o, rf)
            check(torch.allclose(o, rf, rtol=WKV_TOL, atol=WKV_TOL),
                  f"{name}: kernel vs plain {what} max abs err {err} (tol {WKV_TOL})")
            check(rel <= WKV_ROW_REL_TOL,
                  f"{name}: kernel vs plain {what} per-row error {rel} / rms "
                  f"(tol {WKV_ROW_REL_TOL})")
            errs.append(err)
            rels.append(rel)
        rounding = ""
        if name in (WKV_MAIN_PATH_CASE, "rwkv_prefill_strong"):
            # How far fp32 rounding alone moves the plain version: the same
            # recurrence in float64 as the yardstick for both (max abs error;
            # worst row error / row rms).
            ref64 = wkv6_ref(*(a.double() for a in args))
            rounding = "; vs the fp64 plain version: " + ", ".join(
                f"{who} {what} {(o.double() - r64).abs().max().item():.3e} / "
                f"{row_rel_err(o, r64):.3e}"
                for who, got in (("fp32 plain", ref), ("kernel", out))
                for what, o, r64 in (("out", got[0], ref64[0]), ("S_last", got[1], ref64[1])))
            del ref64
        del out, ref
        big = B * H * S > 2 ** 16
        ms = cuda_ms(lambda: wkv6_kernel(*args), 20 if big else 50)
        plain_ms = cuda_ms(lambda: wkv6_ref(*args), 2 if big else 5)
        bound_s, bound_by = kernel_bound(wkv6_cost(*args))      # chunk form at 32 tokens
        wkv_results[name] = {
            "max_abs_err": max(errs), "row_rel_err": max(rels), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
        }
        print(f"  {name}: B={B} H={H} S={S} hd={hd}"
              f"{', strong decays' if strong else ''}: tol {WKV_TOL}, row tol "
              f"{WKV_ROW_REL_TOL} (out, S_last) {json.dumps(wkv_results[name])}{rounding} {card}")
        del args
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 7
    rcfg = get_config("rwkv6-3b")
    print(f"phase 7: {rcfg.name} full width and depth ({rcfg.n_layers} layers), bf16")
    t0 = time.perf_counter()
    model = init_params(rcfg, torch.Generator(device=dev).manual_seed(6), dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(rcfg, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(rcfg, plan, dev)
    tokens = torch.randint(0, rcfg.vocab, (B, S), generator=torch.Generator().manual_seed(7))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = prefill(model, tokens)
    sync()
    wkv_launches = wkv6_kernel.launches
    check(wkv_launches == rcfg.n_layers,
          f"{wkv_launches} wkv6 launches in one prefill, expected {rcfg.n_layers}")
    check(flash_attention_kernel.launches == mamba_scan_kernel.launches
          == qmatmul_kernel.launches == 0,
          "flash attention / mamba_scan / qmatmul launched in an rwkv prefill")
    check(tuple(logits.shape) == (B, S, rcfg.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite rwkv prefill logits")
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    check(wkv6_kernel.launches == 4 * rcfg.n_layers, "wkv6 launches over 4 prefills")
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {wkv_launches} kernel launches per call, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    print(f"  prefill traced: {prefill_breakdown(prefill, model, tokens, ('wkv6_',), sync)} "
          f"{card}")

    # the prefill's collected state, then 8 decode steps from it
    P, steps = 512, 8
    wkv6_kernel.launches = 0
    out = decode_from_prefill(rcfg, model, tokens[:, :P], steps, dev, sync)
    check(wkv6_kernel.launches == rcfg.n_layers, "rwkv collect-cache prefill launches")
    print(f"  prefill S={P} with the state collected, {steps} decode steps from it: "
          f"tokens {out[0].tolist()}")
    launcher_flow(serve, rcfg, model, card)
    prof = decode_step_profile(rcfg, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 8
    cfg8 = dataclasses.replace(rcfg, n_layers=4, param_dtype="float32")
    print(f"phase 8: prefill vs decode, {rcfg.name} full width, fp32, TF32 off")
    print(f"  reduced: n_layers {rcfg.n_layers}→{cfg8.n_layers}")
    model = init_params(cfg8, torch.Generator(device=dev).manual_seed(8), dev)
    B, S = 2, 100
    tokens = torch.randint(0, cfg8.vocab, (B, S), generator=torch.Generator().manual_seed(9))
    wkv6_kernel.launches = 0
    with torch.inference_mode():
        logits_p, pre_caches = model(tokens.to(dev), collect_cache=True)
    check(wkv6_kernel.launches == cfg8.n_layers, "fp32 rwkv prefill launches")
    logits_d, caches = decode_token_by_token(cfg8, model, tokens, dev)
    check(wkv6_kernel.launches == cfg8.n_layers, "decode launched the wkv6 kernel")
    # fp32 throughout: the two paths differ in summation order (the kernel's
    # chunk form vs the one-step recurrence; cuBLAS at M=B*S vs M=B), which
    # leaves ~1e-6 relative; 1e-3 of each tensor's scale flags a wrong decay,
    # state handoff or token shift, which moves results by O(1).
    report = []
    pairs = [("logits", logits_p, logits_d)] + [
        (n, pre_caches[0][n], caches[0][n]) for n in ("S", "shift", "shift_ffn")]
    for n, a, b in pairs:
        scale = a.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= 1e-3 * scale, f"prefill vs decode {n}: max abs err {err} > "
                                   f"1e-3 x {scale}")
        report.append(f"{n} {err:.3e} (tol {1e-3 * scale:.3e})")
    worst_t = int((logits_p - logits_d).abs().amax(dim=(0, 2)).argmax())
    print(f"  B={B} S={S}: max |prefill - decode| " + ", ".join(report)
          + f" (tol 1e-3 x max|x|); worst logit at position {worst_t}")
    del model, caches, pre_caches, logits_p, logits_d
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 9
    print("phase 9: mamba_scan kernel vs plain version on the card")
    mamba_results = {}
    for name, B, S, di, N, dt_name, model_layout in MAMBA_CASES:
        dtype = getattr(torch, dt_name)
        args = mamba_inputs(dev, B, S, di, N, dtype, model_layout)
        out = mamba_scan_kernel(*args)
        ref = mamba_scan_ref(*args)
        sync()
        errs, rels = [], []
        for what, o, rf in (("y", out[0], ref[0]), ("h_last", out[1], ref[1])):
            err = (o - rf).abs().max().item()
            rel = row_rel_err(o, rf)
            check(torch.allclose(o, rf, rtol=MAMBA_TOL, atol=MAMBA_TOL),
                  f"{name}: kernel vs plain {what} max abs err {err} (tol {MAMBA_TOL})")
            check(rel <= MAMBA_ROW_REL_TOL,
                  f"{name}: kernel vs plain {what} per-row error {rel} / rms "
                  f"(tol {MAMBA_ROW_REL_TOL})")
            errs.append(err)
            rels.append(rel)
        rounding = ""
        if name == MAMBA_MAIN_PATH_CASE:
            # How far fp32 rounding alone moves the plain version: the same
            # recurrence in float64 as the yardstick for both.
            ref64 = mamba_scan_ref(*(a.double() for a in args))
            rounding = "; vs the fp64 plain version: " + ", ".join(
                f"{who} {what} {(o.double() - r64).abs().max().item():.3e} / "
                f"{row_rel_err(o, r64):.3e}"
                for who, got in (("fp32 plain", ref), ("kernel", out))
                for what, o, r64 in (("y", got[0], ref64[0]), ("h_last", got[1], ref64[1])))
            del ref64
        del out, ref
        big = B * S * di > 2 ** 22
        ms = cuda_ms(lambda: mamba_scan_kernel(*args), 20 if big else 50)
        plain_ms = cuda_ms(lambda: mamba_scan_ref(*args), 2 if big else 5)
        bound_s, bound_by = kernel_bound(mamba_scan_cost(*args))
        mamba_results[name] = {
            "max_abs_err": max(errs), "row_rel_err": max(rels), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * bound_s, "bound_by": bound_by,
        }
        if name == MAMBA_MAIN_PATH_CASE:
            # A second floor beside bound_ms: one exponential per state
            # update on the special-function unit, at the SM clock the card
            # reports as its maximum (the clock under load beside it).
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            clk = [float(v) for v in subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm,clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True, text=True,
                check=True, timeout=60).stdout.split(",")]
            mamba_results[name]["context"] = {
                "exponentials": B * S * di * N, "sms": sms, "sm_clock_max_mhz": clk[0],
                "sm_clock_now_mhz": clk[1],
                "exp_floor_ms": 1e3 * B * S * di * N / (sms * SFU_EXP2_PER_CLOCK * clk[0] * 1e6),
            }
        print(f"  {name}: B={B} S={S} di={di} N={N} x {dt_name}"
              f"{', B/C strided views' if model_layout else ''}: tol {MAMBA_TOL}, row tol "
              f"{MAMBA_ROW_REL_TOL} (y, h_last) {json.dumps(mamba_results[name])}{rounding} "
              f"{card}")
        del args
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 10
    jcfg = get_config("jamba-v0.1-52b")
    cfg10 = dataclasses.replace(jcfg, n_layers=16)
    n_mamba = cfg10.block_kinds().count("mamba")
    n_attn = cfg10.n_layers - n_mamba
    print(f"phase 10: {jcfg.name} full width, bf16, {cfg10.n_layers} layers "
          f"({n_mamba} mamba, {n_attn} attention, MoE on every second layer)")
    print(f"  reduced: n_layers {jcfg.n_layers}→{cfg10.n_layers}")
    t0 = time.perf_counter()
    model = init_params(cfg10, torch.Generator(device=dev).manual_seed(10), dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  init {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(cfg10, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(cfg10, plan, dev)
    tokens = torch.randint(0, cfg10.vocab, (B, S), generator=torch.Generator().manual_seed(11))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = prefill(model, tokens)
    sync()
    mamba_launches = mamba_scan_kernel.launches
    check(mamba_launches == n_mamba == 14,
          f"{mamba_launches} mamba_scan launches in one prefill, expected 14")
    check(flash_attention_kernel.launches == n_attn == 2,
          f"{flash_attention_kernel.launches} flash launches in one prefill, expected 2")
    check(wkv6_kernel.launches == qmatmul_kernel.launches == 0,
          "wkv6 / qmatmul launched in a jamba prefill")
    check(tuple(logits.shape) == (B, S, cfg10.padded_vocab), f"logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite jamba prefill logits")
    first = logits[:, ::64].clone()
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    check(mamba_scan_kernel.launches == 4 * n_mamba, "mamba_scan launches over 4 prefills")
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {mamba_launches} mamba_scan and "
          f"{n_attn} flash launches per call, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    check_reproducible(prefill, model, tokens, first, "jamba")
    print("  prefill traced: "
          f"{prefill_breakdown(prefill, model, tokens, ('mamba_scan_fwd', 'fa_fwd'), sync)} "
          f"{card}")
    out = decode_from_prefill(cfg10, model, tokens[:, :512], 8, dev, sync)
    print(f"  prefill S=512 with the state collected, 8 decode steps from it: "
          f"tokens {out[0].tolist()}")
    launcher_flow(serve, cfg10, model, card)
    prof = decode_step_profile(cfg10, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 11
    cfg11 = dataclasses.replace(jcfg, n_layers=8, param_dtype="float32")
    print(f"phase 11: prefill vs decode, {jcfg.name} full width, fp32, TF32 off")
    print(f"  reduced: n_layers {jcfg.n_layers}→{cfg11.n_layers}")
    model = init_params(cfg11, torch.Generator(device=dev).manual_seed(12), dev)
    B, S = 2, 100
    tokens = torch.randint(0, cfg11.vocab, (B, S), generator=torch.Generator().manual_seed(13))
    mamba_scan_kernel.launches = flash_attention_kernel.launches = 0
    with torch.inference_mode():
        logits_p, pre_caches = model(tokens.to(dev), collect_cache=True)
    check(mamba_scan_kernel.launches == 7 and flash_attention_kernel.launches == 1,
          "fp32 jamba prefill launches")
    logits_d, caches = decode_token_by_token(cfg11, model, tokens, dev)
    check(mamba_scan_kernel.launches == 7, "decode launched the mamba_scan kernel")
    # fp32 throughout, and at B*S = 200 <= 512 tokens every dispatch group
    # holds one token, so neither path drops an MoE choice: the two differ in
    # summation order only (the kernel vs the plain one-step update; cuBLAS at
    # M=B*S vs M=B), ~1e-6 relative; 1e-3 of each tensor's scale flags a
    # wrong decay, state handoff, conv window or routing, which moves results
    # by O(1).
    report = []
    pairs = [("logits", logits_p, logits_d)]
    for pi, (pre, full) in enumerate(zip(pre_caches, caches)):
        pairs += [(f"{n}[{pi}]", pre[n], full[n]) for n in sorted(pre)]
    worst = {}
    for n, a, b in pairs:
        scale = a.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= 1e-3 * scale, f"prefill vs decode {n}: max abs err {err} > "
                                   f"1e-3 x {scale}")
        kind = n.split("[")[0]
        if err / scale >= worst.get(kind, (0.0, 0.0, ""))[0]:
            worst[kind] = (err / scale, err, n)
    report = [f"{n} {err:.3e} ({rel:.3e} of max|x|)" for rel, err, n in worst.values()]
    worst_t = int((logits_p - logits_d).abs().amax(dim=(0, 2)).argmax())
    print(f"  B={B} S={S}: max |prefill - decode|, worst slot of each state: "
          + ", ".join(report) + f" (tol 1e-3 x max|x|); worst logit at position {worst_t}")
    del model, caches, pre_caches, logits_p, logits_d
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 12
    gcfg = get_config("granite-moe-1b-a400m")
    print(f"phase 12: {gcfg.name} full width and depth ({gcfg.n_layers} layers, "
          f"{gcfg.moe.n_experts} experts top-{gcfg.moe.top_k}), bf16")
    model = init_params(gcfg, torch.Generator(device=dev).manual_seed(14), dev)
    sync()
    print(f"  init {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S = 4, 2048
    plan = plan_for_cell(gcfg, S, B, ("data", "model"), 1, kind="prefill", use_dse=False)
    prefill = build_prefill_step(gcfg, plan, dev)
    tokens = torch.randint(0, gcfg.vocab, (B, S), generator=torch.Generator().manual_seed(15))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = prefill(model, tokens)
    sync()
    check(flash_attention_kernel.launches == gcfg.n_layers == 24,
          f"{flash_attention_kernel.launches} flash launches in one prefill, expected 24")
    check(wkv6_kernel.launches == mamba_scan_kernel.launches == qmatmul_kernel.launches == 0,
          "wkv6 / mamba_scan / qmatmul launched in a granite-moe prefill")
    check(bool(torch.isfinite(logits).all()), "non-finite granite-moe prefill logits")
    first = logits[:, ::64].clone()
    del logits
    times = timed_prefills(prefill, model, tokens, sync)
    print(f"  prefill B={B} S={S}: {statistics.median(times):.3f} ms (median of 3, "
          f"{min(times):.3f}-{max(times):.3f}), {gcfg.n_layers} flash launches per call, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    check_reproducible(prefill, model, tokens, first, "granite-moe")
    print(f"  prefill with the kernels called directly vs through their autograd functions "
          f"(medians of 12, in turns): {json.dumps(autograd_overhead(prefill, model, tokens, sync))}"
          f" {card}")
    print(f"  prefill traced: {prefill_breakdown(prefill, model, tokens, ('fa_fwd',), sync)} "
          f"{card}")
    launcher_flow(serve, gcfg, model, card)
    prof = decode_step_profile(gcfg, model, dev, sync)
    print(f"  decode step (batch 4, position 64): {prof} {card}")
    del model
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", gcfg.name]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "generated (4, 32)" in proc.stdout,
          f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stdout}{proc.stderr}")
    print(f"  python {' '.join(cmd[1:])}: " + " | ".join(proc.stdout.strip().splitlines())
          + f" {card}")

    # ------------------------------------------------------------ phase 13
    M, N, K = QMM_MAIN
    print(f"phase 13: qmatmul, granite-3-8b FFN up-projection M={M} K={K} N={N} "
          "(B=4 x S=2048 prefill), bf16 activation and weight quantized per row and column")
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    w = (0.02 * torch.randn(K, N, generator=g, device=dev)).bfloat16()
    reset_launches()
    xq, xs = quantize_rows(x)
    wq, ws = quantize_cols(w)
    out = qmatmul(xq, wq, xs, ws)
    sync()
    qmm_launches = qmatmul_kernel.launches
    check(qmm_launches == 1, f"{qmm_launches} qmatmul launches in one op call, expected 1")
    check(tma_path(K, xq.data_ptr()), "the main path's call does not take the wgmma / TMA kernel")
    check(flash_attention_kernel.launches == wkv6_kernel.launches
          == mamba_scan_kernel.launches == 0, "another kernel launched in the qmatmul op")
    check(tuple(out.shape) == (M, N) and out.dtype == torch.float32, f"out {out.shape} {out.dtype}")
    check(bool(torch.isfinite(out).all()), "non-finite qmatmul output")
    ref_bf16 = (x @ w).float()
    rel = ((out - ref_bf16).norm() / ref_bf16.norm()).item()
    check(rel < QMM_CLOSE_TOL, f"int8 product vs bf16 product: rel {rel} (tol {QMM_CLOSE_TOL})")
    plain = qmatmul_ref(xq, wq, xs, ws)
    check(torch.equal(out, plain), "main-path kernel output differs from the plain version: "
          f"max abs err {(out - plain).abs().max().item()}")
    print(f"  op on the main path: {qmm_launches} op call on the card, |int8 - bf16| / |bf16| "
          f"{rel:.6f} (tol {QMM_CLOSE_TOL}), bit-equal to the plain version")
    del x, w, out, ref_bf16, plain
    qmm_results = {}
    g = torch.Generator(device=dev).manual_seed(17)
    for name, m, n, k, dt_name in QMM_CASES + [("main_path", M, N, K, "float32")]:
        out_dtype = getattr(torch, dt_name)
        if name == "main_path":
            args = (xq, wq, xs, ws)
        else:
            args = (torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8),
                    torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8),
                    0.5 + torch.rand(m, generator=g, device=dev),
                    0.5 + torch.rand(n, generator=g, device=dev))
        got = qmatmul_kernel(*args, out_dtype=out_dtype)
        want = qmatmul_ref(*args, out_dtype=out_dtype)
        sync()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"{name}: kernel vs plain not bit-equal, max abs err {err}")
        res = {"max_abs_err": err,
               "path": "wgmma_tma" if tma_path(k, args[0].data_ptr()) else "mma_sync"}
        if name == "main_path":
            res["ms"] = cuda_ms_median(lambda: qmatmul_kernel(*args), 21)
            res["plain_ms"] = cuda_ms_median(lambda: qmatmul_ref(*args), 5)
            res["library_ms"] = cuda_ms_median(
                lambda: torch._int_mm(args[0], args[1]).float() * args[2][:, None]
                * args[3][None, :], 11)
            xb, wb = args[0].bfloat16(), args[1].bfloat16()
            bf16_ms = cuda_ms_median(lambda: xb @ wb, 21)
            int_mm_ms = cuda_ms_median(lambda: torch._int_mm(args[0], args[1]), 11)
            w_kmajor = args[1].t().contiguous()     # [N,K]: the layout cuBLASLt's int8 path takes
            int_mm_kmajor_ms = cuda_ms_median(lambda: torch._int_mm(args[0], w_kmajor.t()), 11)
            del xb, wb, w_kmajor
            bound_s, res["bound_by"] = kernel_bound(qmatmul_cost(args[0], args[1], got.dtype))
            res["bound_ms"] = 1e3 * bound_s
            res["context"] = {"bf16_matmul_ms": bf16_ms, "int_mm_only_ms": int_mm_ms,
                              "int_mm_kmajor_ms": int_mm_kmajor_ms}
        qmm_results[name] = res
        print(f"  {name}: M={m} N={n} K={k} out {dt_name}: bit-equal {json.dumps(res)} {card}")
        del got, want, args
    del xq, wq, xs, ws
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 14
    all_kernels = (flash_attention_kernel, flash_attention_bwd_kernel, wkv6_kernel,
                   wkv6_bwd_kernel, mamba_scan_kernel, mamba_scan_bwd_kernel, qmatmul_kernel)
    facade_launches = facade_phase(get_config, card, granite_prefill_ms, reset_launches,
                                   all_kernels)

    # ------------------------------------------------------------ phase 15
    training = training_phase(get_config, card, reset_launches, all_kernels, cuda_ms,
                              cuda_ms_median, sync)

    # ------------------------------------------------------------ phase 16
    print("phase 16: the configs first run on the card: "
          + ", ".join(a for a, _ in A16_ARCHS) + f"; bf16 prefill B={PREFILL_B} x "
          f"S={PREFILL_S} and decode at full width, fp32 prefill vs decode at reduced depth")
    for i, (arch, layers) in enumerate(A16_ARCHS):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        arch_prefill_phase(cfg, full.n_layers, 20 + 2 * i, card, reset_launches, all_kernels,
                           sync)
        fp32_prefill_vs_decode(cfg, full.n_layers, 30 + 2 * i, reset_launches, all_kernels,
                               sync)

    # ------------------------------------------------------------ phase 17
    print("phase 17: the frontend stubs at full size: " + ", ".join(FRONTEND_ARCHS)
          + f"; bf16 prefill B={PREFILL_B} x S={PREFILL_S} positions and decode, fp32 "
          "prefill vs decode at reduced depth, the train launcher as a process")
    for i, arch in enumerate(FRONTEND_ARCHS):
        cfg = get_config(arch)
        arch_prefill_phase(cfg, cfg.n_layers, 40 + 2 * i, card, reset_launches, all_kernels,
                           sync)
        fp32_prefill_vs_decode(cfg, cfg.n_layers, 50 + 2 * i, reset_launches, all_kernels,
                               sync)
    for arch in FRONTEND_ARCHS:
        launcher_training(arch, card, reset_launches, all_kernels, sync)

    # ------------------------------------------------------------ phase 18
    rwkv_training = wkv6_training_phase(get_config, card, reset_launches, all_kernels, cuda_ms,
                                        cuda_ms_median, sync)

    # ------------------------------------------------------------ phase 19
    jamba_training = mamba_training_phase(get_config, card, reset_launches, all_kernels,
                                          cuda_ms, cuda_ms_median, sync)

    # ------------------------------------------------------------ phase 20
    def per_step(launches: dict, steps: int) -> dict:
        return {f"{k}_kernel": n // steps for k, n in launches.items() if n}

    dryrun_phase(card, {
        "granite_prefill": {"flash_attention_kernel": launches},
        "granite_train": per_step(training["train"]["launches"], TRAIN_STEPS),
        "rwkv_train": per_step(rwkv_training["train"]["launches"], RWKV_TRAIN_STEPS),
        "jamba_period_dense": per_step(jamba_training["train"]["launches"], JAMBA_TRAIN_STEPS),
    })

    # ------------------------------------------------------------ phase 21
    mesh_launches = mesh_phase(get_config, card, sync)

    # ------------------------------------------------------------ phase 22
    pipeline_launches = pipeline_phase(get_config, card)

    # ------------------------------------------------------------ result
    main_case = results[MAIN_PATH_CASE]
    wkv_case = wkv_results[WKV_MAIN_PATH_CASE]
    mamba_case = mamba_results[MAMBA_MAIN_PATH_CASE]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
        "launches": launches, "facade_launches": facade_launches["flash_attention"],
        "mesh_launches": mesh_launches, "pipeline_launches": pipeline_launches,
        **{k: main_case[k] for k in keys},
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
        "launches": training["train"]["launches"]["flash_attention_bwd"],
        "facade_launches": facade_launches["flash_attention_bwd"],
        **{k: training["bwd"][k] for k in keys},
    }, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:82",
        "launches": wkv_launches, "facade_launches": facade_launches["wkv6"],
        **{k: wkv_case[k] for k in keys},
    }, {
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:82",
        "launches": rwkv_training["train"]["launches"]["wkv6_bwd"],
        "facade_launches": facade_launches["wkv6_bwd"],
        **{k: rwkv_training["bwd"][k] for k in keys},
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba/kernel.py:61",
        "launches": mamba_launches, "facade_launches": facade_launches["mamba_scan"],
        **{k: mamba_case[k] for k in keys},
    }, {
        "name": "mamba_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba/kernel.py:61",
        "launches": jamba_training["train"]["launches"]["mamba_scan_bwd"],
        "facade_launches": facade_launches["mamba_scan_bwd"],
        **{k: jamba_training["bwd"][k] for k in keys},
    }, {
        "name": "qmatmul", "route": "cuda",
        "source": "src/repro_torch/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul/kernel.py:43",
        "launches": qmm_launches, "facade_launches": facade_launches["qmatmul"],
        **{k: qmm_results["main_path"][k] for k in keys},
    }]
    print(f"total wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def phase21_card() -> int:
    """``python3 chip_smoke.py --phase-21``: phase 21 alone (the flash
    library built first)."""
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"flash_attention.cu built in {_build.build('flash_attention.cu'):.3f} s")
    mesh_phase(get_config, f"[{smi}]", torch.cuda.synchronize)
    print(f"total wall time {time.perf_counter() - T_START:.1f} s")
    return 0


def phase22_card() -> int:
    """``python3 chip_smoke.py --phase-22``: phase 22 alone (the flash
    forward and backward libraries built first)."""
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(2) as pool:
        took = list(pool.map(_build.build, ("flash_attention.cu", "flash_attention_bwd.cu")))
    print(f"flash_attention.cu, flash_attention_bwd.cu built in {took[0]:.3f}, {took[1]:.3f} s")
    pipeline_phase(get_config, f"[{smi}]")
    print(f"total wall time {time.perf_counter() - T_START:.1f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase-21"]:
        sys.exit(phase21_card())
    if sys.argv[1:2] == ["--phase-22"]:
        sys.exit(phase22_card())
    if sys.argv[1:2] == ["--phase-20"]:
        sys.exit(phase20_card(default_allocator=sys.argv[2:] == ["default"]))
    sys.exit(main())
