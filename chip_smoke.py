#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases; any failure exits non-zero:
  1. environment: the card's name and power limit, torch and CUDA versions;
     the CUDA kernels are built from ``src/repro_torch/kernels/csrc``.
  2. every kernel against its plain PyTorch version on the card: flash
     attention on the reference's ATTN_CASES, a bf16 twin of each (the
     tensor-core kernel: softcap, window, non-causal, GQA, ragged S), a
     tile-ragged windowed case and a q_offset case with Sq < Sk, small f32
     and bf16 head-dim-256 cases and both serving prefill shapes (bf16 at
     head dim 256 within one bf16 ulp); both RG-LRU kernels (the ring at
     S >= one time tile, the step kernel below) bit for bit in f32 and bf16
     at the recurrentgemma prefill and decode shapes, ragged S and D, rows
     off 16-byte boundaries, B = 1 and h0 None, and two launches at the
     prefill shape bit-identical; the mLSTM forward at the reference's three test shapes (f32, the CUDA-core
     kernel) and, through the tensor-core kernel within one bf16 ulp, a bf16
     twin of each, head dims 128 and 256, a chunk of 40 and the xlstm-350m
     training shape (launched twice there: bit-identical), its m bit for
     bit; int8 quantize / dequantize bit for bit on a full-width moment;
     the flash backward (dq, dk, dv) against its plain version on every
     flash case in f32 (2e-5) and bf16 (one bf16 ulp), on bf16 cases at the
     tensor-core kernels' edges (head dim 16, a 12-head GQA group, a window
     edge inside a ragged tile, q_offset with Sq < Sk, softcap, non-causal
     Sq != Sk) and at the training shape (8, 2048, 24, 2, 128) bf16, two
     launches there bit-identical; each case prints the device kernels it
     ran (the profiler's names), which must be the tensor-core ones for
     bf16 at head dims up to 128 and the CUDA-core ones for the rest; the
     stats-emitting forward's o bit for bit the stats-free one's and its
     m, l within 1e-4 of the plain forward's. Head dim 80 (h2o-danube-1.8b)
     in f32 and bf16, forward and backward: a window edge inside a ragged
     tile and a q offset with Sq < Sk at GQA 4 (32 heads / 8 kv), the h2o
     prefill shape (4, 5120, 32, 8, 80, window 4096) and a training-like
     backward (8, 2048, 32, 8, 80, window 4096); the forward and backward
     at deepseek-coder-33b's training shape (8, 2048, 56, 8, 128); and the
     forward at llama4-scout-17b-a16e's prefill shape (4, 8704, 40, 8, 128)
     with its 8192-token window and without a window (NoPE), bf16 within
     one bf16 ulp.
  3. the first path, the serving restart of slice 1: full-width
     starcoder2-3b (depth cut from 30 to 2 layers, random weights from a
     seed, bf16) with a training-layout state is saved through the burst
     buffer with int8 moments, restored onto the card, and serves 3 request
     batches; params must come back bit-exact, moments within the int8
     bound, tokens equal to those served from the un-saved params, and
     every kernel of the path must have launched the expected number of
     times (counts are zeroed just before and read just after).
  3b. the second path, the serving restart of slice 2: full-width
     recurrentgemma-9b (one repeat of each segment unit: 4 of 38 layers)
     restarts from a params-only checkpoint and serves 3 request batches of
     3072-token prompts (past the 2048-token window), with the same checks;
     the RG-LRU kernel runs in every prefill and decode step.
  3c. the third path, the training restart of slice 3: full-width
     xlstm-350m (one repeat of its segment unit: 7 mLSTM + 1 sLSTM of 24
     layers, f32 params) trains through ``launch/train.py::train_loop`` on
     batches of 8 x 2048 tokens, deterministic: run A takes 4 steps; run B
     takes 2, checkpoints through the burst buffer unquantized, loses
     server/0, restores from the replicas into a state drawn from another
     seed and takes 2 more. B's params and moments must equal A's bit for
     bit. The step-4 state then goes through an int8-moment checkpoint:
     params bit-exact, moments within the half-step bound. The mLSTM kernel
     runs in every forward (7 launches a step).
  3d. the fourth path, the training restart of slice 4: full-width
     starcoder2-3b (2 of 30 layers, bf16 params, f32 AdamW moments) through
     the same restart at 8 + 8 steps of 8 x 2048 tokens; the flash forward
     (with row statistics) and the flash backward kernel run once a layer
     in every step; besides them only quantize / dequantize run, for the
     int8 checkpoint.
  3e. the fifth path, the training restart of slice 5: full-width
     deepseek-coder-33b (2 of 62 layers, bf16 params, Adafactor with bf16
     momentum and f32 factored second moments) through the same restart;
     the flash forward and backward (head dim 128) run once a layer in
     every step, quantize / dequantize once for each int8 leaf.
  3f. the sixth path, the serving restart of slice 6: h2o-danube-1.8b at
     full width and full depth (24 of 24 layers) from a params-only
     checkpoint, 3 request batches of 4 prompts of 5120 tokens (past its
     4096-token window); the flash forward at head dim 80 runs once a layer
     in every prefill.
  3g. the seventh path, the serving restart of slice 7: llama4-scout-17b-a16e
     at full width (16 experts at top-1 and a shared expert of d_ff 8192,
     vocab 202048; depth cut to one moe_local and one moe_nope layer of 48,
     6.48 G params) from a params-only checkpoint over 4 servers of 8 GiB,
     3 request batches of 4 prompts of 8704 tokens (past its 8192-token
     window); the flash forward runs once a layer in every prefill, the MoE
     FFN (sorted capacity dispatch, expert products in torch.bmm) in every
     prefill and decode step; a profile of the prefill splits the MoE FFN's
     device time into its products and its dispatch and combine.
  4. numbers for each path, taken right after it (its model is freed before
     the next path): save / restore seconds, prefill ms and decode tok/s
     (serving), step time, tokens/s, save / flush / restore-after-kill and
     int8 save / flush / restore seconds and the optimizer update's own
     seconds (training), a device profile; then a JSON line with each
     kernel's launches, time, bound, plain-version time and the time of one
     PyTorch library call for the same function.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
SEED = 0
STEP = 1000
BATCH, PROMPT, GEN, REQUESTS = 4, 512, 32, 3
LAYERS = 2                       # of starcoder2-3b's 30 (checkpoint size)
# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12

# the reference's ATTN_CASES (tests/test_kernels.py) with their tolerances,
# plus the serving prefill shape: (B, Sq, Sk, H, KV, D, causal, window,
# softcap, q_offset, dtype, tol)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, 0, "float32", 2e-5),
    (2, 96, 96, 4, 2, 32, True, 0, 0.0, 0, "float32", 2e-5),
    (1, 128, 128, 8, 2, 64, True, 48, 0.0, 0, "float32", 2e-5),
    (1, 64, 64, 2, 1, 128, False, 0, 0.0, 0, "float32", 2e-5),
    (1, 128, 128, 4, 4, 64, True, 0, 20.0, 0, "float32", 2e-5),
    (1, 128, 128, 4, 2, 64, True, 0, 0.0, 0, "bfloat16", 3e-2),
    (2, 80, 80, 4, 4, 48, True, 0, 0.0, 0, "float32", 2e-5),
]
# every feature through the bf16 tensor-core kernel, at the reference's bf16
# tolerance: a bf16 twin of each f32 case above (softcap, window, non-causal,
# GQA groups, a ragged S at D = 48), tiles ragged at both ends with a window
# edge inside tiles, and a q offset with Sq < Sk (the last 64 of 200 rows)
BF16_CASES = [case[:10] + ("bfloat16", 3e-2) for case in ATTN_CASES
              if case[10] == "float32"] + [
    (2, 300, 300, 8, 2, 128, True, 100, 0.0, 0, "bfloat16", 3e-2),
    (1, 64, 200, 4, 2, 128, True, 0, 0.0, 136, "bfloat16", 3e-2),
]
PREFILL_CASE = (BATCH, PROMPT, PROMPT, 24, 2, 128, True, 0, 0.0, 0,
                "bfloat16", 3e-2)
MOMENT_SHAPE = (LAYERS, 3072, 12288)   # the w_up moment leaf, f32

# slice 2: recurrentgemma-9b, a prompt past its 2048-token window
RG_BATCH, RG_PROMPT, RG_GEN, RG_REQUESTS = 4, 3072, 32, 3
RG_WINDOW, RG_HEADS, RG_HEAD_DIM, RG_WIDTH = 2048, 16, 256, 4096
# bf16 output at head dim 256: the kernel and the plain version each round
# one f32 result to bf16, so they may differ by one bf16 ulp, at most
# 2^-7 |x|; atol = rtol = 8e-3 admits that at every magnitude
# (8e-3 + 8e-3 |x| >= 2^-7 |x|) and nothing wider. At the prefill shape
# outputs are ~0.03 (a 2048-key window); the small bf16 case's window of 8
# keeps them near 1, where a key lost at a window or tile edge moves an
# output by a tenth or more, far above its limit.
D256_BF16_TOL = 8e-3
RG_PREFILL_CASE = (RG_BATCH, RG_PROMPT, RG_PROMPT, RG_HEADS, 1, RG_HEAD_DIM,
                   True, RG_WINDOW, 0.0, 0, "bfloat16", D256_BF16_TOL)
D256_CASES = [(2, 96, 96, 4, 1, 256, True, 32, 0.0, 0, "float32", 2e-5),
              (2, 96, 96, 4, 1, 256, True, 8, 0.0, 0, "bfloat16",
               D256_BF16_TOL)]
# RG-LRU scan: (B, S, D, dtype, h0), held bit for bit; prefill starts from
# the zero state of a fresh cache, decode from the carried one; h0 "none"
# passes None to the wrapper
RG_LRU_PREFILL = (RG_BATCH, RG_PROMPT, RG_WIDTH, "bfloat16", "zero")
RG_LRU_DECODE = (RG_BATCH, 1, RG_WIDTH, "bfloat16", "normal")


def _rg_lru_cases(tile_s):
    """Both serving shapes and the kernels' edges, each in f32 and bf16:
    a ragged S (300, one tile + 1), S = 2, S on each side of the step /
    ring threshold (one time tile), a D that is not a multiple of the
    ring's 64 / 32 channels (4100: bf16 rows not 16-byte aligned, so
    shifted rows; 4104: aligned), D = 1030 (neither dtype aligned), B = 1,
    and h0 None."""
    shapes = [(RG_BATCH, RG_PROMPT, RG_WIDTH, "zero"),
              (RG_BATCH, 1, RG_WIDTH, "normal"),
              (2, 300, 384, "normal"), (2, tile_s + 1, 384, "none"),
              (3, 2, 384, "normal"), (2, tile_s - 1, 320, "normal"),
              (2, tile_s, 320, "none"), (2, 200, 4100, "normal"),
              (2, 130, 4104, "none"), (2, 150, 1030, "normal"),
              (1, 512, RG_WIDTH, "none")]
    return [(b, s, d, dtype, h0) for b, s, d, h0 in shapes
            for dtype in ("bfloat16", "float32")]

# slice 3: xlstm-350m training, one repeat of its (mLSTM x 7, sLSTM) unit
# 4 steps (2 + 2 around the kill): its sLSTM's host loop makes a step take
# ~4 s, and the run stays near half its time limit
XL_BATCH, XL_SEQ, XL_STEPS = 8, 2048, 4
XL_HEADS, XL_HEAD_DIM = 4, 512        # mLSTM heads of d_model 1024 x 2
XL_DRAM = 2 << 30                     # a server's DRAM (~2.0 GB checkpoint)
# mLSTM forward: (shape (B, S, H, D), chunk, dtype, atol, rtol). The
# reference's kernel tests (tests/test_kernels.py) with their tolerances in
# f32 (the CUDA-core kernel); every bf16 case (the tensor-core kernel)
# within one bf16 ulp (as D256_BF16_TOL): a bf16 twin of each f32 case, head
# dims 128 and 256, a chunk of 40 (not a multiple of the 16-row tile) and
# the training shape; m is compared within 1e-5 (the kernels and the plain
# version scan F in one order, so it comes out equal)
MLSTM_TRAIN_CASE = ((XL_BATCH, XL_SEQ, XL_HEADS, XL_HEAD_DIM), 128,
                    "bfloat16", 8e-3, 8e-3)
MLSTM_F32_CASES = [((1, 128, 2, 32), 64, "float32", 5e-4, 1e-3),
                   ((2, 256, 1, 64), 128, "float32", 5e-4, 1e-3),
                   ((1, 192, 4, 16), 64, "float32", 5e-4, 1e-3)]
MLSTM_CASES = MLSTM_F32_CASES + [
    (shape, chunk, "bfloat16", 8e-3, 8e-3)
    for shape, chunk, *_ in MLSTM_F32_CASES] + [
    ((2, 256, 2, 128), 128, "bfloat16", 8e-3, 8e-3),
    ((1, 256, 2, 256), 64, "bfloat16", 8e-3, 8e-3),
    ((2, 120, 2, 64), 40, "bfloat16", 8e-3, 8e-3),
    MLSTM_TRAIN_CASE]
MLSTM_M_TOL = 1e-5

# slice 4: starcoder2-3b training at full width, LAYERS of its 30 layers
SC_BATCH, SC_SEQ, SC_STEPS = 8, 2048, 8
SC_DRAM = 4 << 30     # a server's DRAM: 2 x ~3.4 GB at replication 2 over 4
# the flash backward against its plain version (elementwise,
# |kernel - plain| <= tol + tol |plain|, on the same q, k, v, o, m, l, dO):
# f32 at the reference's f32 kernel tolerance of 2e-5 (both sum in f32, in
# other orders); bf16 within one bf16 ulp (D256_BF16_TOL's argument: each
# rounds one f32 result to bf16 once). Every forward case in both dtypes,
# and the training shape. The forward's row statistics m, l (f32) against
# the plain forward's within BWD_STATS_TOL (atol = rtol): the same scores
# summed in another order, and in the bf16 kernel in the log2 domain.
BWD_F32_TOL = 2e-5
BWD_STATS_TOL = 1e-4
TRAIN_ATTN_CASE = (SC_BATCH, SC_SEQ, SC_SEQ, 24, 2, 128, True, 0, 0.0, 0,
                   "bfloat16", D256_BF16_TOL)
# the forward at the training shape, at the reference's bf16 tolerance
TRAIN_FWD_CASE = TRAIN_ATTN_CASE[:11] + (3e-2,)
# bf16 cases at the edges of the tensor-core backward (64-key dk / dv
# tiles, 64-row dq tiles, 16-key warp slices): head dim 16, a GQA group of
# 12 (H 24, KV 2) at a short S, Sk not a multiple of 64 with a window edge
# inside tiles, a q offset with Sq < Sk and Sq not a multiple of 64,
# softcap with GQA at D = 128, and non-causal with Sq != Sk
BWD_EDGE_CASES = [
    (1, 100, 100, 4, 2, 16, True, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (2, 256, 256, 24, 2, 128, True, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 150, 150, 8, 2, 64, True, 40, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 72, 200, 4, 1, 64, True, 0, 0.0, 128, "bfloat16", D256_BF16_TOL),
    (1, 160, 160, 8, 2, 128, True, 0, 30.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 96, 130, 4, 2, 32, False, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
]

# slice 5: deepseek-coder-33b training at full width, DS_LAYERS of its 62
# layers, Adafactor; its attention: 56 heads / 8 kv at head dim 128
DS_LAYERS = 2
DS_BATCH, DS_SEQ, DS_STEPS = 8, 2048, 8
DS_DRAM = 4 << 30     # ~3.05 GB a server: ~6.1 GB at replication 2 over 4
DS_TRAIN_ATTN_CASE = (DS_BATCH, DS_SEQ, DS_SEQ, 56, 8, 128, True, 0, 0.0, 0,
                      "bfloat16", D256_BF16_TOL)
DS_TRAIN_FWD_CASE = DS_TRAIN_ATTN_CASE[:11] + (3e-2,)
# slice 6: h2o-danube-1.8b serving at full width and depth, a prompt past
# its 4096-token window; head dim 2560 / 32 = 80
H2O_BATCH, H2O_PROMPT, H2O_GEN, H2O_REQUESTS = 4, 5120, 32, 3
H2O_WINDOW, H2O_HEADS, H2O_KV, H2O_HEAD_DIM = 4096, 32, 8, 80
H2O_DRAM = 4 << 30    # ~1.83 GB a server: ~3.66 GB at replication 2 over 4
# head dim 80 in f32 (2e-5) and bf16 (the reference's 3e-2) at GQA 4: a
# window of 40 whose edge falls inside the 64-key tiles of a ragged S, and
# a q offset with Sq < Sk (the last 72 queries of 200 keys); the h2o
# prefill shape in bf16 within one bf16 ulp (outputs there are ~0.02, a
# 4096-key window, so 3e-2 would hold nothing; D256_BF16_TOL's argument)
D80_CASES = [case for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2))
             for case in (
                 (1, 200, 200, H2O_HEADS, H2O_KV, H2O_HEAD_DIM, True, 40,
                  0.0, 0, dtype, tol),
                 (1, 72, 200, H2O_HEADS, H2O_KV, H2O_HEAD_DIM, True, 0,
                  0.0, 128, dtype, tol))]
H2O_PREFILL_CASE = (H2O_BATCH, H2O_PROMPT, H2O_PROMPT, H2O_HEADS, H2O_KV,
                    H2O_HEAD_DIM, True, H2O_WINDOW, 0.0, 0, "bfloat16",
                    D256_BF16_TOL)
# the D = 80 backward at a training-like shape (h2o-danube trains nowhere on
# the main paths; the shape is its layer's at 8 x 2048 tokens)
H2O_TRAIN_ATTN_CASE = (8, 2048, 2048, H2O_HEADS, H2O_KV, H2O_HEAD_DIM, True,
                       H2O_WINDOW, 0.0, 0, "bfloat16", D256_BF16_TOL)
# slice 7: llama4-scout-17b-a16e serving at full width, one layer of each of
# its two kinds; a prompt 512 tokens past its 8192-token window
LL_BATCH, LL_PROMPT, LL_GEN, LL_REQUESTS = 4, 8704, 32, 3
LL_WINDOW, LL_HEADS, LL_KV, LL_HEAD_DIM = 8192, 40, 8, 128
LL_SEGMENTS = ((("moe_local", "moe_nope"), 1),)
# ~6.03 GiB a server at replication 2 over 4 (12.95 GB), all in DRAM: at
# 4 GiB the rest spills to the servers' SSD logs, whose fsyncs outlasted
# the writes' 60 s acknowledgement on an H100 host's disk
LL_DRAM = 8 << 30
# the prefill of its moe_local layer (the window) and of its moe_nope layer
# (causal, no window): bf16, rtol D256_BF16_TOL (one bf16 ulp of the output)
# and, per element, P_ROUND_SIGMAS standard deviations of the error the
# kernel's bf16 P puts into it (``_p_rounding_atol``) in place of its atol:
# outputs of an 8192-key window are ~0.01, and a kernel that lost the 64-key
# tile at the window's edge stays within an atol of 8e-3 in over 99% of
# them; a fixed atol small enough to catch it would fail the first rows,
# whose few keys leave P's rounding unaveraged where their v cancel
LL_PREFILL_CASE = (LL_BATCH, LL_PROMPT, LL_PROMPT, LL_HEADS, LL_KV,
                   LL_HEAD_DIM, True, LL_WINDOW, 0.0, 0, "bfloat16",
                   D256_BF16_TOL)
LL_NOPE_CASE = LL_PREFILL_CASE[:7] + (0,) + LL_PREFILL_CASE[8:]
P_ROUND_CASES = (LL_PREFILL_CASE, LL_NOPE_CASE)
P_ROUND_SIGMAS = 8
# the training shapes, where two launches must be bit-identical
TRAIN_SHAPES = (TRAIN_ATTN_CASE, DS_TRAIN_ATTN_CASE, H2O_TRAIN_ATTN_CASE)

BWD_CASES = [case[:11] + (BWD_F32_TOL if case[10] == "float32"
                          else D256_BF16_TOL,)
             for case in ATTN_CASES + BF16_CASES + D256_CASES + D80_CASES] \
    + BWD_EDGE_CASES + list(TRAIN_SHAPES)


def bwd_kernels(case):
    """The device kernels the backward must run on a case: bf16 at head
    dims up to 128 on the tensor cores, the rest on the CUDA cores."""
    d, dtype = case[5], case[10]
    if dtype == "bfloat16" and d <= 128:
        names = [f"flash_bwd_mma_dkdv_kernel<{d}>",
                 f"flash_bwd_mma_dq_kernel<{d}>"]
    else:
        t = "bf16" if dtype == "bfloat16" else "f32"
        names = [f"flash_bwd_dkdv_kernel<{t}, {d}>",
                 f"flash_bwd_dq_kernel<{t}, {d}>"]
    return sorted(names + ["flash_bwd_delta_kernel"])


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 1


def _kernel_label(name: str) -> str:
    """'mlstm_mma_kernel<512>', 'flash_bwd_dq_kernel<f32, 128>' or
    'dequantize_kernel<bf16>' from a template instance's name, mangled (as
    ptxas prints it) or demangled (as the profiler does),
    'flash_bwd_delta_kernel' from a plain one; other names unchanged."""
    m = re.search(r"\d+([a-z][a-z_]*_kernel)I(.*?)EEv", name)
    if m:
        kernel, args = m.groups()
        ints = re.findall(r"L[bi](\d+)E", args)
        rest = re.sub(r"L[bi]\d+E", "", args)
        dtype = ["bf16"] if "bfloat16" in rest \
            else ["f32"] if rest == "f" else []
        return f"{kernel}<{', '.join(dtype + ints)}>"
    m = re.search(r"\d+([a-z][a-z_]*_kernel)E", name)
    if m:
        return m.group(1)
    m = re.search(r"([a-z][a-z_]*_kernel)(?:<([\w, ]*)>)?\(", name)
    if not m:
        return name
    args = [a.strip() for a in (m.group(2) or "").split(",") if a.strip()]
    dtype = [{"__nv_bfloat16": "bf16", "float": "f32"}.get(a, a)
             for a in args if not a.isdigit()]
    ints = [a for a in args if a.isdigit()]
    return f"{m.group(1)}<{', '.join(dtype + ints)}>" if args \
        else m.group(1)


# a kernel of csrc/*.cu by the profiler's (demangled) name
PORT_KERNEL = re.compile(
    r"\(anonymous namespace\)::(flash|rg_lru|mlstm|quantize|dequantize)_"
    r"\w*kernel\b")


def device_kernels(fn, want, tag, observations=3):
    """``fn()`` and the sorted labels of the port's kernels it launched
    (torch.profiler). The profiler at times drops a launch's records (a
    flash backward's delta and dk/dv kernels once in phase 2, in one run
    of several): while what it recorded is a strict part of ``want``, the
    same deterministic call is profiled again, up to ``observations`` in
    all. A kernel outside ``want`` is never a dropped record, and the
    caller's check fails on it at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = None
    for i in range(observations):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        out = result if out is None else out
        names = sorted({_kernel_label(e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and PORT_KERNEL.search(e.name)})
        if not set(names) < set(want):
            break
        print(f"{tag}: observation {i + 1} of {observations}: the profiler "
              f"recorded {names or 'no kernel'} of {want}", flush=True)
    check(bool(names), f"{tag}: the profiler recorded no kernel of the port")
    return out, names


def environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    # comparisons run in full f32 where they are f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} CUDA libraries ({', '.join(sorted(libs))}) "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    for stem, log in build.build_logs().items():
        entry = "?"
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = _kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {stem}] {entry}: {line.strip()}", flush=True)


# ------------------------------------------------------------------ phase 2


def _attn_inputs(case, gen):
    import torch
    b, sq, sk, h, kv, d, *_, dtype, _tol = case
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
    return mk(b, sq, h, d), mk(b, sk, kv, d), mk(b, sk, kv, d)


def _rg_lru_inputs(case, gen):
    """a in (0.7, 1), as the gates make it; gx and h0 small normals."""
    import torch
    b, s, d, dtype, h0_kind = case
    dt = getattr(torch, dtype)
    a = (0.7 + 0.299 * torch.rand((b, s, d), generator=gen,
                                  device="cuda")).to(dt)
    gx = (0.1 * torch.randn((b, s, d), generator=gen, device="cuda")).to(dt)
    h0 = (0.1 * torch.randn((b, d), generator=gen, device="cuda")).to(dt)
    if h0_kind == "none":
        return a, gx, None
    return a, gx, (h0 if h0_kind == "normal" else h0.zero_())


def check_rg_lru():
    """Both RG-LRU kernels bit for bit against the plain version on every
    case of ``_rg_lru_cases``, on inputs off a 16-byte boundary (a and gx
    at different shifts), and over two launches at the prefill shape; the
    cases must reach both kernels and both row alignments of the ring in
    each dtype. Returns the max error. The inputs come from a generator of
    their own, so these cases do not move the other kernels' inputs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def run(case, a, gx, h0):
        h, h_last = rg_lru.rg_lru(a, gx, h0)
        ph, ph_last = ref.rg_lru(a, gx, h0)
        torch.cuda.synchronize()
        de = max((h.float() - ph.float()).abs().max().item(),
                 (h_last.float() - ph_last.float()).abs().max().item())
        check(h.dtype == a.dtype and h.shape == a.shape
              and h_last.shape == (a.shape[0], a.shape[2]),
              f"rg_lru {case}: output {h.dtype} {tuple(h.shape)}")
        check(torch.isfinite(h.float()).all().item(), f"rg_lru {case}: "
              f"non-finite output")
        check(torch.equal(h, ph) and torch.equal(h_last, ph_last),
              f"rg_lru {case}: differs from its plain version")
        return de, h, h_last

    e, reached = 0.0, set()
    for case in _rg_lru_cases(rg_lru.TILE_S):
        a, gx, h0 = _rg_lru_inputs(case, gen)
        plan = rg_lru.launch_plan(*a.shape, a.dtype)
        reached.add((case[3], plan.kernel, plan.aligned))
        de, h, h_last = run(case, a, gx, h0)
        print(f"[rg_lru] {case}: {plan.kernel} kernel, "
              f"{'aligned' if plan.aligned else 'shifted'} rows, grid "
              f"{plan.grid}; max|kernel-plain| {de:.3e} (tol 0: "
              f"bit-identical)", flush=True)
        if case == RG_LRU_PREFILL:
            h2, h_last2 = rg_lru.rg_lru(a, gx, h0)
            torch.cuda.synchronize()
            same = torch.equal(h, h2) and torch.equal(h_last, h_last2)
            print(f"[rg_lru] {case}: two launches bit-identical: {same}",
                  flush=True)
            check(same, f"rg_lru {case}: two launches differ")
            del h2, h_last2
        e = max(e, de)
        del a, gx, h0, h, h_last
    # rows of 16-byte multiples, but a one and gx three elements past a
    # 16-byte boundary: each row read at its own shift, two shifts a row
    for dtype in ("bfloat16", "float32"):
        case = (2, 300, 384, dtype, "normal")
        a, gx, h0 = _rg_lru_inputs(case, gen)
        a, gx = (torch.cat([x.new_zeros(k), x.reshape(-1)])[k:].view(x.shape)
                 for x, k in ((a, 1), (gx, 3)))
        plan = rg_lru.launch_plan(*a.shape, a.dtype, aligned=False)
        reached.add((dtype, plan.kernel, plan.aligned))
        de, *_ = run(case, a, gx, h0)
        print(f"[rg_lru] {case}, a and gx 1 and 3 elements past a 16-byte "
              f"boundary: {plan.kernel} kernel, shifted rows; "
              f"max|kernel-plain| {de:.3e} (tol 0)", flush=True)
        e = max(e, de)
    want = {(dt, k, al) for dt in ("bfloat16", "float32")
            for k, al in (("step", True), ("ring", True), ("ring", False))}
    check(reached == want, f"rg_lru cases reached {sorted(reached)}, "
          f"not every kernel and row alignment {sorted(want)}")
    return e


def _within(what, out, plain, tol, atol=None):
    """|out - plain| <= atol + tol |plain| at every element, out finite and
    of plain's dtype and shape; ``atol``: a tensor of plain's shape, or None
    for atol = tol. Prints and returns the max error."""
    import torch
    check(out.dtype == plain.dtype and out.shape == plain.shape,
          f"{what}: {out.dtype} {tuple(out.shape)}, plain {plain.dtype} "
          f"{tuple(plain.shape)}")
    check(torch.isfinite(out.float()).all().item(), f"{what}: non-finite")
    diff = (out.float() - plain.float()).abs()
    lim = (tol if atol is None else atol) + tol * plain.float().abs()
    worst = torch.argmax(diff / lim).item()
    e = diff.max().item()
    bound = (f"atol = rtol = {tol:g}" if atol is None else
             f"rtol {tol:g}, atol per element from {atol.min().item():.3e} "
             f"to {atol.max().item():.3e}")
    print(f"{what}: max|kernel-plain| {e:.3e}; worst element "
          f"{diff.reshape(-1)[worst].item():.3e} against its bound "
          f"{lim.reshape(-1)[worst].item():.3e} ({bound})", flush=True)
    check(bool((diff <= lim).all()), f"{what}: error above {bound} at "
          f"element {worst}")
    return e


def _p_rounding_atol(q, k, v, *, causal, window, q_offset=0):
    """Per element of the attention output, ``P_ROUND_SIGMAS`` standard
    deviations of the error that the bf16 flash kernel's rounding of P puts
    into it. The kernel rounds each p_j = exp(s_j - m) (at most 1) to bf16
    for its P V product: an error of at most 2^-8 p_j, spread evenly within
    half an ulp, independent from key to key; the row sum l stays f32. So
    o's error has a standard deviation of at most
    2^-8 / sqrt(3) * sqrt(sum_j p_j^2 v_j^2) / sum_j p_j. The plain version
    at 2 q (the scores doubled exactly) over v^2 gives
    sum_j exp(2 (s_j - m)) v_j^2 / l2, with l2 = sum_j exp(2 (s_j - m))
    among its statistics; no softcap (it does not double with q)."""
    from repro_torch.kernels import ops
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              return_stats=True)
    _, _, l = ops.flash_chunked(q, k, v, **kw)
    sq, _, l2 = ops.flash_chunked(2 * q.float(), k.float(),
                                  v.float().square(), **kw)
    s2 = sq * (l2 / l.square())[..., None]
    return P_ROUND_SIGMAS * 2.0 ** -8 / 3 ** 0.5 * s2.clamp_min(0).sqrt()


def check_flash_bwd():
    """The flash backward kernel against its plain version on every case of
    BWD_CASES, fed the same q, k, v, dO and the forward kernel's o, m, l;
    the stats-emitting forward against the stats-free one (o bit for bit)
    and its m, l against the plain forward's; at each training shape
    (TRAIN_SHAPES) two launches bit-identical, and at slice 4's autograd
    through the kernel's Function equal to the backward kernel on the saved
    tensors. Returns {training shape: (max error, the device kernels it
    ran)}. The inputs come from a generator of their own, so these cases do
    not move the other kernels' inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    results = {}
    for case in BWD_CASES:
        *_, causal, window, cap, q_offset, dtype, tol = case
        opts = dict(causal=causal, window=window, softcap=cap,
                    q_offset=q_offset)
        q, k, v = _attn_inputs(case, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        o_free = fa.flash_attention(q, k, v, **opts)
        o, m, l = fa.flash_attention(q, k, v, return_stats=True, **opts)
        _, pm, pl = ops.flash_chunked(q, k, v, return_stats=True, **opts)
        torch.cuda.synchronize()
        check(torch.equal(o, o_free), f"flash {case}: o with stats differs "
              f"from o without")
        tag = f"[flash_bwd] {case[:-2]} {dtype}"
        _within(f"{tag} m", m, pm, BWD_STATS_TOL)
        _within(f"{tag} l", l, pl, BWD_STATS_TOL)
        grads, ran = device_kernels(
            lambda: fa.flash_attention_bwd(q, k, v, o, m, l, do, **opts),
            bwd_kernels(case), tag)
        print(f"{tag}: kernels {', '.join(ran)}", flush=True)
        check(ran == bwd_kernels(case), f"flash_bwd {case}: ran {ran}, not "
              f"{bwd_kernels(case)}")
        plain = ops.flash_bwd_chunked(q, k, v, o, m, l, do, **opts)
        torch.cuda.synchronize()
        e = max(_within(f"{tag} {name}", g, pg, tol)
                for name, g, pg in zip(("dq", "dk", "dv"), grads, plain))
        del plain, pm, pl, o_free
        if case in TRAIN_SHAPES:
            results[case] = (e, ran)
            again = fa.flash_attention_bwd(q, k, v, o, m, l, do, **opts)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            print(f"{tag}: two launches bit-identical in dq, dk, dv: {same}",
                  flush=True)
            check(same, f"flash_bwd {case}: two launches differ")
            del again
        if case == TRAIN_ATTN_CASE:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = fa.flash_attention(*leaves, **opts)
            auto = torch.autograd.grad(out, leaves, do)
            same = torch.equal(out, o) and all(
                torch.equal(a, b) for a, b in zip(auto, grads))
            print(f"{tag}: autograd through the kernel's Function equals o "
                  f"and the backward kernel's dq, dk, dv bit for bit: {same}",
                  flush=True)
            check(same, f"flash {case}: autograd through the Function "
                  f"differs from the kernels")
            del leaves, out, auto
        del q, k, v, do, o, m, l, grads
    return results


def _mlstm_inputs(case, gen):
    """q, k, v normal in the case's dtype; log_f = log(U(0.85, 0.999)) and
    log_i = 0.5 N(0, 1) in f32, as the reference's kernel tests draw them."""
    import torch
    (b, s, h, d), _chunk, dtype, *_ = case
    dt = getattr(torch, dtype)
    mk = lambda: torch.randn((b, s, h, d), generator=gen,
                             device="cuda").to(dt)
    log_f = torch.log(0.85 + 0.149 * torch.rand((b, s, h), generator=gen,
                                                 device="cuda"))
    log_i = 0.5 * torch.randn((b, s, h), generator=gen, device="cuda")
    return mk(), mk(), mk(), log_f, log_i


def check_kernels(gen):
    """Each kernel against its plain version on the same card inputs.
    Returns the max error at the main paths' shapes, by kernel row, and the
    device kernels the flash backward ran at each training shape, by row."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm
    from repro_torch.kernels import quantize as quant

    err = {}
    rows = {PREFILL_CASE: "flash_attention",
            RG_PREFILL_CASE: "flash_attention_d256",
            TRAIN_FWD_CASE: "flash_attention_train",
            DS_TRAIN_FWD_CASE: "flash_attention_train_dsc",
            H2O_PREFILL_CASE: "flash_attention_d80",
            LL_PREFILL_CASE: "flash_attention_llama4",
            LL_NOPE_CASE: "flash_attention_llama4_nope"}
    for case in ATTN_CASES + BF16_CASES + D256_CASES + D80_CASES + list(rows):
        *_, causal, window, cap, q_offset, dtype, tol = case
        q, k, v = _attn_inputs(case, gen)
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap, q_offset=q_offset)
        plain = ops.flash_chunked(q, k, v, causal=causal, window=window,
                                  softcap=cap, q_offset=q_offset)
        atol = (_p_rounding_atol(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
                if case in P_ROUND_CASES else None)
        torch.cuda.synchronize()
        # elementwise, as the reference's kernel tests hold it
        e = _within(f"[flash] {case[:-1]}", out, plain, tol, atol)
        if case in rows:
            err[rows[case]] = e
        del q, k, v, out, plain, atol

    results, bwd_ran = check_flash_bwd(), {}
    for case, name in ((TRAIN_ATTN_CASE, "flash_attention_bwd"),
                       (DS_TRAIN_ATTN_CASE, "flash_attention_bwd_dsc"),
                       (H2O_TRAIN_ATTN_CASE, "flash_attention_bwd_d80")):
        err[name], bwd_ran[name] = results[case]

    err["rg_lru"] = check_rg_lru()

    for case in MLSTM_CASES:
        shape, chunk, dtype, atol, rtol = case
        x = _mlstm_inputs(case, gen)
        h, (c, n, m) = mlstm.mlstm(*x, chunk=chunk)
        ph, (pc, pn, pm) = ops.mlstm_chunked(*x, chunk=chunk)
        torch.cuda.synchronize()
        parts = []
        for name, out, plain in (("h", h, ph), ("C", c, pc), ("n", n, pn)):
            check(out.dtype == plain.dtype and out.shape == plain.shape,
                  f"mlstm {case}: {name} {out.dtype} {tuple(out.shape)}")
            check(torch.isfinite(out.float()).all().item(),
                  f"mlstm {case}: non-finite {name}")
            diff = (out.float() - plain.float()).abs()
            lim = atol + rtol * plain.float().abs()
            worst = torch.argmax(diff / lim).item()
            parts.append(f"{name} max|kernel-plain| {diff.max().item():.3e}, "
                         f"worst element {diff.reshape(-1)[worst].item():.3e}"
                         f" of {lim.reshape(-1)[worst].item():.3e}")
            check(bool((diff <= lim).all()), f"mlstm {case}: {name} above "
                  f"atol {atol:g} + rtol {rtol:g} at element {worst}")
            if name == "h" and case == MLSTM_TRAIN_CASE:
                err["mlstm"] = diff.max().item()
        dm = (m - pm).abs().max().item()
        print(f"[mlstm] {shape} chunk {chunk} {dtype}: " + "; ".join(parts)
              + f"; max|m-m_plain| {dm:.3e} (tol {MLSTM_M_TOL:g}; h, C, n at"
              f" atol {atol:g}, rtol {rtol:g})", flush=True)
        check(dm <= MLSTM_M_TOL, f"mlstm {case}: m differs by {dm}")
        if case == MLSTM_TRAIN_CASE:
            # the training restart is checked bit for bit: a second launch
            # on the same inputs must give the same bits
            h2, (c2, n2, m2) = mlstm.mlstm(*x, chunk=chunk)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       ((h, h2), (c, c2), (n, n2), (m, m2)))
            print(f"[mlstm] {shape} chunk {chunk} {dtype}: two launches "
                  f"bit-identical in h, C, n, m: {same}", flush=True)
            check(same, f"mlstm {case}: two launches differ")
            del h2, c2, n2, m2
        del x, h, c, n, m, ph, pc, pn, pm

    x = torch.randn(MOMENT_SHAPE, generator=gen, device="cuda") * 1e-3
    flat = x.reshape(-1)
    # one exact-tie block, as in the CPU tests: its scale is 1.0, so x/scale
    # lands on .5 and round-half-to-even decides (2.5 -> 2, 3.5 -> 4,
    # -0.5 -> -0); 127 and -126.5 sit at the clip
    ties = torch.tensor([127.0, 2.5, 3.5, -0.5, -126.5, 0.0], device="cuda")
    flat[:2048] = ties.repeat(2048 // ties.numel() + 1)[:2048]
    q, s = quant.quantize_blockwise(flat)
    qp, sp = ref.quantize_blockwise(flat)
    torch.cuda.synchronize()
    dq = (q.int() - qp.int()).abs().max().item()
    ds = (s - sp).abs().max().item()
    print(f"[quantize] {tuple(MOMENT_SHAPE)} f32 with one exact-tie block: "
          f"max|q-q_plain| {dq}, "
          f"max|scale-scale_plain| {ds:.3e} (tol 0: bit-identical)",
          flush=True)
    check(torch.equal(q, qp) and torch.equal(s, sp),
          "quantize_blockwise differs from its plain version")
    check(q[:6].tolist() == [127, 2, 4, 0, -126, 0] and s[0].item() == 1.0,
          f"quantize_blockwise tie block: {q[:6].tolist()}, scale "
          f"{s[0].item()}")
    err["quantize_blockwise"] = float(max(dq, ds))

    e = 0.0
    for out_dtype in (torch.float32, torch.bfloat16):
        xd = quant.dequantize_blockwise(q, s, out_dtype=out_dtype)
        xp = ref.dequantize_blockwise(q, s).to(out_dtype)
        torch.cuda.synchronize()
        de = (xd.float() - xp.float()).abs().max().item()
        print(f"[dequantize] -> {out_dtype}: max|kernel-plain| {de:.3e} "
              f"(tol 0: bit-identical)", flush=True)
        check(torch.equal(xd, xp), f"dequantize_blockwise ({out_dtype}) "
              f"differs from its plain version")
        e = max(e, de)
    err["dequantize_blockwise"] = e
    return err, bwd_ran


# ------------------------------------------------------------------ phase 3


def serving_restart(cfg, device, *, batch, prompt, gen_tokens, requests,
                    dram_capacity, train_state):
    """A serving path: build -> save through the burst buffer -> restore
    onto ``device`` -> serve. ``train_state``: the checkpoint is a
    training-layout state (params, AdamW moments quantized to int8, steps);
    otherwise params only, as a serving restart reads weights.

    Returns (timings, launches, ...) where launches are the kernel counts
    of the save -> restore -> serve run. Raises SystemExit on any
    mismatch."""
    import torch
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.checkpoint.bbckpt import BBCheckpointManager
    from repro_torch.core import BBConfig, BurstBufferSystem
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.common import map_tree
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW

    model = build_model(cfg)
    params = model.init(SEED, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    prompts = [torch.randint(1, cfg.vocab_size, (batch, prompt),
                             generator=gen, device=device)
               for _ in range(requests)]
    # tokens served from the un-saved params: the comparison, not counted
    expected = [serve_batch(cfg, model, params, p, gen_tokens=gen_tokens)
                for p in prompts]

    fresh = map_tree(torch.zeros_like, params)
    if train_state:
        # random moments stand in for trained ones (the update rule and the
        # train step come with the training path)
        opt = AdamW(lr=lambda step: 0.0).init(params)
        for leaf in ser.tree_paths(opt.m):
            leaf[1].normal_(0.0, 1e-3, generator=gen)
        for leaf in ser.tree_paths(opt.v):
            leaf[1].normal_(0.0, 1e-6, generator=gen)
        state = {"params": params,
                 "opt_state": opt._replace(step=torch.tensor(
                     STEP, dtype=torch.int32, device=device)),
                 "data": {"step": torch.tensor(STEP * batch,
                                               dtype=torch.int32,
                                               device=device)}}
        target = {"params": fresh, "opt_state": AdamW(lr=None).init(fresh),
                  "data": {"step": torch.zeros((), dtype=torch.int32,
                                               device=device)}}
        print("[main] real optimizer moments wait for the training path: "
              "m, v are seeded random tensors", flush=True)
    else:
        state, target = {"params": params}, {"params": fresh}

    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    t = {}
    bbcfg = BBConfig(num_servers=4, num_clients=4, dram_capacity=dram_capacity)
    with BurstBufferSystem(bbcfg) as bb:
        mgr = BBCheckpointManager(bb, quantize=True)
        t0 = time.perf_counter()
        mgr.save(STEP, state)
        t["save_s"] = time.perf_counter() - t0
        t["ckpt_bytes"] = mgr.metrics[STEP]["bytes"]
        stores = [srv.store for srv in bb.servers.values()]
        print(f"[bb] {cfg.name}: after the save, "
              f"{sum(st.dram_used for st in stores)} bytes in the servers' "
              f"DRAM, {sum(st.ssd_used for st in stores)} spilled to their "
              f"SSD logs", flush=True)
        mgr.wait_flushes(timeout=600.0)
        t["flush_s"] = mgr.metrics[STEP].get("flush_s")
        check(mgr.metrics[STEP].get("flushed"), f"the checkpoint was not "
              f"durable on the PFS after {t['flush_s']} s")
        host_memory(f"{cfg.name} save and flush")
        t0 = time.perf_counter()
        restored, step = mgr.restore(target)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t["restore_s"] = time.perf_counter() - t0
        host_memory(f"{cfg.name} restore")
        served = [serve_batch(cfg, model, restored["params"], p,
                              gen_tokens=gen_tokens) for p in prompts]
    launches = {fn.__name__: fn.launches for fn in kernels}
    del fresh, target

    check(step == STEP, f"restored step {step} != {STEP}")
    n_leaves, n_quant, worst = compare_restored(state, restored)
    for r, (a, b) in enumerate(zip(served, expected)):
        check(a.shape == (batch, gen_tokens), f"request {r}: {a.shape}")
        check(torch.equal(a, b), f"request {r}: restored params served "
              f"other tokens")
    moments = (f", moments within {worst:.3f} of their int8 bound"
               if train_state else "")
    print(f"[main] {n_leaves} leaves ({n_quant} int8), {t['ckpt_bytes']} "
          f"checkpoint bytes; params bit-exact{moments}, {requests} x "
          f"{batch} requests served {gen_tokens} tokens each equal to the "
          f"un-saved params'", flush=True)
    return t, launches, (model, restored["params"], prompts[0], n_quant)


def compare_restored(state, restored):
    """Every leaf of ``restored`` against the saved ``state``: same device,
    dtype and shape; the leaves the serializer's quant policy sends through
    int8 within their bound, everything else bit for bit. Returns (leaves,
    int8 leaves, worst int8 error as a share of its bound)."""
    import torch
    from repro_torch.checkpoint import serializer as ser
    src = dict(ser.tree_paths(state))
    got = dict(ser.tree_paths(restored))
    check(list(got) == list(src), "restored tree has other leaves")
    worst, n_quant = 0.0, 0
    for name, leaf in src.items():
        out = got[name]
        check(out.device == leaf.device and out.dtype == leaf.dtype
              and out.shape == leaf.shape, f"{name}: restored as {out.dtype}"
              f" {tuple(out.shape)} on {out.device}")
        if not ser.default_quant_policy(name, leaf):
            check(torch.equal(out, leaf), f"{name}: not bit-exact")
            continue
        n_quant += 1
        err = (out.float() - leaf.float()).reshape(-1).abs()
        share = (err / _int8_bound(leaf)).max().item()
        check(share <= 1.0, f"{name}: int8 error {share:.3f} of its bound")
        worst = max(worst, share)
    return len(src), n_quant, worst


def _int8_bound(leaf):
    """The elementwise bound on an int8 round trip of ``leaf`` (flat, f32):
    half an int8 step of its 2048-element block, the step max|x| / 127
    floored at 1e-12 as the quantizer floors it, with 1e-4 of f32 slack
    (x / scale and q * scale each round once in f32). A bf16 leaf goes f32
    -> int8 -> f32 -> bf16, so one more bf16 rounding, at most 2^-8 of the
    dequantized value |x| + step / 2, is added to its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.checkpoint import serializer as ser
    x = leaf.float().reshape(-1)
    n = x.numel()
    block = F.pad(x.abs(), (0, (-n) % ser.QUANT_BLOCK)).view(
        -1, ser.QUANT_BLOCK).amax(dim=1)
    half = (block / 127).clamp_min(1e-12).repeat_interleave(
        ser.QUANT_BLOCK)[:n] / 2 * (1 + 1e-4)
    if leaf.dtype == torch.bfloat16:
        half = half + 2.0 ** -8 * (x.abs() + half)
    return half


def _kernels():
    """Every kernel wrapper of the port; each counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import rg_lru
    return (fa.flash_attention, fa.flash_attention_bwd, rg_lru.rg_lru,
            mlstm.mlstm, quant.quantize_blockwise,
            quant.dequantize_blockwise)


def training_restart(cfg, device, *, batch, seq, steps, dram_capacity):
    """A training path through ``launch/train.py::train_loop`` (slice 3's
    xlstm-350m, slice 4's starcoder2-3b), deterministic on the card: run A
    takes ``steps`` steps of ``batch`` x ``seq`` tokens; run B takes half of
    them, checkpoints unquantized into a burst buffer of 4 servers of
    ``dram_capacity`` bytes each, loses server/0, restores from the
    replicas into a state drawn from another seed and takes the rest. B
    must equal A bit for bit. A's final state then makes an int8-moment
    checkpoint in a fresh burst buffer, restored onto the card.

    Returns (timings, launches, n_quant); launches are the kernel counts of
    the whole path. Raises SystemExit on any mismatch."""
    import torch
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.checkpoint.bbckpt import BBCheckpointManager
    from repro_torch.core import BBConfig, BurstBufferSystem
    from repro_torch.launch.train import train_loop
    from repro_torch.models.common import map_tree

    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    t = {}
    half = steps // 2
    kw = dict(global_batch=batch, seq_len=seq, log_every=1, device=device)
    bbcfg = BBConfig(num_servers=4, num_clients=4,
                     dram_capacity=dram_capacity)
    state_a, hist_a, _ = train_loop(cfg, steps=steps, ckpt_every=0,
                                    seed=SEED, **kw)
    with BurstBufferSystem(bbcfg) as bb:
        saved_b, hist_b, mgr = train_loop(cfg, steps=half,
                                          ckpt_every=half - 1, bb_system=bb,
                                          quantize_ckpt=False, seed=SEED,
                                          **kw)
        t["save_s"] = mgr.metrics[half - 1]["ingest_s"]
        t["ckpt_bytes"] = mgr.metrics[half - 1]["bytes"]
        t["flush_s"] = mgr.metrics[half - 1].get("flush_s")
        bb.kill_server("server/0")
        print("[main] killed server/0; restoring from its replicas into a "
              f"state drawn from seed {SEED + 1}", flush=True)
        _batch_build_ms(cfg, batch, seq, half)
        state_b, hist_b2, mgr = train_loop(cfg, steps=steps, ckpt_every=0,
                                           bb_system=bb, restore=True,
                                           seed=SEED + 1, **kw)
        t["restore_s"] = mgr.metrics[half - 1].get("restore_s")
        if hist_b + hist_b2 != hist_a:
            _diagnose_restore(mgr, half - 1, saved_b)
        del saved_b
    del bb, mgr
    release_host_memory()
    check(t["restore_s"] is not None and [s for s, _ in hist_b2]
          == list(range(half, steps)), f"run B did not resume at step "
          f"{half}: {hist_b2}")
    check(hist_b + hist_b2 == hist_a, f"losses of run B {hist_b + hist_b2} "
          f"!= run A's {hist_a}")
    check(all(torch.isfinite(torch.tensor(l)) for _, l in hist_a),
          f"non-finite loss: {hist_a}")
    a_leaves = dict(ser.tree_paths(state_a))
    b_leaves = dict(ser.tree_paths(state_b))
    check(list(a_leaves) == list(b_leaves), "run B's state has other leaves")
    for name, leaf in a_leaves.items():
        check(torch.equal(leaf, b_leaves[name]), f"{name}: run B differs "
              f"from the uninterrupted run A")
    print(f"[main] losses {[round(l, 4) for _, l in hist_a]}; run B (kill, "
          f"restore at step {half}) equals run A bit for bit in all "
          f"{len(a_leaves)} leaves of params and optimizer state",
          flush=True)
    del state_b, b_leaves

    # the step-``steps`` state through an int8-moment checkpoint
    state = {"params": state_a.params, "opt_state": state_a.opt_state,
             "data": {"step": torch.tensor(steps, dtype=torch.int32,
                                           device=device)}}
    target = map_tree(torch.zeros_like, state)
    with BurstBufferSystem(bbcfg) as bb:
        mgr = BBCheckpointManager(bb, quantize=True)
        t0 = time.perf_counter()
        mgr.save(steps, state)
        t["qsave_s"] = time.perf_counter() - t0
        t["qckpt_bytes"] = mgr.metrics[steps]["bytes"]
        mgr.wait_flushes(timeout=600.0)
        t["qflush_s"] = mgr.metrics[steps].get("flush_s")
        t0 = time.perf_counter()
        restored, step = mgr.restore(target)
        torch.cuda.synchronize()
        t["qrestore_s"] = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    check(step == steps, f"restored step {step} != {steps}")
    n_leaves, n_quant, worst = compare_restored(state, restored)
    print(f"[main] int8 checkpoint of the step-{steps} state: {n_leaves} "
          f"leaves ({n_quant} int8, real optimizer moments), "
          f"{t['qckpt_bytes']} bytes; params bit-exact, int8 leaves within "
          f"{worst:.3f} of their bound", flush=True)
    return t, launches, n_quant


def _batch_build_ms(cfg, batch, seq, step, reps=3):
    """Print and return the host ms the data stream takes to build its batch
    at ``step`` (the pipeline ``train_loop`` makes), the slowest of
    ``reps``, with the burst buffer's threads running. The reference's
    ``load_state_dict`` waits 2 s for a running prefetch to stop; a batch
    that takes longer lets the old stream's batch through
    (``tests/test_torch_train.py::test_first_batches_after_a_restore``)."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    pipe = SyntheticLMPipeline(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        enc_seq=cfg.encoder_seq, enc_dim=cfg.encoder_dim)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipe._batch_at(step)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[data] {cfg.name}: a batch of {batch} x {seq} tokens builds in "
          f"{max(times):.3f} ms on the host (slowest of {reps}: "
          f"{', '.join(f'{t:.3f}' for t in times)}; the reference's "
          f"restore waits 2000 ms for a running prefetch)", flush=True)
    return max(times)


def _diagnose_restore(mgr, step, saved):
    """After a resume that diverged: restore the step's checkpoint once
    more, from the same burst buffer, and print which leaves differ from
    the state that was saved (none: the buffer gave the state back, and
    the divergence came after the restore)."""
    import torch
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.models.common import map_tree
    target = {"params": map_tree(torch.zeros_like, saved.params),
              "opt_state": map_tree(torch.zeros_like, saved.opt_state),
              "data": {"step": torch.zeros((), dtype=torch.int32,
                                           device=saved.opt_state.step.device)}}
    restored, _ = mgr.restore(target, step)
    got = dict(ser.tree_paths({"params": restored["params"],
                               "opt_state": restored["opt_state"]}))
    bad = [name for name, leaf in ser.tree_paths(
        {"params": saved.params, "opt_state": saved.opt_state})
        if not torch.equal(leaf, got[name])]
    print(f"[diag] a second restore of the step-{step} checkpoint: "
          f"{len(bad)} leaves differ from the saved state {bad[:8]}; data "
          f"step {int(restored['data']['step'])}", flush=True)


# glibc's mallopt parameter for the size from which malloc maps memory
# of its own, which free hands back to the system at once
M_MMAP_THRESHOLD = -3


def cap_mmap_threshold():
    """Serve every host allocation of 1 MiB or more (the burst buffer's
    4 MiB chunks and their copies) from mmap. glibc's default threshold
    rises to 32 MiB after the first such frees, and then freed chunks stay
    in the heaps of the buffer's many threads, each with its own arena;
    without this cap, phase 3g's 12.95 GB save and flush peaked at up to
    92 GiB of an H100 host's 96."""
    import ctypes
    check(ctypes.CDLL("libc.so.6").mallopt(M_MMAP_THRESHOLD, 1 << 20) == 1,
          "mallopt(M_MMAP_THRESHOLD) failed")


def release_host_memory():
    """Collect garbage (the burst buffer's threads and stores form
    reference cycles, so a closed buffer's DRAM store and shuffle buffers
    outlive it until the collector runs) and hand the freed heap back to
    the system (glibc keeps it in its arenas otherwise), so that the next
    buffer starts from what is live: the machine has 96 GiB, and a save,
    flush and restore holds about six times its checkpoint's bytes."""
    import ctypes
    import gc
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def host_memory(what: str):
    """``release_host_memory`` and print this process's resident host
    memory, now and at its peak so far."""
    import resource
    release_host_memory()
    rss = next((line.split(":", 1)[1].strip()
                for line in open("/proc/self/status")
                if line.startswith("VmRSS")), "not measured")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss   # kB
    print(f"[host] after {what} at {time.perf_counter() - T_START:.1f}s: "
          f"resident memory {rss} (peak so far {peak} kB)", flush=True)


# ------------------------------------------------------------------ phase 4


def device_profile(what: str, fn, scope: str = ""):
    """Run ``fn`` once under torch.profiler and print its wall time, the
    device's busy time (sum of kernel and copy times) and top kernels. The
    traced run is separate from the timed ones: tracing slows the host.
    ``scope``: the name of ``record_function`` ranges inside ``fn``; the
    device time of the kernels launched inside them is printed by the op
    that launched each (``_scope_device_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        # a record_function range's device-side copy is not a kernel
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not by_name:
        print(f"[profile] {what}: wall {wall_ms:.3f} ms; device busy not "
              f"measured (the profiler recorded no device events)",
              flush=True)
        return
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    port = [(_kernel_label(name), ms) for name, ms in top
            if PORT_KERNEL.search(name)]
    print(f"[profile] {what}: wall {wall_ms:.3f} ms (traced), device busy "
          f"{busy:.3f} ms = {100 * busy / wall_ms:.1f}% (idle "
          f"{100 - 100 * busy / wall_ms:.1f}%); top: " + "; ".join(
              f"{name[:60]} {ms:.3f} ms" for name, ms in top[:6])
          + "; the port's kernels: " + ("; ".join(
              f"{name} {ms:.3f} ms" for name, ms in port) or "none"),
          flush=True)
    if scope:
        by_op = _scope_device_ms(prof, scope)
        inside = sum(by_op.values())
        products = sum(ms for op, ms in by_op.items() if op in MATMUL_OPS)
        rest = sorted(((op, ms) for op, ms in by_op.items()
                       if op not in MATMUL_OPS), key=lambda kv: -kv[1])
        print(f"[profile] {what}, inside '{scope}': {inside:.3f} ms = "
              f"{100 * inside / busy:.1f}% of the busy time; products "
              f"({', '.join(sorted(op for op in by_op if op in MATMUL_OPS))})"
              f" {products:.3f} ms = {100 * products / max(inside, 1e-9):.1f}"
              f"%, the rest (routing, sort, gathers, scatter, combine, "
              f"activation) {inside - products:.3f} ms = "
              f"{100 * (inside - products) / max(inside, 1e-9):.1f}%: "
              + "; ".join(f"{op} {ms:.3f} ms" for op, ms in rest[:8]),
              flush=True)


# the aten ops that run a matrix product's kernels
MATMUL_OPS = ("aten::bmm", "aten::mm", "aten::addmm", "aten::baddbmm")


def _scope_device_ms(prof, scope: str):
    """{aten op: device ms} of the kernels launched inside every CPU range
    named ``scope`` in ``prof``, each kernel under the op that launched it
    (its innermost CPU op)."""
    import torch
    by_op = {}
    stack = [e for e in prof.events() if e.name == scope
             and e.device_type == torch.autograd.DeviceType.CPU]
    while stack:
        e = stack.pop()
        ms = sum(k.duration for k in e.kernels) / 1e3
        if ms:
            by_op[e.name] = by_op.get(e.name, 0.0) + ms
        stack.extend(e.cpu_children)
    return by_op


def time_serving(cfg, model, params, prompts, gen_tokens):
    import torch
    b, s = prompts.shape
    with torch.inference_mode():
        def run_prefill():
            cache = model.init_cache(b, s + gen_tokens, device=prompts.device)
            return model.prefill(params, cache, prompts)

        def run_decode(logits, cache):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            for i in range(gen_tokens - 1):
                logits, cache = model.decode_step(params, cache, tok, s + i)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)

        for _ in range(2):
            run_prefill()
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            logits, cache = run_prefill()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        run_decode(logits, cache)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0

        # models/moe.py::apply_moe runs each MoE FFN in a range "moe"
        device_profile(f"{cfg.name} prefill (B={b}, S={s})", run_prefill,
                       scope="moe" if cfg.num_experts else "")
        logits, cache = run_prefill()
        device_profile(f"{cfg.name} decode ({gen_tokens - 1} steps, B={b})",
                       lambda: run_decode(logits, cache))
    return prefill_ms, b * (gen_tokens - 1) / decode_s


def serving_numbers(cfg, t, model, params, prompts, gen_tokens):
    b, s = prompts.shape
    prefill_ms, decode_tps = time_serving(cfg, model, params, prompts,
                                          gen_tokens)
    print(f"[numbers] {cfg.name}: save {t['save_s']:.3f}s (ingest of "
          f"{t['ckpt_bytes'] / 1e9:.3f} GB incl. on-card quantize), "
          f"flush {t['flush_s']}s (off the critical path), restore "
          f"{t['restore_s']:.3f}s, prefill {prefill_ms:.2f} ms "
          f"(B={b}, S={s}), decode {decode_tps:.1f} tok/s (B={b})",
          flush=True)


def _causal_pairs(case):
    """(q, k) pairs the causal and window masks leave, over every (b, h)."""
    b, s, _, h, _, _, _, window, *_ = case
    return b * h * sum(min(i + 1, window) if window else i + 1
                       for i in range(s))


def _flash_row(name, case, gen, launches, err, stats=False, plain_iters=20):
    """Kernel, plain version and SDPA at one flash shape; the bound counts
    the (q, k) pairs the causal and window masks leave; ``stats``: the
    kernel also writes the row statistics (the training path's forward),
    m and l counted in its bytes; ``plain_iters``: the plain version's
    timed calls (after one warm-up when fewer than 20). ``ms`` and
    ``library_ms`` are CUDA-event times of back-to-back calls from Python,
    which include whatever of each call's host cost the device does not
    hide; ``graph_ms`` and ``library_graph_ms`` are device times of one
    call, from a CUDA graph of many."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    b, s, _, h, kv, d, causal, window, *_ = case
    q, k, v = _attn_inputs(case, gen)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    pairs = _causal_pairs(case)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + (2 * 4 * b * s * h if stats else 0)
    bms, by = bound(nbytes, 4 * d * pairs, BF16_FLOPS)
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    kernel = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                        return_stats=stats)
    calls = 20 if pairs > 1e8 else 200   # graphs of ~10 to ~50 ms
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(lambda: ops.flash_chunked(q, k, v, causal=causal,
                                                      window=window),
                            iters=plain_iters,
                            warmup=3 if plain_iters >= 20 else 1),
        "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library),
        "graph_ms": graph_ms(kernel, calls=calls),
        "library_graph_ms": graph_ms(library, calls=calls),
    }


def _flash_bwd_row(name, case, gen, launches, err, ran):
    """The backward kernel, its plain version and SDPA's backward at a
    training shape ``case``. The bound: q, o, dO and dq, k, v, dk and dv in
    bf16 and m, l in f32, each moved once; the reference's five products
    (S = q k^T, dP = dO v^T, dv, dq, dk) over the (q, k) pairs the causal
    and window masks leave, 2 D operations a pair each, against the bf16
    tensor-core peak. The library time is one ``torch.autograd.grad``
    through ``scaled_dot_product_attention(..., enable_gqa=True)`` (causal,
    or a boolean mask for a window shorter than S) on the same inputs in its
    (B, H, S, D) layout, timed alone. ``ran``: the device kernels of a
    launch at this shape (phase 2's profile)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    s, d, causal, window = case[1], case[5], case[6], case[7]
    q, k, v = _attn_inputs(case, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    with torch.no_grad():
        o, m, l = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     return_stats=True)
    nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * 2 * m.numel()
    bms, by = bound(nbytes, 5 * 2 * d * _causal_pairs(case), BF16_FLOPS)
    kernel = lambda: fa.flash_attention_bwd(q, k, v, o, m, l, do,
                                            causal=causal, window=window)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                  for a in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = {"is_causal": True}
    if window and window < s:
        pos = torch.arange(s, device="cuda")
        mask = {"attn_mask": (pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window)}
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **mask)
        library = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True)
        library_ms = cuda_ms(library, iters=5, warmup=2)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # no Pallas counterpart: the reference's backward is plain jnp
        "replaces": "src/repro/kernels/ops.py:65",
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(kernel, iters=5, warmup=1),
        "plain_ms": cuda_ms(lambda: ops.flash_bwd_chunked(
            q, k, v, o, m, l, do, causal=causal, window=window), iters=3,
            warmup=1),
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        "graph_ms": graph_ms(kernel, calls=5), "kernels": ran,
    }


def graph_ms(fn, calls: int = 200) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed and timed with CUDA events, so the
    host's cost of each launch is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters=10, warmup=2) / calls


def _rg_lru_time(case, gen):
    """(kernel ms, plain ms, bound ms, bound by, kernel device ms) at one
    scan shape: a, gx and h0 read once, h and h_last written once; a
    multiply and an add per element. The device time is one call's, from
    a CUDA graph of many. At the decode shape (S = 1) each launch moves a
    few hundred KB, so there the first two are device times too."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru

    a, gx, h0 = _rg_lru_inputs(case, gen)
    b, s, d = a.shape
    n = b * s * d
    nbytes = a.element_size() * (3 * n + 2 * b * d)
    bms, by = bound(nbytes, 2 * n, F32_FLOPS)
    kernel = lambda: rg_lru.rg_lru(a, gx, h0)
    plain = lambda: ref.rg_lru(a, gx, h0)
    if s == 1:
        dev = graph_ms(kernel)
        return dev, graph_ms(plain), bms, by, dev
    return (cuda_ms(kernel), cuda_ms(plain, iters=3, warmup=1), bms, by,
            graph_ms(kernel, calls=20))


def _mlstm_row(gen, launches, err):
    """The mLSTM kernel, its plain version and its bound at the training
    shape: q, k, v and the gates read once, h, C, n and m written once; per
    chunk of each (b, h) two (c x c x D) products (q k^T and the weighted
    sum of v), of which the causal mask needs c (c + 1) / 2 of the c x c
    (t, u) pairs, and two (c x D x D) products (q C and the update of C)."""
    from repro_torch.kernels import mlstm, ops
    (b, s, h, d), chunk, *_ = MLSTM_TRAIN_CASE
    x = _mlstm_inputs(MLSTM_TRAIN_CASE, gen)
    es = x[0].element_size()
    nbytes = (es * 4 * b * s * h * d + 4 * 2 * b * s * h
              + es * (b * h * d * d + b * h * d) + 4 * b * h)
    pairs = chunk * (chunk + 1) // 2
    flops = 2 * b * h * (s // chunk) * (2 * pairs * d + 2 * chunk * d * d)
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    return {
        "name": "mlstm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:109",
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: mlstm.mlstm(*x, chunk=chunk), iters=5,
                      warmup=1),
        "plain_ms": cuda_ms(lambda: ops.mlstm_chunked(*x, chunk=chunk),
                            iters=3, warmup=1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def kernel_line(gen, launches, err, bwd_ran):
    """One row per kernel at the main paths' shapes. ``launches``: the
    kernel counts of each path's run, by config name (starcoder2-3b's
    serving and training runs as "starcoder2-3b" and "starcoder2-3b
    train"); ``bwd_ran``: the device kernels phase 2's profiled backward
    ran at each training shape, by row name."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import quantize as quant

    sc, rg = launches["starcoder2-3b"], launches["recurrentgemma-9b"]
    xl, sct = launches["xlstm-350m"], launches["starcoder2-3b train"]
    ds, h2o = launches["deepseek-coder-33b"], launches["h2o-danube-1.8b"]
    ll = launches["llama4-scout-17b-a16e"]
    with torch.inference_mode():
        rows = [_flash_row("flash_attention", PREFILL_CASE, gen,
                           sc["flash_attention"], err["flash_attention"]),
                _flash_row("flash_attention_d256", RG_PREFILL_CASE, gen,
                           rg["flash_attention"],
                           err["flash_attention_d256"])]
        ms, plain_ms, bms, by, gms = _rg_lru_time(RG_LRU_PREFILL, gen)
        dms, dplain_ms, dbms, dby, _ = _rg_lru_time(RG_LRU_DECODE, gen)
        rows.append({
            "name": "rg_lru", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
            "replaces": "src/repro/kernels/rg_lru.py:48",
            "launches": rg["rg_lru"], "max_abs_err": err["rg_lru"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "graph_ms": gms,
            # the same at the decode shape (B, 1, D), launched once a layer
            # in every decode step; device times from a CUDA graph
            "decode_ms": dms, "decode_plain_ms": dplain_ms,
            "decode_bound_ms": dbms, "decode_bound_by": dby,
        })
        x = torch.randn(MOMENT_SHAPE, generator=gen,
                        device="cuda").reshape(-1) * 1e-3
        n = x.numel()
        bms, by = bound(4 * n + n + 4 * n / 2048, 6 * n, F32_FLOPS)
        rows.append({
            "name": "quantize_blockwise", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:32",
            "launches": sc["quantize_blockwise"],
            "max_abs_err": err["quantize_blockwise"],
            "ms": cuda_ms(lambda: quant.quantize_blockwise(x)),
            "plain_ms": cuda_ms(lambda: ref.quantize_blockwise(x)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
        qx, sx = quant.quantize_blockwise(x)
        bms, by = bound(n + 4 * n / 2048 + 4 * n, n, F32_FLOPS)
        rows.append({
            "name": "dequantize_blockwise", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:56",
            "launches": sc["dequantize_blockwise"],
            "max_abs_err": err["dequantize_blockwise"],
            "ms": cuda_ms(lambda: quant.dequantize_blockwise(qx, sx)),
            "plain_ms": cuda_ms(lambda: ref.dequantize_blockwise(qx, sx)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
        rows.append(_mlstm_row(gen, xl["mlstm"], err["mlstm"]))
        # slices 4 and 5: the training paths' forward (with row statistics)
        rows.append(_flash_row("flash_attention_train", TRAIN_ATTN_CASE,
                               gen, sct["flash_attention"],
                               err["flash_attention_train"], stats=True))
        rows.append(_flash_row("flash_attention_train_dsc",
                               DS_TRAIN_ATTN_CASE, gen,
                               ds["flash_attention"],
                               err["flash_attention_train_dsc"], stats=True))
        # slice 6: the D = 80 prefill of h2o-danube's 4096-token window
        rows.append(_flash_row("flash_attention_d80", H2O_PREFILL_CASE, gen,
                               h2o["flash_attention"],
                               err["flash_attention_d80"]))
        # slice 7: llama4's prefill at head dim 128, 40 heads over 8 KV; the
        # row's launches are both layers' (one moe_local, one moe_nope a
        # request), its times the moe_local layer's 8192-token window (SDPA
        # with a boolean window mask) and, as nope_*, the moe_nope layer's
        # causal attention (SDPA with is_causal)
        row = _flash_row("flash_attention_llama4", LL_PREFILL_CASE, gen,
                         ll["flash_attention"],
                         err["flash_attention_llama4"], plain_iters=5)
        nope = _flash_row("flash_attention_llama4_nope", LL_NOPE_CASE, gen,
                          ll["flash_attention"],
                          err["flash_attention_llama4_nope"], plain_iters=5)
        row.update({f"nope_{key}": nope[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "graph_ms", "library_graph_ms")})
        rows.append(row)
    # the backward at the training shapes; no main path trains h2o-danube,
    # so its D = 80 row has no launches there
    for name, case, runs in (
            ("flash_attention_bwd", TRAIN_ATTN_CASE, sct),
            ("flash_attention_bwd_dsc", DS_TRAIN_ATTN_CASE, ds),
            ("flash_attention_bwd_d80", H2O_TRAIN_ATTN_CASE, h2o)):
        rows.append(_flash_bwd_row(name, case, gen,
                                   runs["flash_attention_bwd"], err[name],
                                   bwd_ran[name]))
    return rows


def training_path(cfg, device, *, batch, seq, steps, dram_capacity,
                  per_step):
    """A training phase: ``training_restart`` and ``time_training`` under
    torch's deterministic algorithms; the launch counts must be exactly
    ``per_step`` launches a step (run A's steps and run B's) of each kernel
    named there, the int8 checkpoint's quantize and dequantize launches,
    and none of any other kernel. Prints the path's numbers and returns the
    launch counts."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        t, launches, n_quant = training_restart(
            cfg, device, batch=batch, seq=seq, steps=steps,
            dram_capacity=dram_capacity)
        want = {name: 0 for name in launches}
        want.update({name: n * 2 * steps for name, n in per_step.items()})
        want.update(quantize_blockwise=n_quant, dequantize_blockwise=n_quant)
        print(f"[main] launches in train -> save -> kill -> restore -> "
              f"train -> int8 save -> restore: {launches} (expected "
              f"{want})", flush=True)
        check(all(launches[name] > 0 for name in per_step)
              and launches == want, f"launch counts {launches} != {want}")
        step_s, tok_s, peak_gb, layer_s, update_s = time_training(
            cfg, device, batch, seq)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[numbers] {cfg.name}: step {step_s:.3f}s ({tok_s:.1f} tok/s, "
          f"B={batch}, S={seq}), peak device memory {peak_gb:.2f} GB, "
          f"optimizer update {update_s:.4f}s", flush=True)
    print(f"[numbers] {cfg.name}: save {t['save_s']:.3f}s (ingest of "
          f"{t['ckpt_bytes']} bytes = {t['ckpt_bytes'] / 1e9:.3f} GB, "
          f"unquantized; {2 * t['ckpt_bytes'] / 4 / 2**30:.2f} GiB a server "
          f"at replication 2 over 4 servers of {dram_capacity / 2**30:.0f} "
          f"GiB), flush {t['flush_s']}s (off the critical path), restore "
          f"after the kill {t['restore_s']:.3f}s", flush=True)
    print(f"[numbers] {cfg.name}: int8 save {t['qsave_s']:.3f}s "
          f"({t['qckpt_bytes'] / 1e9:.3f} GB incl. on-card quantize), int8 "
          f"flush {t['qflush_s']}s, int8 restore {t['qrestore_s']:.3f}s",
          flush=True)
    print(f"[numbers] {cfg.name}: one block forward and backward: "
          + ", ".join(f"{kind} {sec:.3f}s" for kind, sec in layer_s.items()),
          flush=True)
    return launches


def _layers(cfg, kind):
    return sum(unit.count(kind) * reps for unit, reps in cfg.segments)


def time_training(cfg, device, batch, seq):
    """Step time, tokens/s and peak device memory of the train step at the
    path's shape (three steps after a warm-up one, deterministic as on the
    path), one profiled step, one forward and backward of each layer kind
    of the config, and the optimizer update's own seconds (host clock
    around ``synchronize``, after a warm-up update; the params stand in for
    the gradients)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.train import batch_to, build

    _, optimizer, state, step_fn = build(cfg, seed=SEED, device=device)
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch)
    batches = [batch_to(next(pipe), device) for _ in range(4)]
    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (len(batches) - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    device_profile(f"{cfg.name} train step (B={batch}, S={seq})",
                   lambda: step_fn(state, batches[0]))
    kinds = sorted({k for unit, _ in cfg.segments for k in unit})
    layer_s = {kind: _layer_seconds(cfg, state.params, kind, device, batch,
                                    seq) for kind in kinds}
    with torch.no_grad():
        optimizer.update(state.params, state.opt_state, state.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.update(state.params, state.opt_state, state.params)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    return step_s, batch * seq / step_s, peak_gb, layer_s, update_s


def _layer_seconds(cfg, params, kind, device, batch, seq, reps=2):
    """Host-clock seconds of one forward and backward of the first
    ``kind`` block of the trained params on a bf16 (B, S, d_model) input,
    after a warm-up pass."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.common import map_tree
    j = str(cfg.segments[0][0].index(kind))
    p = map_tree(lambda a: a[0].detach().requires_grad_(True),
                 params["segments"]["seg0"][j])
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16).requires_grad_(True)
    ext = {"positions": torch.arange(seq, dtype=torch.int32,
                                     device=device).expand(batch, seq)}
    apply = transformer.KINDS[kind].apply

    def run():
        apply(cfg, p, x, ext).float().square().mean().backward()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def llama4_path(device):
    """Phase 3g, the serving restart of slice 7: llama4-scout-17b-a16e at
    full width from a params-only checkpoint, one layer of each of its two
    kinds (``LL_SEGMENTS``), prompts past its window. Prints the path's
    numbers and returns its launch counts."""
    import torch
    from repro_torch.configs.base import get_config
    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, segments=LL_SEGMENTS)
    check(cfg.resolved_head_dim == LL_HEAD_DIM
          and cfg.window_size == LL_WINDOW
          and (cfg.num_heads, cfg.num_kv_heads) == (LL_HEADS, LL_KV)
          and (cfg.num_experts, cfg.top_k) == (16, 1),
          "llama4-scout-17b-a16e shapes")
    print(f"[main] {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, head_dim "
          f"{cfg.resolved_head_dim}, {cfg.num_experts} experts at "
          f"top-{cfg.top_k} of d_ff {cfg.d_ff_expert} and "
          f"{cfg.num_shared_experts} shared of d_ff {cfg.d_ff_shared}, "
          f"capacity factor {cfg.capacity_factor}, window "
          f"{cfg.window_size} (moe_local; rope_theta {cfg.rope_theta:g})"
          f", moe_nope without rotary embedding, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}), reduced: segments {full.segments} -> "
          f"{cfg.segments}, num_layers {full.num_layers} -> "
          f"{cfg.num_layers}; {cfg.param_count()} params "
          f"({full.param_count()} at full depth); prompt {LL_PROMPT} past the "
          f"window; params-only checkpoint over 4 servers of "
          f"{LL_DRAM / 2**30:.0f} GiB DRAM", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t, launches, (model, params, prompts, n_quant) = \
        serving_restart(cfg, device, batch=LL_BATCH, prompt=LL_PROMPT,
                        gen_tokens=LL_GEN, requests=LL_REQUESTS,
                        dram_capacity=LL_DRAM, train_state=False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": (_layers(cfg, "moe_local")
                                + _layers(cfg, "moe_nope")) * LL_REQUESTS,
            "flash_attention_bwd": 0, "rg_lru": 0, "mlstm": 0,
            "quantize_blockwise": n_quant, "dequantize_blockwise": n_quant}
    print(f"[main] launches in save -> restore -> serve: {launches} "
          f"(expected {want})", flush=True)
    check(launches == want and launches["flash_attention"] == 6,
          f"launch counts {launches} != {want}")
    print(f"[numbers] {cfg.name}: peak device memory {peak_gb:.2f} GB "
          f"over save -> restore -> serve (the un-saved params, the zero "
          f"target and the restored params: "
          f"{3 * 2 * cfg.param_count() / 1e9:.2f} GB); checkpoint "
          f"{t['ckpt_bytes']} bytes, "
          f"{2 * t['ckpt_bytes'] / 4 / 2**30:.2f} GiB a server",
          flush=True)
    serving_numbers(cfg, t, model, params, prompts, LL_GEN)
    return launches


def main():
    # cuBLAS is deterministic only with a fixed workspace, set before CUDA
    # starts; the training path runs twice and is compared bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
                 f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    cap_mmap_threshold()
    t_start = time.perf_counter()
    device = torch.device("cuda")

    environment()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    err, bwd_ran = check_kernels(gen)
    host_memory("phase 2")

    # phase 3: slice 1's path, starcoder2-3b from a training-layout state
    from repro_torch.configs.base import get_config
    cfg = get_config("starcoder2-3b")
    cfg = dataclasses.replace(cfg, segments=((("attn",), LAYERS),))
    print(f"[main] {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size},"
          f" {cfg.param_dtype}), reduced: num_layers 30 -> {LAYERS}; "
          f"{cfg.param_count()} params", flush=True)
    t, launches, (model, params, prompts, n_quant) = serving_restart(
        cfg, device, batch=BATCH, prompt=PROMPT, gen_tokens=GEN,
        requests=REQUESTS, dram_capacity=2 << 30, train_state=True)
    want = {"flash_attention": LAYERS * REQUESTS, "flash_attention_bwd": 0,
            "rg_lru": 0, "mlstm": 0, "quantize_blockwise": n_quant,
            "dequantize_blockwise": n_quant}
    print(f"[main] launches in save -> restore -> serve: {launches} "
          f"(expected {want})", flush=True)
    check(launches == want, f"launch counts {launches} != {want}")
    serving_numbers(cfg, t, model, params, prompts, GEN)
    del model, params, prompts
    host_memory("phase 3")

    # phase 3b: slice 2's path, recurrentgemma-9b from a params-only
    # checkpoint; depth cut as the reference's reduced() cuts it
    full = get_config("recurrentgemma-9b")
    rg_cfg = dataclasses.replace(full, segments=tuple(
        (unit, min(reps, 1)) for unit, reps in full.segments))
    check(rg_cfg.resolved_head_dim == RG_HEAD_DIM
          and rg_cfg.window_size == RG_WINDOW
          and rg_cfg.lru_width == RG_WIDTH, "recurrentgemma-9b shapes")
    print(f"[main] {rg_cfg.name} full width (d_model {rg_cfg.d_model}, "
          f"{rg_cfg.num_heads} heads / {rg_cfg.num_kv_heads} kv, head_dim "
          f"{rg_cfg.resolved_head_dim}, d_ff {rg_cfg.d_ff} GeGLU, lru_width "
          f"{rg_cfg.lru_width}, conv {rg_cfg.conv1d_width}, window "
          f"{rg_cfg.window_size}, vocab {rg_cfg.vocab_size}, "
          f"{rg_cfg.param_dtype}), reduced: segments {full.segments} -> "
          f"{rg_cfg.segments}, num_layers {full.num_layers} -> "
          f"{rg_cfg.num_layers}; {rg_cfg.param_count()} params; prompt "
          f"{RG_PROMPT} past the window", flush=True)
    rg_t, rg_launches, (rg_model, rg_params, rg_prompts, rg_quant) = \
        serving_restart(rg_cfg, device, batch=RG_BATCH, prompt=RG_PROMPT,
                        gen_tokens=RG_GEN, requests=RG_REQUESTS,
                        dram_capacity=4 << 30, train_state=False)
    rg_want = {"flash_attention": _layers(rg_cfg, "attn_local")
               * RG_REQUESTS, "flash_attention_bwd": 0,
               "rg_lru": _layers(rg_cfg, "rglru") * RG_GEN * RG_REQUESTS,
               "mlstm": 0, "quantize_blockwise": rg_quant,
               "dequantize_blockwise": rg_quant}
    print(f"[main] launches in save -> restore -> serve: {rg_launches} "
          f"(expected {rg_want})", flush=True)
    check(rg_launches == rg_want, f"launch counts {rg_launches} != "
          f"{rg_want}")
    serving_numbers(rg_cfg, rg_t, rg_model, rg_params, rg_prompts, RG_GEN)
    del rg_model, rg_params, rg_prompts
    host_memory("phase 3b")

    # phase 3c: slice 3's path, xlstm-350m training through a server kill;
    # depth cut as the reference's reduced() cuts it
    full = get_config("xlstm-350m")
    xl_cfg = dataclasses.replace(full, segments=tuple(
        (unit, min(reps, 1)) for unit, reps in full.segments))
    check(int(xl_cfg.d_model * xl_cfg.mlstm_proj_factor)
          // xl_cfg.num_heads == XL_HEAD_DIM
          and xl_cfg.num_heads == XL_HEADS, "xlstm-350m shapes")
    print(f"[main] {xl_cfg.name} full width (d_model {xl_cfg.d_model}, "
          f"{xl_cfg.num_heads} heads, mLSTM head dim {XL_HEAD_DIM}, conv "
          f"{xl_cfg.conv1d_width}, vocab {xl_cfg.vocab_size}, params "
          f"{xl_cfg.param_dtype}, compute {xl_cfg.compute_dtype}), reduced: "
          f"segments {full.segments} -> {xl_cfg.segments}, num_layers "
          f"{full.num_layers} -> {xl_cfg.num_layers}; "
          f"{xl_cfg.param_count()} params; batch {XL_BATCH} x {XL_SEQ} "
          f"tokens, {XL_STEPS} steps", flush=True)
    xl_launches = training_path(
        xl_cfg, device, batch=XL_BATCH, seq=XL_SEQ, steps=XL_STEPS,
        dram_capacity=XL_DRAM, per_step={"mlstm": _layers(xl_cfg, "mlstm")})
    host_memory("phase 3c")

    # phase 3d: slice 4's path, starcoder2-3b training through a server
    # kill; depth cut to LAYERS as in phase 3
    n = cfg.param_count()
    ckpt = 2 * n + 2 * 4 * n          # bf16 params, f32 AdamW m and v
    print(f"[main] {cfg.name} training, full width as in phase 3, params "
          f"{cfg.param_dtype}, compute {cfg.compute_dtype}, grad "
          f"accumulation and AdamW moments {cfg.grad_accum_dtype}; "
          f"reduced: num_layers 30 -> {LAYERS}; {n} params; batch "
          f"{SC_BATCH} x {SC_SEQ} tokens, {SC_STEPS} steps; unquantized "
          f"checkpoint {ckpt / 1e9:.3f} GB, {2 * ckpt / 4 / 2**30:.2f} GiB "
          f"a server at replication 2 over 4 servers of "
          f"{SC_DRAM / 2**30:.0f} GiB DRAM", flush=True)
    sc_launches = training_path(
        cfg, device, batch=SC_BATCH, seq=SC_SEQ, steps=SC_STEPS,
        dram_capacity=SC_DRAM,
        per_step={"flash_attention": LAYERS, "flash_attention_bwd": LAYERS})
    host_memory("phase 3d")

    # phase 3e: slice 5's path, deepseek-coder-33b training (Adafactor)
    # through a server kill; depth cut to DS_LAYERS
    full = get_config("deepseek-coder-33b")
    ds_cfg = dataclasses.replace(full, segments=((("attn",), DS_LAYERS),))
    check(ds_cfg.optimizer == "adafactor" and ds_cfg.resolved_head_dim
          == DS_TRAIN_ATTN_CASE[5] and (ds_cfg.num_heads, ds_cfg.num_kv_heads)
          == DS_TRAIN_ATTN_CASE[3:5], "deepseek-coder-33b shapes")
    n = ds_cfg.param_count()
    print(f"[main] {ds_cfg.name} training, full width (d_model "
          f"{ds_cfg.d_model}, {ds_cfg.num_heads} heads / "
          f"{ds_cfg.num_kv_heads} kv, head_dim {ds_cfg.resolved_head_dim}, "
          f"d_ff {ds_cfg.d_ff}, vocab {ds_cfg.vocab_size}, params "
          f"{ds_cfg.param_dtype}, compute {ds_cfg.compute_dtype}, grad "
          f"accumulation {ds_cfg.grad_accum_dtype}), Adafactor (momentum "
          f"0.9 in bf16, factored f32 second moments); reduced: num_layers "
          f"{full.num_layers} -> {DS_LAYERS}; {n} params; batch {DS_BATCH} x "
          f"{DS_SEQ} tokens, {DS_STEPS} steps; unquantized checkpoint about "
          f"{4 * n / 1e9:.2f} GB (bf16 params and m) and the second "
          f"moments, over 4 servers of {DS_DRAM / 2**30:.0f} GiB DRAM",
          flush=True)
    ds_launches = training_path(
        ds_cfg, device, batch=DS_BATCH, seq=DS_SEQ, steps=DS_STEPS,
        dram_capacity=DS_DRAM,
        per_step={"flash_attention": DS_LAYERS,
                  "flash_attention_bwd": DS_LAYERS})
    host_memory("phase 3e")

    # phase 3f: slice 6's path, h2o-danube-1.8b at full width and depth
    # from a params-only checkpoint, prompts past its window
    h2o_cfg = get_config("h2o-danube-1.8b")
    check(h2o_cfg.resolved_head_dim == H2O_HEAD_DIM
          and h2o_cfg.window_size == H2O_WINDOW
          and (h2o_cfg.num_heads, h2o_cfg.num_kv_heads)
          == (H2O_HEADS, H2O_KV), "h2o-danube-1.8b shapes")
    print(f"[main] {h2o_cfg.name} full width and depth (d_model "
          f"{h2o_cfg.d_model}, {h2o_cfg.num_heads} heads / "
          f"{h2o_cfg.num_kv_heads} kv, head_dim {h2o_cfg.resolved_head_dim}, "
          f"d_ff {h2o_cfg.d_ff}, window {h2o_cfg.window_size}, vocab "
          f"{h2o_cfg.vocab_size}, {h2o_cfg.num_layers} layers, "
          f"{h2o_cfg.param_dtype}); {h2o_cfg.param_count()} params; prompt "
          f"{H2O_PROMPT} past the window", flush=True)
    h2o_t, h2o_launches, (h2o_model, h2o_params, h2o_prompts, h2o_quant) = \
        serving_restart(h2o_cfg, device, batch=H2O_BATCH, prompt=H2O_PROMPT,
                        gen_tokens=H2O_GEN, requests=H2O_REQUESTS,
                        dram_capacity=H2O_DRAM, train_state=False)
    h2o_want = {"flash_attention": _layers(h2o_cfg, "attn_local")
                * H2O_REQUESTS, "flash_attention_bwd": 0, "rg_lru": 0,
                "mlstm": 0, "quantize_blockwise": h2o_quant,
                "dequantize_blockwise": h2o_quant}
    print(f"[main] launches in save -> restore -> serve: {h2o_launches} "
          f"(expected {h2o_want})", flush=True)
    check(h2o_launches == h2o_want and h2o_launches["flash_attention"] > 0,
          f"launch counts {h2o_launches} != {h2o_want}")
    serving_numbers(h2o_cfg, h2o_t, h2o_model, h2o_params, h2o_prompts,
                    H2O_GEN)
    del h2o_model, h2o_params, h2o_prompts
    host_memory("phase 3f")

    # phase 3g: slice 7's path, llama4-scout-17b-a16e at full width
    ll_launches = llama4_path(device)
    host_memory("phase 3g")

    rows = kernel_line(gen, {"starcoder2-3b": launches,
                             "recurrentgemma-9b": rg_launches,
                             "xlstm-350m": xl_launches,
                             "starcoder2-3b train": sc_launches,
                             "deepseek-coder-33b": ds_launches,
                             "h2o-danube-1.8b": h2o_launches,
                             "llama4-scout-17b-a16e": ll_launches}, err,
                       bwd_ran)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
