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
     head dim 256 within one bf16 ulp); both RG-LRU forward kernels (the
     ring at S >= one time tile, the step kernel below), with and without
     the f32 carry they write under autograd, and the RG-LRU backward
     kernel bit for bit in f32 and bf16 at the recurrentgemma prefill,
     decode and training (2, 4096, 4096) shapes, ragged S and D, rows off
     16-byte boundaries, B = 1, h0 and dh_last given and None, two launches
     bit-identical at the prefill shape (the forward) and the training
     shape (both), and autograd through the kernels' Function there equal
     to the kernels; the mLSTM forward at the reference's three test shapes (f32, the CUDA-core
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
     bf16 at every head dim and the CUDA-core ones for f32; the
     stats-emitting forward's o bit for bit the stats-free one's and its
     m, l within 1e-4 of the plain forward's. Head dim 80 (h2o-danube-1.8b)
     in f32 and bf16, forward and backward: a window edge inside a ragged
     tile and a q offset with Sq < Sk at GQA 4 (32 heads / 8 kv), the h2o
     prefill shape (4, 5120, 32, 8, 80, window 4096) and a training-like
     backward (8, 2048, 32, 8, 80, window 4096); the forward and backward
     at deepseek-coder-33b's training shape (8, 2048, 56, 8, 128); and the
     forward at llama4-scout-17b-a16e's prefill shape (4, 8704, 40, 8, 128)
     with its 8192-token window and without a window (NoPE), bf16 within
     one bf16 ulp. Head dim 192 (deepseek-v3-671b's MLA prefill, V padded
     from 128): causal, ragged Sk and q-offset cases in f32 (2e-5) and bf16
     (3e-2), a small windowed bf16 case within one bf16 ulp, and the
     prefill shape (4, 4096, 128, 128, 192) bf16, held per element like
     llama4's, launched twice (bit-identical) and seen by the profiler in
     ``flash_mma_kernel<192>``; the bf16 D = 256 backward at its dk and dv
     blocks' edges (gemma3-4b's 8 / 4 heads with its 1024 window at a
     ragged S, a q offset, non-causal Sq != Sk, softcap), at
     recurrentgemma-9b's attention over 8 x 2048 tokens and, with the
     forward with row statistics, at its training shape (2, 4096, 16, 1,
     256) with its 2048 window (two launches bit-identical; the forward
     held per element like llama4's, the backward like whisper's). The backward at head dim 192 on the D = 192 cases in
     f32 (2e-5) and bf16 (one bf16 ulp), on bf16 cases at its dk and dv
     blocks' edges with MLA's heads (a q offset with Sq < Sk, non-causal
     Sq != Sk, V and dO zero in their last 64 columns, where dv must come
     out exactly zero) and at deepseek-v3-671b's training calls (4, 2048,
     128, 128, 192) and (4, 2047, ...) with V padded, two launches
     bit-identical at each. Head dim 64
     without a causal mask in f32 and bf16: Sk ragged in the 64-key tiles,
     with Sq = Sk and Sq != Sk; whisper-large-v3's three prefill shapes in
     bf16 (the encoder's (4, 1500, 20, 64) and the decoder's cross shape of
     224 queries over 1500 keys, non-causal; its causal self-attention over
     224), held per element like llama4's, each launched twice
     (bit-identical) and seen in ``flash_mma_kernel<64>``. The backward at
     head dim 64 on those f32 and bf16 cases without a mask, and at
     whisper's three training calls (8 x 1500 frames non-causal, 448
     queries over them, causal over 448), held per element (rtol one bf16
     ulp, atol one bf16 ulp of the gradient's root mean square), two
     launches bit-identical at each.
  3. the first path, the serving restart of slice 1: full-width
     starcoder2-3b (depth cut from 30 to 2 layers, random weights from a
     seed, bf16) with a training-layout state is saved through the burst
     buffer with int8 moments, restored onto the card, and serves 3 request
     batches; params must come back bit-exact, moments within the int8
     bound, tokens equal to those served from the un-saved params, and
     every kernel of the path must have launched the expected number of
     times (counts are zeroed just before and read just after).
  3b. the second and twelfth paths, slices 12 and 2: full-width
     recurrentgemma-9b (one repeat of each segment unit: 4 of 38 layers,
     1.94 G params) trains with AdamW through ``train_loop`` on batches of
     2 x 4096 tokens (past the 2048-token window): run A 4 steps, run B the
     same 4 from the same seed without the buffer, equal to run A bit for
     bit in every leaf; each step launches the RG-LRU forward (with its
     f32 carry) and backward once an rglru layer and the D = 256 flash
     forward and backward once (24 / 24 / 8 / 8). Then run A's params
     restart from a params-only checkpoint and serve 3 request batches of
     3072-token prompts, with the same checks as slice 1's; the RG-LRU
     kernel runs in every prefill and decode step. The path runs with the
     allocator's expandable segments (``expandable_segments``).
  3c. the third path, the training restart of slice 3: full-width
     xlstm-350m (one repeat of its segment unit: 7 mLSTM + 1 sLSTM of 24
     layers, f32 params) trains through ``launch/train.py::train_loop`` on
     batches of 8 x 2048 tokens, deterministic: run A takes 4 steps; run B
     takes 2, checkpoints through the burst buffer unquantized, loses
     server/0, restores from the replicas into a state drawn from another
     seed and takes 2 more. B's params and moments must equal A's bit for
     bit. The mLSTM kernel runs in every forward (7 launches a step).
  3d. the fourth path, the training restart of slice 4: full-width
     starcoder2-3b (1 of 30 layers, bf16 params, f32 AdamW moments) through
     the same restart at 4 + 4 steps of 8 x 2048 tokens; the flash forward
     (with row statistics) and the flash backward kernel run once a layer
     in every step; besides them only quantize / dequantize run, for the
     int8 checkpoint.
  3e. the fifth path, the training restart of slice 5: full-width
     deepseek-coder-33b (1 of 62 layers, bf16 params, Adafactor with bf16
     momentum and f32 factored second moments) through the same restart
     at 4 + 4 steps;
     the flash forward and backward (head dim 128) run once a layer in
     every step, quantize / dequantize once for each int8 leaf.
  3f. the sixth path, the serving restart of slice 6: h2o-danube-1.8b at
     full width, depth cut to 2 of its 24 layers, from a params-only
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
  3h. the eighth and tenth paths, slices 8 and 10: deepseek-v3-671b at full
     width (MLA: 128 heads, q_lora 1536, kv_lora 512, q / k head dim
     128 + 64, v 128; 256 experts at top-8 and a shared expert; vocab
     129280). Part A (slice 10): one mla_dense layer with the MTP module
     (its layer mla_dense too; 3.12 G params) trains with Adafactor and the
     MTP loss through ``train_loop`` on batches of 4 x 2048 tokens: run A 4
     steps; run B 2 steps, an unquantized checkpoint (12.51 GB) through 4
     servers of 8 GiB, no kill, a restore into a state drawn from another
     seed, 2 more steps, equal to run A bit for bit; the flash forward and
     backward at head dim 192 run twice a step (the trunk's layer over
     2048 tokens, the MTP layer over 2047); then 3 request batches of 4
     prompts of 4096 tokens are served from run B's params and from run
     A's (equal tokens). Part B: one mla_dense
     and one mla_moe layer without MTP (13.94 G params, 27.89 GB) are drawn
     on the card from the seed (a restart through the buffer would hold
     3 x 27.89 GB on the card and ~4.75 x on the host), serve the same
     requests twice (equal tokens), and the absorbed decode is held
     against the reconstructed path (``absorbed_decode_check``); the
     flash forward at head dim 192 runs once an MLA layer in every
     prefill.
  3i. the ninth and eleventh paths, slices 9 and 11: whisper-large-v3 at
     full width (d_model 1280, 20 heads at head dim 64), depth cut to 2 enc
     and 2 cross layers of its 32 + 32 (0.19 G params). It trains with
     AdamW through ``train_loop`` on the pipeline's batches of 8 x 448
     tokens over 8 x 1500 frames of 1280: run A 4 steps; run B 2 steps, an
     unquantized checkpoint (bf16 params, f32 moments) through 4 servers of
     4 GiB, no kill, a restore into a state drawn from another seed, 2 more
     steps, equal to run A bit for bit; each step runs the flash forward
     and backward once an enc layer (non-causal over the frames) and twice
     a cross layer (causal over the tokens, non-causal over the frames):
     48 launches each. Then 3 request batches of 4 x 1500 frames (30 s of
     audio from the stub frontend, drawn from the seed) and 224-token
     prompts, 32 new tokens, are served from run B's params and from run
     A's (equal tokens; 36 forward launches); a profile of the prefill
     splits the encoder's device time from the decoder's, one of a decode
     step the attention over the context cache.
  4. numbers for each path, taken right after it (its model is freed before
     the next path): save / restore seconds, prefill ms and decode tok/s
     (serving), step time, tokens/s, save / flush / restore-after-kill and
     int8 save / flush / restore seconds (slices 4 and 5; slices 10 and 11:
     save / flush / restore without a kill) and the optimizer update's own
     seconds
     (training; xlstm-350m's step times are its run A's and its step is
     not traced: its sLSTM loop makes a trace of it take ~30 s), a device
     profile (training: the flash forward's and backward's share of a
     step's busy time, and recurrentgemma-9b's RG-LRU forward's and
     backward's); then a JSON
     line with each
     kernel's launches, time, bound, plain-version time and the time of one
     PyTorch library call for the same function.
Each ``[host]`` line and ``[done]`` count seconds from the script's start;
a phase's ``[host]`` line also prints the phase's own seconds. The last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
# slice 12: recurrentgemma-9b trains at full width and 3b's cut with AdamW
# (the config's: f32 moments and grad accumulation, bf16 params) on the
# pipeline's batches of 2 x 4096 tokens, 8192 a step as slice 10's and
# past the 2048-token window; the batch shape is chosen for the card's
# memory (the step holds the 2 x 4096 x 256,000 logits in f32 and their
# gradient beside a 19.40 GB train state), not taken from a published
# training setup. Run A 4 steps, run B the same 4 from the same seed
# without the buffer: the AdamW state's 19.40 GB would take a round of its
# own through it (slice 10's 12.51 GB took 137 s and 58.4 GB of the host's
# 96); run A's params then go through 3b's params-only restart
RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_STEPS = 2, 4096, 4
# the scan of its training step: the forward (with the f32 carry) and the
# backward, from a zero state (h0 None), no gradient of h_last
RG_LRU_TRAIN = (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_WIDTH, "bfloat16", "none")


def _rg_lru_cases(tile_s):
    """The serving and training shapes and the kernels' edges, each in f32
    and bf16: a ragged S (300, one tile + 1), S = 2, S on each side of the
    step / ring threshold (one time tile), a D that is not a multiple of
    the ring's 64 / 32 channels (4100: bf16 rows not 16-byte aligned, so
    shifted rows; 4104: aligned), D = 1030 (neither dtype aligned, nor a
    multiple of the backward's 64 channels), B = 1, and h0 None."""
    shapes = [(RG_BATCH, RG_PROMPT, RG_WIDTH, "zero"),
              (RG_BATCH, 1, RG_WIDTH, "normal"),
              (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_WIDTH, "none"),
              (2, 300, 384, "normal"), (2, tile_s + 1, 384, "none"),
              (3, 2, 384, "normal"), (2, tile_s - 1, 320, "normal"),
              (2, tile_s, 320, "none"), (2, 200, 4100, "normal"),
              (2, 130, 4104, "none"), (2, 150, 1030, "normal"),
              (1, 512, RG_WIDTH, "none")]
    return [(b, s, d, dtype, h0) for b, s, d, h0 in shapes
            for dtype in ("bfloat16", "float32")]

# slice 3: xlstm-350m training, one repeat of its (mLSTM x 7, sLSTM) unit
# 4 steps (2 + 2 around the kill): its sLSTM's host loop makes a step take
# 4 to 10 s, so the path takes its step times from run A, builds no model
# to time or trace (a device-only trace of a step took ~33 s) and skips the
# int8 round (slices 4 and 5 take it), and the run stays inside its limit
XL_BATCH, XL_SEQ, XL_STEPS = 8, 2048, 4
XL_HEADS, XL_HEAD_DIM = 4, 512        # mLSTM heads of d_model 1024 x 2
# a server's DRAM, as for the two training paths below: about four times
# the server's share of the checkpoint at replication 2, so that the copies
# the survivors re-replicate after the kill (``settle_after_kill``) land in
# DRAM. At 2 to 4 GiB (under three times the share) they spilled to the
# SSD logs, and on an H100 host the survivors then went on moving chunks
# for minutes after the kill
XL_DRAM = 4 << 30                     # ~0.92 GiB a server (~2.0 GB)
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

# slice 4: starcoder2-3b training at full width, SC_LAYERS of its 30 layers
# (LAYERS before slice 12, for time: slice 12's training took the run to
# 1095.6 s of its 1200 on one host, and this path's 3.43 GB checkpoint
# round with its kill took 136.7 s of it). Run A 4 steps, run B 2 + 2 (8
# and 4 + 4 before slice 11, for time: its four resumed steps took 20.0 to
# 33.2 s each on one host while the survivors re-replicated after the kill)
SC_LAYERS = 1
SC_BATCH, SC_SEQ, SC_STEPS = 8, 2048, 4
SC_DRAM = 8 << 30     # ~1.16 GiB a server: 2 x ~2.5 GB over 4 (XL_DRAM)
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
# softcap with GQA at D = 128, and non-causal with Sq != Sk; then the same
# edges at D = 256 (its dk and dv blocks, 16-row q steps, 16-key dq tiles):
# gemma3-4b's 8 heads over 4 KV with its 1024 window at S = 1100 (ragged in
# every tile; the window's edge 76 keys behind each query falls inside the
# 64-key tiles), a q offset with Sq < Sk, non-causal with Sq != Sk, softcap
BWD_EDGE_CASES = [
    (1, 100, 100, 4, 2, 16, True, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (2, 256, 256, 24, 2, 128, True, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 150, 150, 8, 2, 64, True, 40, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 72, 200, 4, 1, 64, True, 0, 0.0, 128, "bfloat16", D256_BF16_TOL),
    (1, 160, 160, 8, 2, 128, True, 0, 30.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 96, 130, 4, 2, 32, False, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 1100, 1100, 8, 4, 256, True, 1024, 0.0, 0, "bfloat16",
     D256_BF16_TOL),
    (1, 72, 200, 4, 1, 256, True, 0, 0.0, 128, "bfloat16", D256_BF16_TOL),
    (1, 96, 130, 4, 2, 256, False, 0, 0.0, 0, "bfloat16", D256_BF16_TOL),
    (1, 160, 160, 8, 2, 256, True, 0, 30.0, 0, "bfloat16", D256_BF16_TOL),
]

# slice 5: deepseek-coder-33b training at full width, DS_LAYERS of its 62
# layers, Adafactor; its attention: 56 heads / 8 kv at head dim 128. One
# layer since slice 8 came: on an H100 host two layers took 169.7 to
# 199.7 s of a run that then neared its limit, and their 6.12 GB
# checkpoint's restore after the kill held up to 73.4 GiB of its 96. Run A
# 4 steps, run B 2 + 2 (8 and 4 + 4 before slice 11, for time: its last
# two resumed steps took 23.9 and 28.1 s on one host while the survivors
# re-replicated after the kill)
DS_LAYERS = 1
DS_BATCH, DS_SEQ, DS_STEPS = 8, 2048, 4
DS_DRAM = 8 << 30     # ~1.86 GiB a server: 2 x ~4 GB over 4 (XL_DRAM)
DS_TRAIN_ATTN_CASE = (DS_BATCH, DS_SEQ, DS_SEQ, 56, 8, 128, True, 0, 0.0, 0,
                      "bfloat16", D256_BF16_TOL)
DS_TRAIN_FWD_CASE = DS_TRAIN_ATTN_CASE[:11] + (3e-2,)
# slice 6: h2o-danube-1.8b serving at full width, a prompt past
# its 4096-token window; head dim 2560 / 32 = 80
H2O_BATCH, H2O_PROMPT, H2O_GEN, H2O_REQUESTS = 4, 5120, 32, 3
H2O_WINDOW, H2O_HEADS, H2O_KV, H2O_HEAD_DIM = 4096, 32, 8, 80
# depth cut from 24 layers for time: with all 24 (and whisper's 32 + 32)
# the whole run took 1134.1 s of its 1200 on one H100 host; 4 until slice
# 12, whose training took the run to 1095.6 s on one host
H2O_LAYERS = 2
H2O_DRAM = 4 << 30    # at most ~1.83 GB a server (3.66 GB at full depth)
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
P_ROUND_SIGMAS = 8
# slice 8: deepseek-v3-671b serving at full width through the MLA kinds; its
# prefill runs the flash forward at q / k head dim 128 + 64 = 192 with V
# zero-padded from 128, 128 heads each with its own k (the rope key
# broadcast to every head)
DS3_BATCH, DS3_PROMPT, DS3_GEN, DS3_REQUESTS = 4, 4096, 32, 3
DS3_HEADS, DS3_HEAD_DIM = 128, 192
# part A (slice 10): one mla_dense layer and the MTP module (its layer
# mla_dense too) trains through the burst buffer, then serves; part B: one
# layer of each kind, no MTP, built on the card (its 27.89 GB would need
# 3 x on the card and ~4.75 x on the host to go through the buffer)
DS3_SEGMENTS_A = ((("mla_dense",), 1),)
DS3_SEGMENTS_B = ((("mla_dense",), 1), (("mla_moe",), 1))
# ~5.82 GiB a server at replication 2 over 4 (part A's 12.51 GB training
# checkpoint: bf16 params and m, f32 vr and vc), all in DRAM
DS3_DRAM = 8 << 30
# slice 10: part A trains with Adafactor and the MTP loss on batches of
# 4 x 2048 tokens (8 would pass the card's 80 GB: a step alone holds 49
# GB at 4, both heads' logits over 129280 entries among it, beside run A's
# train state of 12.5 GB); run A 4 steps, run
# B 2 + 2 around a restore without a kill (a kill at 12.51 GB waits on the
# host's memory). A step launches the flash forward and backward at head
# dim 192 twice: the trunk's layer over 2048 tokens and the MTP layer over
# 2047 (positions 1 .. S-1, ragged in every 64-row and 64-key tile), V and
# dO zero in their last 64 columns as models/mla.py pads V from 128
DS3_TRAIN_BATCH, DS3_TRAIN_SEQ, DS3_TRAIN_STEPS = 4, 2048, 4
DS3_V_PAD = 64
# head dim 192 in f32 (2e-5) and bf16 (the reference's 3e-2), MLA's heads
# (as many kv heads as q heads): a causal case, a ragged Sk without a mask
# (Sq != Sk, 200 keys ragged in the 64- and 32-key tiles) and a q offset
# with Sq < Sk; a small bf16 case whose window of 8 keeps the outputs near
# 1, within one bf16 ulp (D256_BF16_TOL); the prefill shape within rtol
# D256_BF16_TOL and the bf16 P's per-element atol (``_p_rounding_atol``):
# outputs that average up to 4096 values are small
D192_CASES = [case for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2))
              for case in (
                  (2, 128, 128, 4, 4, DS3_HEAD_DIM, True, 0, 0.0, 0, dtype,
                   tol),
                  (1, 96, 200, 4, 4, DS3_HEAD_DIM, False, 0, 0.0, 0, dtype,
                   tol),
                  (1, 72, 200, 4, 4, DS3_HEAD_DIM, True, 0, 0.0, 128, dtype,
                   tol))] + [
    (2, 96, 96, 4, 1, DS3_HEAD_DIM, True, 8, 0.0, 0, "bfloat16",
     D256_BF16_TOL)]
DS3_PREFILL_CASE = (DS3_BATCH, DS3_PROMPT, DS3_PROMPT, DS3_HEADS, DS3_HEADS,
                    DS3_HEAD_DIM, True, 0, 0.0, 0, "bfloat16", D256_BF16_TOL)
# the absorbed decode against the reconstructed path, whole-model logits,
# relative L2 error a row (``absorbed_decode_check``): bf16 at full width,
# 8 bf16 unit roundoffs (2^-8 each); PERF.md, slice 8, derives it
MLA_DECODE_TOL = 8 * 2.0 ** -8
# slice 9: whisper-large-v3 serving at full width: 3 requests of
# 4 x 30 s of audio (the stub frontend's 1500 frames of 1280, drawn from the
# seed) and a 224-token prompt (previous-text conditioning, half its
# 448-token decoder context), 32 new tokens; MHA at head dim 64
WH_BATCH, WH_PROMPT, WH_GEN, WH_REQUESTS = 4, 224, 32, 3
WH_FRAMES, WH_HEADS, WH_HEAD_DIM = 1500, 20, 64
# depth cut from 32 enc + 32 cross layers for time, as H2O_LAYERS (4 + 4
# until slice 12)
WH_LAYERS = 2
WH_DRAM = 4 << 30     # at most ~1.47 GiB a server (3.16 GB at full depth)
# head dim 64 without a causal mask in f32 (2e-5) and bf16 (the reference's
# 3e-2): Sk ragged in the 64-key tiles (220 = 3 x 64 + 28, as 1500 = 23 x 64
# + 28) with Sq = Sk, and with Sq != Sk (90 queries, ragged in the 64-row
# tiles too); then whisper's three prefill shapes in bf16, held per element
# like llama4's (rtol D256_BF16_TOL, atol ``_p_rounding_atol``): outputs of
# a 1500-key softmax are near 0.03, where a fixed atol of 3e-2 holds nothing
D64_CASES = [case for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2))
             for case in (
                 (2, 220, 220, 4, 4, WH_HEAD_DIM, False, 0, 0.0, 0, dtype,
                  tol),
                 (2, 90, 220, 4, 2, WH_HEAD_DIM, False, 0, 0.0, 0, dtype,
                  tol))]
# the encoder's self-attention, the decoder's cross-attention over the
# frames, the decoder's causal self-attention over the prompt
WH_ENC_CASE = (WH_BATCH, WH_FRAMES, WH_FRAMES, WH_HEADS, WH_HEADS,
               WH_HEAD_DIM, False, 0, 0.0, 0, "bfloat16", D256_BF16_TOL)
WH_CROSS_CASE = (WH_BATCH, WH_PROMPT, WH_FRAMES) + WH_ENC_CASE[3:]
WH_SELF_CASE = (WH_BATCH, WH_PROMPT, WH_PROMPT) + WH_ENC_CASE[3:6] \
    + (True,) + WH_ENC_CASE[7:]
# slice 11: whisper-large-v3 trains at full width and WH_LAYERS + WH_LAYERS
# layers with AdamW (the config's: f32 moments and grad accumulation, bf16
# params) on the pipeline's batches of 8 x 448 tokens (its decoder's native
# context) over 8 x 1500 frames; run A 4 steps, run B 2 + 2 around an
# unquantized checkpoint restored with every server up
WH_TRAIN_BATCH, WH_TRAIN_SEQ, WH_TRAIN_STEPS = 8, 448, 4
# its three flash calls a layer kind, forward (with row statistics) and
# backward: the encoder's over the frames, the decoder's cross-attention of
# 448 queries over them, both without a mask (1500 keys ragged in the
# 64-key tiles, 448 = 7 x 64 queries), and its causal self-attention
WH_TRAIN_ENC_CASE = (WH_TRAIN_BATCH,) + WH_ENC_CASE[1:]
WH_TRAIN_CROSS_CASE = (WH_TRAIN_BATCH, WH_TRAIN_SEQ, WH_FRAMES) \
    + WH_ENC_CASE[3:]
WH_TRAIN_SELF_CASE = (WH_TRAIN_BATCH, WH_TRAIN_SEQ, WH_TRAIN_SEQ) \
    + WH_SELF_CASE[3:]
# the cases held per element by ``_p_rounding_atol``
P_ROUND_CASES = (LL_PREFILL_CASE, LL_NOPE_CASE, DS3_PREFILL_CASE, WH_ENC_CASE,
                 WH_CROSS_CASE, WH_SELF_CASE, WH_TRAIN_ENC_CASE,
                 WH_TRAIN_CROSS_CASE)
# the D = 256 forward (with row statistics) and backward at recurrentgemma-9b's
# attention layer in slice 12's train step: 2 x 4096 tokens, where the
# 2048 window cuts every query row past 2048 (64 key tiles a (b, kv head));
# the forward held like the prefill's, per element, the backward like
# whisper's (an atol of one bf16 ulp of the gradient's RMS). The same layer
# over 8 x 2048 tokens, where the window is inert (the shape
# ``tune_flash_bwd --head-dim 256`` times), stays among the edge cases
RG_TRAIN_ATTN_CASE = (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_SEQ, RG_HEADS,
                      1, RG_HEAD_DIM, True, RG_WINDOW, 0.0, 0, "bfloat16",
                      D256_BF16_TOL)
P_ROUND_CASES += (RG_TRAIN_ATTN_CASE,)
BWD_EDGE_CASES.append((8, 2048, 2048, RG_HEADS, 1, RG_HEAD_DIM, True,
                       RG_WINDOW, 0.0, 0, "bfloat16", D256_BF16_TOL))
# slice 10's flash calls in a train step, V (and dO) padded: the trunk's
# layer over 2048 tokens, the MTP layer over 2047; the forward (with row
# statistics) held like the prefill's, per element
DS3_TRAIN_ATTN_CASE = (DS3_TRAIN_BATCH, DS3_TRAIN_SEQ, DS3_TRAIN_SEQ,
                       DS3_HEADS, DS3_HEADS, DS3_HEAD_DIM, True, 0, 0.0, 0,
                       "bfloat16", D256_BF16_TOL)
DS3_MTP_ATTN_CASE = (DS3_TRAIN_BATCH, DS3_TRAIN_SEQ - 1,
                     DS3_TRAIN_SEQ - 1) + DS3_TRAIN_ATTN_CASE[3:]
P_ROUND_CASES += (DS3_TRAIN_ATTN_CASE,)
# the bf16 D = 192 backward at its dk and dv blocks' edges with MLA's heads
# (a kv head for each query head): a q offset with Sq < Sk, non-causal
# Sq != Sk, and V and dO zero in their last 64 columns (as the MLA pads V;
# dv's padded columns must come out exactly zero) at a ragged S
D192_PADDED_CASE = (1, 200, 200, 8, 8, DS3_HEAD_DIM, True, 0, 0.0, 0,
                    "bfloat16", D256_BF16_TOL)
BWD_EDGE_CASES += [
    (1, 72, 200, 8, 8, DS3_HEAD_DIM, True, 0, 0.0, 128, "bfloat16",
     D256_BF16_TOL),
    (1, 96, 130, 8, 8, DS3_HEAD_DIM, False, 0, 0.0, 0, "bfloat16",
     D256_BF16_TOL),
    D192_PADDED_CASE]
# the backward cases whose V and dO are zero in their last DS3_V_PAD columns
V_PADDED_CASES = (D192_PADDED_CASE, DS3_TRAIN_ATTN_CASE, DS3_MTP_ATTN_CASE)
# the training shapes, where two launches must be bit-identical
TRAIN_SHAPES = (TRAIN_ATTN_CASE, DS_TRAIN_ATTN_CASE, H2O_TRAIN_ATTN_CASE,
                RG_TRAIN_ATTN_CASE, DS3_TRAIN_ATTN_CASE, DS3_MTP_ATTN_CASE,
                WH_TRAIN_ENC_CASE, WH_TRAIN_CROSS_CASE, WH_TRAIN_SELF_CASE)
# The backward cases whose gradients are held per element with rtol
# D256_BF16_TOL and, as atol, D256_BF16_TOL times the plain gradient's root
# mean square over its tensor (one bf16 ulp of a typical element) in place
# of an atol of D256_BF16_TOL: whisper's training shapes, whose 1500-key
# softmax leaves dq, dk and dv near 0.03, where 8e-3 would pass a lost
# ragged tile's share, and recurrentgemma-9b's over its 2048-key window. The kernel splits P and dS into hi / lo bf16 pairs
# (2^-16 of each), so it differs from the plain version by the one bf16
# rounding of each result (the rtol) and f32 sums in another order (far
# below the atol)
BWD_RMS_CASES = (WH_TRAIN_ENC_CASE, WH_TRAIN_CROSS_CASE, WH_TRAIN_SELF_CASE,
                 RG_TRAIN_ATTN_CASE)

BWD_CASES = [case[:11] + (BWD_F32_TOL if case[10] == "float32"
                          else D256_BF16_TOL,)
             for case in ATTN_CASES + BF16_CASES + D256_CASES + D80_CASES
             + D192_CASES + D64_CASES] + BWD_EDGE_CASES + list(TRAIN_SHAPES)


def bwd_kernels(case):
    """The device kernels the backward must run on a case: bf16 on the
    tensor cores at every head dim, f32 on the CUDA cores."""
    d, dtype = case[5], case[10]
    if dtype == "bfloat16":
        names = [f"flash_bwd_mma_dkdv_kernel<{d}>",
                 f"flash_bwd_mma_dq_kernel<{d}>"]
    else:
        names = [f"flash_bwd_dkdv_kernel<{d}>", f"flash_bwd_dq_kernel<{d}>"]
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
    """'mlstm_mma_kernel<512>', 'dequantize_kernel<f32>' or
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


def _profiler_warmup():
    """A small kernel of PyTorch's, launched in each profiled window before
    the call it observes: the records the profiler dropped were always of
    a window's first kernels (a flash backward's D pre-pass, and once its
    dk / dv kernel too; the pre-pass in three observations in a row in one
    run), and this one is not the port's."""
    import torch
    torch.ones(1, device="cuda").add_(1)


def device_kernels(fn, want, tag, observations=5):
    """``fn()`` and the sorted labels of the port's kernels it launched
    (torch.profiler), each window opened by ``_profiler_warmup``. The
    profiler at times drops a launch's records: while what it recorded is
    a strict part of ``want``, the same deterministic call is profiled
    again, up to ``observations`` in all. A kernel outside ``want`` is
    never a dropped record, and the caller's check fails on it at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = None
    for i in range(observations):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profiler_warmup()
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
    """Both RG-LRU forward kernels and the backward kernel bit for bit
    against their plain versions on every case of ``_rg_lru_cases``: the
    forward without the carry (serving's) and with it (training's: h,
    h_last and the f32 carry), then the backward's da, dgx and dh0 (with
    h0) from that carry and a random dh, dh_last given in one dtype of each
    shape (never at the training shape, whose h_last the model drops); on
    inputs off a 16-byte boundary (a, gx and dh at different shifts); two
    launches bit-identical at the prefill shape (the forward) and at the
    training shape (the forward with its carry, the backward), and there
    autograd through the kernels' Function equal to the kernels. The cases
    must reach both forward kernels and both row alignments of the ring in
    each dtype. Returns the max errors of the forward, the forward at the
    training shape and the backward. The inputs come from a generator of
    their own, so these cases do not move the other kernels' inputs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def same(x, y):
        return (x is None and y is None) or torch.equal(x, y)

    def run(case, a, gx, h0, dh, dh_last):
        h_free, last_free = rg_lru.rg_lru(a, gx, h0)
        h, h_last, h32 = rg_lru.rg_lru(a, gx, h0, return_carry=True)
        ph, ph_last, p32 = ref.rg_lru(a, gx, h0, return_carry=True)
        grads = rg_lru.rg_lru_bwd(a, h32, dh, dh_last, h0)
        plain = ref.rg_lru_bwd(a, p32, dh, dh_last, h0)
        torch.cuda.synchronize()
        de = max((h.float() - ph.float()).abs().max().item(),
                 (h_last.float() - ph_last.float()).abs().max().item(),
                 (h32 - p32).abs().max().item())
        dg = max((g.float() - pg.float()).abs().max().item()
                 for g, pg in zip(grads, plain) if g is not None)
        check(h.dtype == a.dtype and h.shape == a.shape
              and h_last.shape == (a.shape[0], a.shape[2])
              and h32.dtype == torch.float32 and h32.shape == a.shape,
              f"rg_lru {case}: output {h.dtype} {tuple(h.shape)}, carry "
              f"{h32.dtype} {tuple(h32.shape)}")
        check(all(g.dtype == a.dtype for g in grads if g is not None)
              and grads[0].shape == a.shape and grads[1].shape == a.shape
              and (grads[2] is None) == (h0 is None),
              f"rg_lru_bwd {case}: outputs "
              f"{[None if g is None else g.dtype for g in grads]}")
        check(all(torch.isfinite(x.float()).all().item()
                  for x in (h, h32, *grads) if x is not None),
              f"rg_lru {case}: non-finite output")
        check(torch.equal(h, h_free) and torch.equal(h_last, last_free),
              f"rg_lru {case}: the forward with its carry differs from the "
              f"one without")
        check(torch.equal(h, ph) and torch.equal(h_last, ph_last)
              and torch.equal(h32, p32),
              f"rg_lru {case}: differs from its plain version")
        check(all(same(g, pg) for g, pg in zip(grads, plain)),
              f"rg_lru_bwd {case}: differs from its plain version")
        return de, dg, (h, h_last, h32), grads

    e_fwd = e_bwd = e_train = 0.0
    reached = set()
    for i, case in enumerate(_rg_lru_cases(rg_lru.TILE_S)):
        a, gx, h0 = _rg_lru_inputs(case, gen)
        dh = torch.randn(a.shape, generator=gen, device="cuda").to(a.dtype)
        dh_last = (torch.randn((a.shape[0], a.shape[2]), generator=gen,
                               device="cuda").to(a.dtype)
                   if (i + i // 2) % 2 and case != RG_LRU_TRAIN else None)
        plan = rg_lru.launch_plan(*a.shape, a.dtype)
        bwd_grid = rg_lru.bwd_launch_plan(a.shape[0], a.shape[2]).grid
        reached.add((case[3], plan.kernel, plan.aligned))
        de, dg, fwd, grads = run(case, a, gx, h0, dh, dh_last)
        print(f"[rg_lru] {case}: {plan.kernel} kernel, "
              f"{'aligned' if plan.aligned else 'shifted'} rows, grid "
              f"{plan.grid}; max|kernel-plain| {de:.3e} in h, h_last and "
              f"the f32 carry; backward (dh_last "
              f"{'given' if dh_last is not None else 'None'}, grid "
              f"{bwd_grid}) {dg:.3e} in da, "
              f"dgx{', dh0' if h0 is not None else ''} (tol 0: "
              f"bit-identical)", flush=True)
        if case == RG_LRU_PREFILL:
            h2, h_last2 = rg_lru.rg_lru(a, gx, h0)
            torch.cuda.synchronize()
            again = torch.equal(fwd[0], h2) and torch.equal(fwd[1], h_last2)
            print(f"[rg_lru] {case}: two launches bit-identical: {again}",
                  flush=True)
            check(again, f"rg_lru {case}: two launches differ")
            del h2, h_last2
        if case == RG_LRU_TRAIN:
            e_train = de
            fwd2 = rg_lru.rg_lru(a, gx, h0, return_carry=True)
            grads2 = rg_lru.rg_lru_bwd(a, fwd[2], dh, dh_last, h0)
            leaves = [x.detach().requires_grad_(True) for x in (a, gx)]
            out, _ = rg_lru.rg_lru(*leaves)
            auto = torch.autograd.grad(out, leaves, dh)
            torch.cuda.synchronize()
            again = all(torch.equal(x, y) for x, y in zip(fwd, fwd2)) \
                and all(same(x, y) for x, y in zip(grads, grads2))
            through = torch.equal(out, fwd[0]) and all(
                torch.equal(x, y) for x, y in zip(auto, grads[:2]))
            print(f"[rg_lru] {case}: two launches bit-identical in h, "
                  f"h_last, the carry and da, dgx: {again}; autograd "
                  f"through the kernels' Function equals them bit for bit: "
                  f"{through}", flush=True)
            check(again, f"rg_lru {case}: two launches differ")
            check(through, f"rg_lru {case}: autograd through the Function "
                  f"differs from the kernels")
            del fwd2, grads2, leaves, out, auto
        e_fwd, e_bwd = max(e_fwd, de), max(e_bwd, dg)
        del a, gx, h0, dh, dh_last, fwd, grads
    # rows of 16-byte multiples, but a one, gx three and dh five elements
    # past a 16-byte boundary: each row read at its own shift, two shifts a
    # row in the forward
    for dtype in ("bfloat16", "float32"):
        case = (2, 300, 384, dtype, "normal")
        a, gx, h0 = _rg_lru_inputs(case, gen)
        dh = torch.randn(a.shape, generator=gen, device="cuda").to(a.dtype)
        a, gx, dh = (torch.cat([x.new_zeros(k),
                                x.reshape(-1)])[k:].view(x.shape)
                     for x, k in ((a, 1), (gx, 3), (dh, 5)))
        plan = rg_lru.launch_plan(*a.shape, a.dtype, aligned=False)
        reached.add((dtype, plan.kernel, plan.aligned))
        de, dg, *_ = run(case, a, gx, h0, dh, None)
        print(f"[rg_lru] {case}, a, gx and dh 1, 3 and 5 elements past a "
              f"16-byte boundary: {plan.kernel} kernel, shifted rows; "
              f"max|kernel-plain| {de:.3e}, backward {dg:.3e} (tol 0)",
              flush=True)
        e_fwd, e_bwd = max(e_fwd, de), max(e_bwd, dg)
    want = {(dt, k, al) for dt in ("bfloat16", "float32")
            for k, al in (("step", True), ("ring", True), ("ring", False))}
    check(reached == want, f"rg_lru cases reached {sorted(reached)}, "
          f"not every kernel and row alignment {sorted(want)}")
    return e_fwd, e_train, e_bwd


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
    BWD_CASES, fed the same q, k, v, dO and the forward kernel's o, m, l
    (V and dO zero in their last DS3_V_PAD columns for V_PADDED_CASES,
    whose dv must be exactly zero there); the stats-emitting forward
    against the stats-free one (o bit for bit) and its m, l against the
    plain forward's; at each training shape (TRAIN_SHAPES) two launches
    bit-identical, and at slice 4's autograd through the kernel's Function
    equal to the backward kernel on the saved tensors. Returns {training
    shape: (max error, the device kernels it ran)}. The inputs come from a
    generator of their own, so these cases do not move the other kernels'
    inputs."""
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
        if case in V_PADDED_CASES:
            v[..., -DS3_V_PAD:] = 0
            do[..., -DS3_V_PAD:] = 0
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
        rms = (lambda pg: tol * pg.float().square().mean().sqrt()) \
            if case in BWD_RMS_CASES else (lambda pg: None)
        e = max(_within(f"{tag} {name}", g, pg, tol, rms(pg))
                for name, g, pg in zip(("dq", "dk", "dv"), grads, plain))
        if case in V_PADDED_CASES:
            zero = not grads[2][..., -DS3_V_PAD:].any().item()
            print(f"{tag}: V and dO zero in their last {DS3_V_PAD} columns; "
                  f"dv zero there: {zero}", flush=True)
            check(zero, f"flash_bwd {case}: dv's padded columns not zero")
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


def check_repeat_launch(case, q, k, v, out):
    """A second launch of the bf16 forward at ``case`` on the same q, k, v,
    profiled: bit-identical to ``out``, through ``flash_mma_kernel<D>``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    *_, causal, window, cap, q_offset, _dtype, _tol = case
    want = [f"flash_mma_kernel<{case[5]}>"]
    again, ran = device_kernels(
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=cap, q_offset=q_offset),
        want, f"[flash] {case[:-2]}")
    same = torch.equal(out, again)
    print(f"[flash] {case[:-2]}: kernels {', '.join(ran)}; two launches "
          f"bit-identical: {same}", flush=True)
    check(ran == want, f"flash {case}: ran {ran}, not {want}")
    check(same, f"flash {case}: two launches differ")


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
            LL_NOPE_CASE: "flash_attention_llama4_nope",
            DS3_PREFILL_CASE: "flash_attention_mla",
            DS3_TRAIN_ATTN_CASE: "flash_attention_train_mla",
            WH_ENC_CASE: "flash_attention_whisper",
            WH_CROSS_CASE: "flash_attention_whisper_cross",
            WH_SELF_CASE: "flash_attention_whisper_self",
            WH_TRAIN_ENC_CASE: "flash_attention_train_whisper",
            WH_TRAIN_CROSS_CASE: "flash_attention_train_whisper_cross",
            RG_TRAIN_ATTN_CASE: "flash_attention_train_d256"}
    for case in (ATTN_CASES + BF16_CASES + D256_CASES + D80_CASES
                 + D192_CASES + D64_CASES + list(rows)):
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
        if case in (DS3_PREFILL_CASE, WH_ENC_CASE, WH_CROSS_CASE,
                    WH_SELF_CASE):
            check_repeat_launch(case, q, k, v, out)
        del q, k, v, out, plain, atol

    results, bwd_ran = check_flash_bwd(), {}
    for case, name in ((TRAIN_ATTN_CASE, "flash_attention_bwd"),
                       (DS_TRAIN_ATTN_CASE, "flash_attention_bwd_dsc"),
                       (H2O_TRAIN_ATTN_CASE, "flash_attention_bwd_d80"),
                       (RG_TRAIN_ATTN_CASE, "flash_attention_bwd_d256"),
                       (DS3_TRAIN_ATTN_CASE, "flash_attention_bwd_mla"),
                       (WH_TRAIN_ENC_CASE, "flash_attention_bwd_whisper"),
                       (WH_TRAIN_CROSS_CASE,
                        "flash_attention_bwd_whisper_cross")):
        err[name], bwd_ran[name] = results[case]
    # the MTP layer's 2047 tokens: the same row
    err["flash_attention_bwd_mla"] = max(err["flash_attention_bwd_mla"],
                                         results[DS3_MTP_ATTN_CASE][0])

    err["rg_lru"], err["rg_lru_train"], err["rg_lru_bwd"] = check_rg_lru()

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
                    dram_capacity, train_state, enc_input=None, params=None):
    """A serving path: build -> save through the burst buffer -> restore
    onto ``device`` -> serve. ``train_state``: the checkpoint is a
    training-layout state (params, AdamW moments quantized to int8, steps);
    otherwise params only, as a serving restart reads weights.
    ``enc_input``: the frames every request's prefill encodes (configs with
    cross layers). ``params``: the params to save and serve (trained ones),
    else drawn from the seed.

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

    host_step(f"{cfg.name}: init and serve the un-saved params")
    model = build_model(cfg)
    if params is None:
        params = model.init(SEED, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    prompts = [torch.randint(1, cfg.vocab_size, (batch, prompt),
                             generator=gen, device=device)
               for _ in range(requests)]
    # tokens served from the un-saved params: the comparison, not counted
    expected = [serve_batch(cfg, model, params, p, gen_tokens=gen_tokens,
                            enc_input=enc_input) for p in prompts]

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
    bbcfg = BBConfig(num_servers=4, num_clients=4, dram_capacity=dram_capacity,
                     stabilize_interval=SERVE_STABILIZE_S)
    with BurstBufferSystem(bbcfg) as bb:
        mgr = BBCheckpointManager(bb, quantize=True)
        host_step(f"{cfg.name}: save")
        t0 = time.perf_counter()
        mgr.save(STEP, state)
        host_step(f"{cfg.name}: flush")
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
        check(not bb.manager.dead, f"servers {sorted(bb.manager.dead)} were "
              f"declared dead during the save and flush")
        host_memory(f"{cfg.name} save and flush")
        host_step(f"{cfg.name}: restore")
        t0 = time.perf_counter()
        restored, step = mgr.restore(target)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t["restore_s"] = time.perf_counter() - t0
        host_memory(f"{cfg.name} restore")
        host_step(f"{cfg.name}: serve the restored params")
        served = [serve_batch(cfg, model, restored["params"], p,
                              gen_tokens=gen_tokens, enc_input=enc_input)
                  for p in prompts]
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
            rg_lru.rg_lru_bwd, mlstm.mlstm, quant.quantize_blockwise,
            quant.dequantize_blockwise)


def training_restart(cfg, device, *, batch, seq, steps, dram_capacity,
                     int8=True, kill=True, keep_states=False):
    """A training path through ``launch/train.py::train_loop`` (slice 3's
    xlstm-350m, slice 4's starcoder2-3b), deterministic on the card: run A
    takes ``steps`` steps of ``batch`` x ``seq`` tokens; run B takes half of
    them, checkpoints unquantized into a burst buffer of 4 servers of
    ``dram_capacity`` bytes each, waits for the flush, loses server/0
    (``kill``; without it every server stays up), restores into a state
    drawn from another seed and takes the rest. B must equal A bit for bit.
    With ``int8``, A's final state then makes an int8-moment checkpoint in a
    fresh burst buffer, restored onto the card.

    Returns (timings, launches, n_quant, states); launches are the kernel
    counts of the whole path, n_quant the int8 leaves (0 without ``int8``),
    states (run A's final state, run B's) with ``keep_states``, else None.
    Raises SystemExit on any mismatch."""
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
    # without a kill, the serving paths' ping cadence: a 12.51 GB flush
    # stalled two servers' loops long enough at the default to be declared
    # dead (SERVE_STABILIZE_S)
    bbcfg = BBConfig(num_servers=4, num_clients=4,
                     dram_capacity=dram_capacity,
                     **({} if kill else
                        {"stabilize_interval": SERVE_STABILIZE_S}))
    restore_how = "after the kill" if kill else "with every server up"
    host_step(f"{cfg.name}: run A")
    state_a, hist_a, _ = train_loop(cfg, steps=steps, ckpt_every=0,
                                    seed=SEED, **kw)
    with BurstBufferSystem(bbcfg) as bb:
        host_step(f"{cfg.name}: run B to its save, and the flush")
        saved_b, hist_b, mgr = train_loop(cfg, steps=half,
                                          ckpt_every=half - 1, bb_system=bb,
                                          quantize_ckpt=False, seed=SEED,
                                          **kw)
        # the saved state's digest, not the state: a second train state on
        # the card through the resume is 12.5 GB at deepseek-v3's cut
        saved = _digests(saved_b.params, saved_b.opt_state)
        del saved_b
        t["save_s"] = mgr.metrics[half - 1]["ingest_s"]
        t["ckpt_bytes"] = mgr.metrics[half - 1]["bytes"]
        t["flush_s"] = wait_flushed(mgr, half - 1)
        check(mgr.metrics[half - 1].get("flushed"), f"the checkpoint was "
              f"not durable on the PFS after {t['flush_s']} s")
        t["settle_s"] = None
        if kill:
            bb.kill_server("server/0")
            host_step(f"{cfg.name}: failure handling after the kill")
            settle_s = t["settle_s"] = settle_after_kill(bb, "server/0")
            handled = (f"the buffer handled it in {settle_s:.1f}s (the "
                       f"manager counts it dead, the survivors' queues "
                       f"empty for {SETTLE_QUIET_S:.0f}s)"
                       if settle_s is not None else
                       f"the buffer was still busy after "
                       f"{SETTLE_TIMEOUT_S:.0f}s")
            print(f"[main] killed server/0; {handled}; restoring from its "
                  f"replicas into a state drawn from seed {SEED + 1}",
                  flush=True)
        else:
            check(not bb.manager.dead, f"servers {sorted(bb.manager.dead)} "
                  f"were declared dead during the save and flush")
            print(f"[main] no server killed; restoring from the buffer "
                  f"into a state drawn from seed {SEED + 1}", flush=True)
        _batch_build_ms(cfg, batch, seq, half)
        host_step(f"{cfg.name}: restore {restore_how}, run B resumed")
        state_b, hist_b2, mgr = train_loop(cfg, steps=steps, ckpt_every=0,
                                           bb_system=bb, restore=True,
                                           seed=SEED + 1, **kw)
        t["restore_s"] = mgr.metrics[half - 1].get("restore_s")
        if hist_b + hist_b2 != hist_a:
            _diagnose_restore(mgr, half - 1, saved, state_b)
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
    event = "kill" if kill else "no kill"
    print(f"[main] losses {[round(l, 4) for _, l in hist_a]}; run B ({event}"
          f", restore at step {half}) equals run A bit for bit in all "
          f"{len(a_leaves)} leaves of params and optimizer state",
          flush=True)
    del b_leaves
    if keep_states:
        states = (state_a, state_b)
    else:
        del state_b
        states = None
    if not int8:
        return t, {fn.__name__: fn.launches for fn in kernels}, 0, states

    # the step-``steps`` state through an int8-moment checkpoint
    state = {"params": state_a.params, "opt_state": state_a.opt_state,
             "data": {"step": torch.tensor(steps, dtype=torch.int32,
                                           device=device)}}
    target = map_tree(torch.zeros_like, state)
    with BurstBufferSystem(bbcfg) as bb:
        mgr = BBCheckpointManager(bb, quantize=True)
        host_step(f"{cfg.name}: int8 save")
        t0 = time.perf_counter()
        mgr.save(steps, state)
        t["qsave_s"] = time.perf_counter() - t0
        t["qckpt_bytes"] = mgr.metrics[steps]["bytes"]
        host_step(f"{cfg.name}: int8 flush")
        mgr.wait_flushes(timeout=600.0)
        t["qflush_s"] = mgr.metrics[steps].get("flush_s")
        host_step(f"{cfg.name}: int8 restore")
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
    return t, launches, n_quant, states


# the serving restarts' server ping cadence (the buffer's default: 0.25 s).
# A server misses three pings of 0.6 s and is declared dead when its loop
# stalls for ~2 s at the default, as while the flush assembles and writes
# its domain of the PFS file (3.2 GB a server of llama4's 12.95 GB); its
# peers then re-replicate every key they hold, which grew phase 3g's host
# memory to 96 GiB. At a 2 s cadence a server was still declared dead in
# 3g on one H100 host (a stall over 6 s). Three missed pings take ~20 s at
# 10 s (a server stalled for 7 s in a test: dead at 0.25 s, alive at 10
# s). No serving path kills a server; the training paths that do keep the
# default, and slice 10's, which kills none, takes this cadence (its
# 12.51 GB flush had two servers declared dead at the default)
SERVE_STABILIZE_S = 10.0
# how long the survivors' message queues must stay empty after a kill
# before the restore starts, and the longest a restore waits for that
SETTLE_QUIET_S = 2.0
SETTLE_TIMEOUT_S = 30.0


def settle_after_kill(bb, dead: str, timeout_s: float = SETTLE_TIMEOUT_S):
    """Wait until the burst buffer has handled the loss of ``dead``: the
    manager counts it dead and every surviving server's queue has stayed
    empty for ``SETTLE_QUIET_S``, as a restarted job starts once the
    failure is handled (the reference's restart demo waits a second).
    Each survivor re-replicates every key it holds when it learns of the
    death, up to twice, so the copies in flight come to several times the
    checkpoint; a restore that ran among them held up to 80 GiB of an H100
    host's 96 in phase 3e. Returns the seconds waited, or None if the
    buffer was still busy after ``timeout_s`` (the restore then starts all
    the same, as it did before this wait)."""
    t0 = time.perf_counter()
    survivors = [srv for name, srv in bb.servers.items() if name != dead]
    quiet_since = None
    while time.perf_counter() - t0 < timeout_s:
        now = time.perf_counter()
        if dead in bb.manager.dead and all(srv.ep.inbox.empty()
                                           for srv in survivors):
            quiet_since = quiet_since or now
            if now - quiet_since >= SETTLE_QUIET_S:
                return now - t0
        else:
            quiet_since = None
        time.sleep(0.05)
    return None


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


def _digests(params, opt_state):
    """{leaf path: the sum of its bit patterns as integers} of a train
    state's params and optimizer state, summed on the card in chunks of
    2^26 elements: what ``_diagnose_restore`` holds a second restore
    against, at a few bytes a leaf where the state would take its size."""
    import torch
    from repro_torch.checkpoint import serializer as ser
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for name, leaf in ser.tree_paths({"params": params,
                                      "opt_state": opt_state}):
        bits = leaf.reshape(-1).view(ints[leaf.element_size()])
        out[name] = sum(int(c.to(torch.int64).sum())
                        for c in bits.split(1 << 26))
    return out


def _diagnose_restore(mgr, step, saved, like):
    """After a resume that diverged: restore the step's checkpoint once
    more, from the same burst buffer, into zeros shaped as the train state
    ``like``, and print which leaves differ from the state that was saved
    (by their ``_digests``; none: the buffer gave the state back, and the
    divergence came after the restore)."""
    import torch
    from repro_torch.models.common import map_tree
    target = {"params": map_tree(torch.zeros_like, like.params),
              "opt_state": map_tree(torch.zeros_like, like.opt_state),
              "data": {"step": torch.zeros((), dtype=torch.int32,
                                           device=like.opt_state.step.device)}}
    restored, _ = mgr.restore(target, step)
    got = _digests(restored["params"], restored["opt_state"])
    bad = [name for name, digest in saved.items() if got.get(name) != digest]
    print(f"[diag] a second restore of the step-{step} checkpoint: "
          f"{len(bad)} leaves differ from the saved state {bad[:8]}; data "
          f"step {int(restored['data']['step'])}", flush=True)


def wait_flushed(mgr, step, timeout_s: float = 600.0):
    """Wait until the flush of checkpoint ``step`` has ended (it records
    ``flush_s``), at most ``timeout_s``; return its seconds, or None.
    ``train_loop`` waits 60 s for its flushes and then returns, and a
    restore that starts while the servers still write their domains to the
    PFS may find the manifest unreadable (``checkpoint/bbckpt.py``)."""
    t0 = time.perf_counter()
    while "flush_s" not in mgr.metrics[step] \
            and time.perf_counter() - t0 < timeout_s:
        time.sleep(0.05)
    return mgr.metrics[step].get("flush_s")


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


def _rss_kb() -> int:
    """This process's resident host memory in kB (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1])
    return 0


# the step the host is in, and the highest resident memory the sampler saw
# since the last ``host_memory`` report, with the step it was seen in; and
# when (on T_START's clock) the last report and the last phase ended
HOST_WATCH = {"step": "start", "peak_kb": 0, "peak_step": "start",
              "report_s": 0.0, "phase_s": 0.0}


def host_step(step: str):
    """Name the step the host is in for the resident-memory sampler."""
    HOST_WATCH["step"] = step


def start_host_watch(interval_s: float = 0.02):
    """Sample this process's resident memory every ``interval_s`` in a
    daemon thread, keeping the peak of each reporting window and the step
    it fell in: ``ru_maxrss`` gives only the run's one peak, and a save,
    flush or restore of the burst buffer holds its most for seconds."""
    import threading

    def watch():
        while True:
            kb = _rss_kb()
            if kb > HOST_WATCH["peak_kb"]:
                HOST_WATCH["peak_kb"] = kb
                HOST_WATCH["peak_step"] = HOST_WATCH["step"]
            time.sleep(interval_s)

    threading.Thread(target=watch, name="host-watch", daemon=True).start()


def elapsed_s() -> float:
    """Seconds since the script started (T_START, at import): the one clock
    of the ``[host]`` lines and ``[done]``."""
    return time.perf_counter() - T_START


def host_memory(what: str, phase_end: bool = False):
    """``release_host_memory`` and print this process's resident host
    memory now, its highest since the last report with the step it was
    reached in (``host_step``), and its peak so far; the time on
    ``elapsed_s``'s clock, the seconds since the last report and, at a
    phase's end (``phase_end``), the phase's own seconds since the last
    phase ended."""
    import resource
    release_host_memory()
    window_kb, window_step = HOST_WATCH["peak_kb"], HOST_WATCH["peak_step"]
    HOST_WATCH["peak_kb"] = 0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss   # kB
    now = elapsed_s()
    took = f"{now - HOST_WATCH['report_s']:.1f}s since the last report"
    HOST_WATCH["report_s"] = now
    if phase_end:
        took = f"the phase took {now - HOST_WATCH['phase_s']:.1f}s"
        HOST_WATCH["phase_s"] = now
    print(f"[host] after {what} at {now:.1f}s ({took}): resident memory "
          f"{_rss_kb()} kB; highest since the last report {window_kb} kB, "
          f"in {window_step} (peak so far {peak} kB)", flush=True)


# ------------------------------------------------------------------ phase 4


def device_profile(what: str, fn, scope: str = ""):
    """Run ``fn`` once under torch.profiler and print its wall time, the
    device's busy time (sum of kernel and copy times) and top kernels. The
    traced run is separate from the timed ones: tracing slows the host.
    ``scope``: the name of ``record_function`` ranges inside ``fn``; the
    device time of the kernels launched inside them is printed by the op
    that launched each (``_scope_device_ms``). Without a scope only the
    device is traced: the CPU ops are what makes a long trace slow to read
    (an xlstm-350m train step on an H100 host: 103 s traced and read with
    them, 33 s without, the same device busy time). Returns the busy ms
    and {label: device ms} of the port's kernels (None and {} when the
    profiler recorded no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if scope:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
        return None, {}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    port = {}
    for name, ms in top:
        if PORT_KERNEL.search(name):
            label = _kernel_label(name)
            port[label] = port.get(label, 0.0) + ms
    print(f"[profile] {what}: wall {wall_ms:.3f} ms (traced), device busy "
          f"{busy:.3f} ms = {100 * busy / wall_ms:.1f}% (idle "
          f"{100 - 100 * busy / wall_ms:.1f}%); top: " + "; ".join(
              f"{name[:60]} {ms:.3f} ms" for name, ms in top[:6])
          + "; the port's kernels: " + ("; ".join(
              f"{name} {ms:.3f} ms" for name, ms in port.items()) or "none"),
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
              f"%, the rest {inside - products:.3f} ms = "
              f"{100 * (inside - products) / max(inside, 1e-9):.1f}%: "
              + "; ".join(f"{op} {ms:.3f} ms" for op, ms in rest[:8]),
              flush=True)
    return busy, port


# the aten ops that run a matrix product's kernels
MATMUL_OPS = ("aten::bmm", "aten::mm", "aten::addmm", "aten::baddbmm")


def _scope_device_ms(prof, scope: str):
    """{aten op: device ms} of the kernels launched inside every CPU range
    named ``scope`` in ``prof``, each kernel under the op that launched it
    (its innermost CPU op). The port's kernels, launched through ctypes,
    are linked to no CPU op and do not show here."""
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


def time_serving(cfg, model, params, prompts, gen_tokens, enc_input=None):
    """Prefill ms (5 calls after 2 warm-up ones) and decode tok/s of one
    request, then a device profile of each. ``enc_input``: the frames the
    prefill encodes (configs with cross layers)."""
    import torch
    host_step(f"{cfg.name}: timing prefill and decode")
    b, s = prompts.shape
    with torch.inference_mode():
        def run_prefill():
            cache = model.init_cache(b, s + gen_tokens, device=prompts.device)
            return model.prefill(params, cache, prompts, enc_input)

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
        kinds = {k for unit, _ in cfg.segments for k in unit}
        has_moe = any(k.startswith("moe") or k.endswith("_moe")
                      for k in kinds)
        busy, port = device_profile(f"{cfg.name} prefill (B={b}, S={s})",
                                    run_prefill,
                                    scope="moe" if has_moe else "")
        if cfg.num_encoder_layers:
            encoder_split(cfg, params, enc_input, busy, port)
        logits, cache = run_prefill()
        device_profile(f"{cfg.name} decode ({gen_tokens - 1} steps, B={b})",
                       lambda: run_decode(logits, cache))
        if "cross" in kinds:
            # one step with its CPU ops traced: the attention over the
            # context's K / V cache runs in ranges "xattn_cache"
            # (models/attention.py::decode_cross_attention)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            device_profile(f"{cfg.name} decode step (B={b}, position {s})",
                           lambda: model.decode_step(params, cache, tok, s),
                           scope="xattn_cache")
    return prefill_ms, b * (gen_tokens - 1) / decode_s


def encoder_split(cfg, params, enc_input, busy, port):
    """The prefill's device time split between the encoder and the decoder
    (with the encoder's flash launches, the cross layers' K / V from the
    context, the unembedding): a device profile of the encoder alone, run
    as the prefill runs it, against the prefill's busy time ``busy`` and
    its port kernels ``port`` (``device_profile``'s). The port's kernels
    are linked to no CPU op, so a range inside the prefill cannot claim
    them; the stream runs the encoder's work alone either way."""
    from repro_torch.models import transformer
    b, frames = enc_input.shape[:2]
    enc_busy, enc_port = device_profile(
        f"{cfg.name} encoder alone (B={b}, {frames} frames)",
        lambda: transformer._encode(cfg, params, enc_input))
    if busy is None or enc_busy is None:
        return
    dec = busy - enc_busy
    dec_port = {name: ms - enc_port.get(name, 0.0)
                for name, ms in port.items()}
    print(f"[profile] {cfg.name} prefill split: encoder "
          f"{_share(enc_busy, busy)} of the prefill's busy {busy:.3f} ms, "
          f"the port's kernels in it {_shares(enc_port, enc_busy)}; decoder "
          f"{_share(dec, busy)}, the port's kernels in it "
          f"{_shares(dec_port, dec)}", flush=True)


def _share(ms, total):
    return f"{ms:.3f} ms = {100 * ms / max(total, 1e-9):.1f}%"


def _shares(port, total):
    return "; ".join(f"{name} {_share(ms, total)}"
                     for name, ms in port.items()) or "none"


def serving_numbers(cfg, t, model, params, prompts, gen_tokens,
                    enc_input=None):
    b, s = prompts.shape
    prefill_ms, decode_tps = time_serving(cfg, model, params, prompts,
                                          gen_tokens, enc_input)
    print(f"[numbers] {cfg.name}: save {t['save_s']:.3f}s (ingest of "
          f"{t['ckpt_bytes'] / 1e9:.3f} GB incl. on-card quantize), "
          f"flush {t['flush_s']}s (off the critical path), restore "
          f"{t['restore_s']:.3f}s, prefill {prefill_ms:.2f} ms "
          f"(B={b}, S={s}), decode {decode_tps:.1f} tok/s (B={b})",
          flush=True)


def _attended_pairs(case):
    """(q, k) pairs the case's masks leave, over every (b, h): query i sits
    at position i + q_offset and sees keys 0 .. Sk - 1, causal: up to its
    position, window: the last ``window`` positions up to its own."""
    b, sq, sk, h, _, _, causal, window, _, q_offset, *_ = case
    n = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(i - window + 1, 0) if window else 0
        n += max(hi - lo, 0)
    return b * h * n


def _flash_row(name, case, gen, launches, err, stats=False, plain_iters=20,
               v_pad=0):
    """Kernel, plain version and SDPA at one flash shape; the bound counts
    the (q, k) pairs the case's masks leave; ``stats``: the
    kernel also writes the row statistics (the training path's forward),
    m and l counted in its bytes; ``plain_iters``: the plain version's
    timed calls (after one warm-up when fewer than 20). ``ms`` and
    ``library_ms`` are CUDA-event times of back-to-back calls from Python,
    which include whatever of each call's host cost the device does not
    hide; ``graph_ms`` and ``library_graph_ms`` are device times of one
    call, from a CUDA graph of as many calls as take ~30 ms by the
    kernel's event time (2 to 200; each call's output stays allocated in
    the graph's pool). ``v_pad``: V zero in its last
    ``v_pad`` columns, as the MLA pads it (for the kernel, the plain
    version and SDPA alike)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    b, sq, sk, h, kv, d, causal, window, *_ = case
    q, k, v = _attn_inputs(case, gen)
    if v_pad:
        v[..., -v_pad:] = 0
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    pairs = _attended_pairs(case)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + (2 * 4 * b * sq * h if stats else 0)
    bms, by = bound(nbytes, 4 * d * pairs, BF16_FLOPS)
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **_sdpa_mask(case))
    kernel = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                        return_stats=stats)
    ms = cuda_ms(kernel)
    # graphs of ~30 ms: 20 calls of llama4's 13 ms prefill made a graph
    # of 260 ms, replayed 12 times for the kernel and for SDPA each
    calls = max(2, min(200, round(30 / ms)))
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "launches": launches, "max_abs_err": err,
        "ms": ms,
        "plain_ms": cuda_ms(lambda: ops.flash_chunked(q, k, v, causal=causal,
                                                      window=window),
                            iters=plain_iters,
                            warmup=3 if plain_iters >= 20 else 1),
        "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library),
        "graph_ms": graph_ms(kernel, calls=calls),
        "library_graph_ms": graph_ms(library, calls=calls),
    }


def _sdpa_mask(case):
    """SDPA's mask arguments for a case without a q offset: none, causal
    (``is_causal``, Sq = Sk), or a boolean mask for a window."""
    import torch
    _, sq, sk, *_, causal, window, _, q_offset, _, _ = case
    check(q_offset == 0 and (sq == sk or not causal), f"no SDPA mask for "
          f"{case}")
    if window and window < sk:
        pos = torch.arange(sk, device="cuda")
        keep = pos[None, :] > pos[:, None] - window
        return {"attn_mask": (pos[None, :] <= pos[:, None]) & keep
                if causal else keep}
    return {"is_causal": causal}


def _flash_bwd_row(name, case, gen, launches, err, ran, v_pad=0):
    """The backward kernel, its plain version and SDPA's backward at a
    training shape ``case``. The bound: q, o, dO and dq, k, v, dk and dv in
    bf16 and m, l in f32, each moved once; the reference's five products
    (S = q k^T, dP = dO v^T, dv, dq, dk) over the (q, k) pairs the causal
    and window masks leave, 2 D operations a pair each, against the bf16
    tensor-core peak. The library time is one ``torch.autograd.grad``
    through ``scaled_dot_product_attention(..., enable_gqa=True)`` (causal,
    or a boolean mask for a window shorter than S) on the same inputs in its
    (B, H, S, D) layout, timed alone. ``ran``: the device kernels of a
    launch at this shape (phase 2's profile). ``v_pad``: V and dO zero in
    their last ``v_pad`` columns, as the MLA pads them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    d, causal, window = case[5], case[6], case[7]
    q, k, v = _attn_inputs(case, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    if v_pad:
        v[..., -v_pad:] = 0
        do[..., -v_pad:] = 0
    with torch.no_grad():
        o, m, l = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     return_stats=True)
    nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * 2 * m.numel()
    bms, by = bound(nbytes, 5 * 2 * d * _attended_pairs(case), BF16_FLOPS)
    kernel = lambda: fa.flash_attention_bwd(q, k, v, o, m, l, do,
                                            causal=causal, window=window)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                  for a in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **_sdpa_mask(case))
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


def _rg_lru_train_rows(gen, launches, err_fwd, err_bwd):
    """The RG-LRU forward with its f32 carry and the backward kernel, each
    against its plain version, at the training shape RG_LRU_TRAIN (h0 None,
    no dh_last, as the model calls them). Bounds: the forward reads a and
    gx and writes h (in a's dtype) and the f32 carry, a multiply and an add
    an element; the backward reads a, dh (in a's dtype) and the f32 carry
    and writes da and dgx, 12 bytes an element in bf16, an add and two
    multiplies an element. No single PyTorch call computes either scan
    (library null). ``launches``: the training path's counts."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru

    a, gx, h0 = _rg_lru_inputs(RG_LRU_TRAIN, gen)
    dh = torch.randn(a.shape, generator=gen, device="cuda").to(a.dtype)
    b, s, d = a.shape
    n, es = b * s * d, a.element_size()
    rows = []
    fwd = lambda: rg_lru.rg_lru(a, gx, h0, return_carry=True)
    _, _, h32 = fwd()
    bwd = lambda: rg_lru.rg_lru_bwd(a, h32, dh)
    for name, kernel, plain, nbytes, flops, launch_count, err in (
            ("rg_lru_train", fwd,
             lambda: ref.rg_lru(a, gx, h0, return_carry=True),
             es * (3 * n + b * d) + 4 * n, 2 * n, launches["rg_lru"],
             err_fwd),
            ("rg_lru_bwd", bwd, lambda: ref.rg_lru_bwd(a, h32, dh),
             es * 4 * n + 4 * n, 3 * n, launches["rg_lru_bwd"], err_bwd)):
        bms, by = bound(nbytes, flops, F32_FLOPS)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
            # the backward: no Pallas counterpart, the reference takes the
            # VJP of its associative scan by autodiff
            "replaces": ("src/repro/kernels/rg_lru.py:48"
                         if name == "rg_lru_train"
                         else "src/repro/kernels/ops.py:196"),
            "launches": launch_count, "max_abs_err": err,
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, iters=3,
                                                      warmup=1),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "graph_ms": graph_ms(kernel, calls=20)})
    return rows


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
    ds3, wh = launches["deepseek-v3-671b"], launches["whisper-large-v3"]
    ds3t = launches["deepseek-v3-671b train"]
    wht = launches["whisper-large-v3 train"]
    rgt = launches["recurrentgemma-9b train"]
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
        # slice 12: the scan's forward with its f32 carry and its backward
        # at the training shape (2, 4096, 4096) bf16
        rows += _rg_lru_train_rows(gen, rgt, err["rg_lru_train"],
                                   err["rg_lru_bwd"])
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
        # slice 8: deepseek-v3-671b's MLA prefill at head dim 192 (V padded
        # as the path pads it), 128 heads; launches: parts A and B
        rows.append(_flash_row("flash_attention_mla", DS3_PREFILL_CASE, gen,
                               ds3["flash_attention"],
                               err["flash_attention_mla"], plain_iters=3,
                               v_pad=DS3_V_PAD))
        # slice 10: deepseek-v3-671b's training forward at head dim 192 with
        # row statistics (V padded); launches: the trunk's layer and the
        # MTP layer (2047 tokens) in each step of the path
        rows.append(_flash_row("flash_attention_train_mla",
                               DS3_TRAIN_ATTN_CASE, gen,
                               ds3t["flash_attention"],
                               err["flash_attention_train_mla"], stats=True,
                               plain_iters=3, v_pad=DS3_V_PAD))
        # slice 9: whisper-large-v3's prefill at head dim 64, 20 heads
        # (MHA); the row's times are the encoder's non-causal self-attention
        # over 1500 frames, as cross_* the decoder's non-causal attention of
        # 224 queries over the frames, as self_* its causal self-attention
        # over the prompt; launches: the path's, one a layer at each shape
        row = _flash_row("flash_attention_whisper", WH_ENC_CASE, gen,
                         wh["flash_attention"],
                         err["flash_attention_whisper"])
        for prefix, case in (("cross", WH_CROSS_CASE),
                             ("self", WH_SELF_CASE)):
            other = _flash_row(f"flash_attention_whisper_{prefix}", case,
                               gen, wh["flash_attention"],
                               err[f"flash_attention_whisper_{prefix}"])
            row.update({f"{prefix}_{key}": other[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "graph_ms", "library_graph_ms")})
        rows.append(row)
        # slice 11: whisper-large-v3's training forward with row statistics
        # at the encoder's shape (8, 1500 frames) and the cross-attention's
        # (448 queries over them); launches: the path's, at its three
        # shapes (a third at each)
        for name, case in (("flash_attention_train_whisper",
                            WH_TRAIN_ENC_CASE),
                           ("flash_attention_train_whisper_cross",
                            WH_TRAIN_CROSS_CASE)):
            rows.append(_flash_row(name, case, gen, wht["flash_attention"],
                                   err[name], stats=True))
        # slice 12: recurrentgemma-9b's training forward with row
        # statistics at head dim 256 over 2 x 4096 tokens, window 2048
        rows.append(_flash_row("flash_attention_train_d256",
                               RG_TRAIN_ATTN_CASE, gen,
                               rgt["flash_attention"],
                               err["flash_attention_train_d256"],
                               stats=True))
    # the backward at the training shapes; no main path trains h2o-danube,
    # so the D = 80 row has no launches; the D = 256 row's: slice 12's
    # attn_local layer; the D = 192 row's: slice 10's trunk and MTP layers;
    # the whisper rows': slice 11's three shapes, a third at each
    for name, case, runs, v_pad in (
            ("flash_attention_bwd", TRAIN_ATTN_CASE, sct, 0),
            ("flash_attention_bwd_dsc", DS_TRAIN_ATTN_CASE, ds, 0),
            ("flash_attention_bwd_d80", H2O_TRAIN_ATTN_CASE, h2o, 0),
            ("flash_attention_bwd_d256", RG_TRAIN_ATTN_CASE, rgt, 0),
            ("flash_attention_bwd_mla", DS3_TRAIN_ATTN_CASE, ds3t,
             DS3_V_PAD),
            ("flash_attention_bwd_whisper", WH_TRAIN_ENC_CASE, wht, 0),
            ("flash_attention_bwd_whisper_cross", WH_TRAIN_CROSS_CASE, wht,
             0)):
        rows.append(_flash_bwd_row(name, case, gen,
                                   runs["flash_attention_bwd"], err[name],
                                   bwd_ran[name], v_pad=v_pad))
    return rows


def training_path(cfg, device, *, batch, seq, steps, dram_capacity,
                  per_step, int8=True, timing=True, kill=True,
                  keep_states=False):
    """A training phase: ``training_restart`` (``int8``: with its int8
    round; ``kill``: server/0 lost before the restore) and, with
    ``timing``, ``training_numbers``, under torch's deterministic
    algorithms; the launch counts must be exactly ``per_step`` launches a
    step (run A's steps and run B's) of each kernel named there, the int8
    checkpoint's quantize and dequantize launches, and none of any other
    kernel. Without ``timing`` the step times are the ``[train]`` lines of
    run A and the peak device memory the path's. Prints the path's
    numbers and returns the launch counts and, with ``keep_states``, run
    A's and run B's final states (else None)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        t, launches, n_quant, states = training_restart(
            cfg, device, batch=batch, seq=seq, steps=steps,
            dram_capacity=dram_capacity, int8=int8, kill=kill,
            keep_states=keep_states)
        want = {name: 0 for name in launches}
        want.update({name: n * 2 * steps for name, n in per_step.items()})
        want.update(quantize_blockwise=n_quant, dequantize_blockwise=n_quant)
        print(f"[main] launches in train -> save -> "
              f"{'kill -> ' if kill else ''}restore -> "
              f"train{' -> int8 save -> restore' if int8 else ''}: "
              f"{launches} (expected {want})", flush=True)
        check(all(launches[name] > 0 for name in per_step)
              and launches == want, f"launch counts {launches} != {want}")
        if timing:
            training_numbers(cfg, device, batch, seq)
    finally:
        torch.use_deterministic_algorithms(False)
    if not timing:
        print(f"[numbers] {cfg.name}: step times in run A's [train] lines "
              f"(B={batch}, S={seq}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB over the "
              f"path", flush=True)
    restore = (f"restore after the kill {t['restore_s']:.3f}s (the buffer "
               f"handled the kill in {t['settle_s']}s before it)" if kill
               else f"restore {t['restore_s']:.3f}s (no server killed)")
    print(f"[numbers] {cfg.name}: save {t['save_s']:.3f}s (ingest of "
          f"{t['ckpt_bytes']} bytes = {t['ckpt_bytes'] / 1e9:.3f} GB, "
          f"unquantized; {2 * t['ckpt_bytes'] / 4 / 2**30:.2f} GiB a server "
          f"at replication 2 over 4 servers of {dram_capacity / 2**30:.0f} "
          f"GiB), flush {t['flush_s']}s (off the critical path), "
          f"{restore}", flush=True)
    if int8:
        print(f"[numbers] {cfg.name}: int8 save {t['qsave_s']:.3f}s "
              f"({t['qckpt_bytes'] / 1e9:.3f} GB incl. on-card quantize), "
              f"int8 flush {t['qflush_s']}s, int8 restore "
              f"{t['qrestore_s']:.3f}s", flush=True)
    return launches, states


def _layers(cfg, kind):
    return sum(unit.count(kind) * reps for unit, reps in cfg.segments)


def training_numbers(cfg, device, batch, seq):
    """Print ``time_training``'s numbers under torch's deterministic
    algorithms, as the path trains."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        step_s, tok_s, peak_gb, update_s = time_training(cfg, device, batch,
                                                         seq)
    finally:
        torch.use_deterministic_algorithms(False)
    frames = (f", and {batch * cfg.encoder_seq / step_s:.1f} frames/s "
              f"over {batch} x {cfg.encoder_seq} frames of "
              f"{cfg.encoder_dim}" if cfg.encoder_seq else "")
    print(f"[numbers] {cfg.name}: step {step_s:.3f}s ({tok_s:.1f} "
          f"tok/s, B={batch}, S={seq}{frames}), peak device memory "
          f"{peak_gb:.2f} GB, optimizer update {update_s:.4f}s",
          flush=True)


# the flash kernels' and the RG-LRU kernels' labels in a device profile,
# forward and backward
FLASH_FWD = re.compile(r"flash_(mma|simt)_kernel")
FLASH_BWD = re.compile(r"flash_bwd_")
RG_LRU_FWD = re.compile(r"rg_lru_(ring|step)_kernel")
RG_LRU_BWD = re.compile(r"rg_lru_bwd_kernel")


def time_training(cfg, device, batch, seq):
    """Step time, tokens/s and peak device memory of the train step at the
    path's shape (one step after a warm-up one, deterministic as on the
    path), one profiled step with the flash forward's and backward's share
    of its busy time (and the RG-LRU forward's and backward's, for configs
    with rglru layers), and the optimizer update's own seconds (host clock
    around ``synchronize``, after a warm-up update; the params stand in for
    the gradients)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.train import batch_to, build

    host_step(f"{cfg.name}: timing the train step")
    _, optimizer, state, step_fn = build(cfg, seed=SEED, device=device)
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, enc_seq=cfg.encoder_seq,
                               enc_dim=cfg.encoder_dim)
    # both batches on the card (frames included) before the clock starts
    batches = [batch_to(next(pipe), device) for _ in range(2)]
    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = step_fn(state, batches[1])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    what = f"{cfg.name} train step (B={batch}, S={seq})"
    busy, port = device_profile(what, lambda: step_fn(state, batches[0]))
    if busy:
        fwd, bwd, scan, scan_bwd = (
            sum(ms for name, ms in port.items() if label.match(name))
            for label in (FLASH_FWD, FLASH_BWD, RG_LRU_FWD, RG_LRU_BWD))
        rg = (f", the RG-LRU forward {_share(scan, busy)}, its backward "
              f"{_share(scan_bwd, busy)}" if "rglru" in {
                  k for unit, _ in cfg.segments for k in unit} else "")
        print(f"[profile] {what}: the flash forward {_share(fwd, busy)}, "
              f"the flash backward {_share(bwd, busy)}{rg} of the busy "
              f"{busy:.3f} ms", flush=True)
    with torch.no_grad():
        optimizer.update(state.params, state.opt_state, state.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.update(state.params, state.opt_state, state.params)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    return step_s, batch * seq / step_s, peak_gb, update_s


def rg_training(cfg, device):
    """Slice 12: ``cfg`` (recurrentgemma-9b's cut) trains through
    ``launch/train.py::train_loop`` under torch's deterministic algorithms
    on the pipeline's batches of RG_TRAIN_BATCH x RG_TRAIN_SEQ tokens, no
    checkpoint: run A RG_TRAIN_STEPS steps, then run B the same steps from
    the same seed. Run A's train state waits on the host (two train states
    of 19.40 GB and a step's logits and gradients do not fit the card
    together); B must equal A bit for bit in every leaf of params and
    optimizer state (``torch.equal`` leaf by leaf, each of A's leaves
    brought back to the card in turn), with exactly one RG-LRU forward and
    backward launch an ``rglru`` layer and one flash forward and backward
    an ``attn_local`` layer in each step of both runs, and no other
    kernel. Returns run A's params, back on the card, and the launch
    counts."""
    import torch
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.launch.train import train_loop
    from repro_torch.models.common import map_tree

    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    kw = dict(steps=RG_TRAIN_STEPS, global_batch=RG_TRAIN_BATCH,
              seq_len=RG_TRAIN_SEQ, ckpt_every=0, log_every=1, seed=SEED,
              device=device)
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        host_step(f"{cfg.name}: train run A")
        state_a, hist_a, _ = train_loop(cfg, **kw)
        host_step(f"{cfg.name}: park run A's train state on the host")
        t0 = time.perf_counter()
        parked = map_tree(lambda t: t.cpu(), state_a)
        park_s = time.perf_counter() - t0
        del state_a
        host_step(f"{cfg.name}: train run B")
        state_b, hist_b, _ = train_loop(cfg, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(hist_b == hist_a, f"losses of run B {hist_b} != run A's {hist_a}")
    check(all(torch.isfinite(torch.tensor(l)) for _, l in hist_a),
          f"non-finite loss: {hist_a}")
    host_step(f"{cfg.name}: run B against run A, leaf by leaf")
    t0 = time.perf_counter()
    a_leaves = dict(ser.tree_paths(parked))
    b_leaves = ser.tree_paths(state_b)
    check([n for n, _ in b_leaves] == list(a_leaves),
          "run B's state has other leaves")
    for name, leaf in b_leaves:
        check(torch.equal(leaf, a_leaves[name].to(device)), f"{name}: run "
              f"B differs from run A")
    compare_s = time.perf_counter() - t0
    n_leaves = len(b_leaves)
    nbytes = sum(leaf.numel() * leaf.element_size() for _, leaf in b_leaves)
    del state_b, b_leaves, a_leaves
    params = map_tree(lambda t: t.to(device), parked.params)
    del parked
    per_step = {"rg_lru": _layers(cfg, "rglru"),
                "rg_lru_bwd": _layers(cfg, "rglru"),
                "flash_attention": _layers(cfg, "attn_local"),
                "flash_attention_bwd": _layers(cfg, "attn_local")}
    want = {name: 0 for name in launches}
    want.update({name: n * 2 * RG_TRAIN_STEPS
                 for name, n in per_step.items()})
    print(f"[main] launches in train run A -> run B: {launches} (expected "
          f"{want})", flush=True)
    check(launches == want and launches["rg_lru_bwd"] == 24
          and launches["flash_attention_bwd"] == 8,
          f"launch counts {launches} != {want}")
    print(f"[main] losses {[round(l, 4) for _, l in hist_a]}; run B (the "
          f"same {RG_TRAIN_STEPS} steps from seed {SEED}) equals run A bit "
          f"for bit in all {n_leaves} leaves of params and AdamW state "
          f"({nbytes / 1e9:.2f} GB); run A's state parked on the host in "
          f"{park_s:.3f}s, compared in {compare_s:.3f}s; peak device memory "
          f"{peak_gb:.2f} GB over both runs", flush=True)
    return params, launches


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator maps growable segments inside the block (phase
    3b): a recurrentgemma-9b step allocates its 2 x 4096 x 256,000 logits
    in f32 and their gradient in blocks of 8.4 GB, and with fixed segments
    the blocks cached by earlier steps left 16.4 GB reserved but unused on
    an H100, so the third step found no 7.81 GiB block among the card's
    79.18 GiB (60.0 GiB allocated). The setting covers only segments
    mapped after it, so the cache the earlier phases left (11.8 GiB of
    fixed segments in one run) is emptied first; the setting is put back,
    and the cache emptied again, on the way out."""
    import torch
    torch.cuda.empty_cache()
    print(f"[memory] entering expandable segments: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved",
          flush=True)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def recurrentgemma_path(device):
    """Phase 3b, slices 12 and 2: recurrentgemma-9b at full width, one
    repeat of each segment unit (4 of 38 layers: 3 ``rglru``, 1
    ``attn_local``; 1.94 G params). It trains (``rg_training``: AdamW on
    2 x 4096 tokens, past the 2048-token window, the RG-LRU forward and
    backward kernels and the D = 256 flash forward and backward in every
    step, run B bit for bit run A); then run A's trained params restart
    from a params-only checkpoint and serve 3 request batches of
    3072-token prompts (slice 2: the RG-LRU kernel in every prefill and
    decode step, tokens equal to those served from the un-saved params);
    then the train step is timed and profiled. Prints the path's numbers
    and returns the serving and the training launch counts."""
    import torch
    from repro_torch.configs.base import get_config

    # depth cut as the reference's reduced() cuts it
    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, segments=tuple(
        (unit, min(reps, 1)) for unit, reps in full.segments))
    check(cfg.resolved_head_dim == RG_HEAD_DIM
          and cfg.window_size == RG_WINDOW and cfg.lru_width == RG_WIDTH
          and cfg.num_heads == RG_HEADS and cfg.num_kv_heads == 1
          and cfg.optimizer == "adamw" and cfg.param_dtype == "bfloat16",
          "recurrentgemma-9b shapes")
    n = cfg.param_count()
    print(f"[main] {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} GeGLU, lru_width "
          f"{cfg.lru_width}, conv {cfg.conv1d_width}, window "
          f"{cfg.window_size}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}), reduced: segments {full.segments} -> "
          f"{cfg.segments}, num_layers {full.num_layers} -> "
          f"{cfg.num_layers}; {n} params; trains with AdamW (moments and "
          f"grad accumulation {cfg.grad_accum_dtype}, train state "
          f"{(2 + 2 * 4) * n / 1e9:.2f} GB) on batches of {RG_TRAIN_BATCH} "
          f"x {RG_TRAIN_SEQ} tokens, {RG_TRAIN_STEPS} steps twice, no "
          f"checkpoint; then run A's params restart from a params-only "
          f"checkpoint and serve {RG_REQUESTS} x {RG_BATCH} prompts of "
          f"{RG_PROMPT} tokens past the window", flush=True)
    with expandable_segments():
        params, train_launches = rg_training(cfg, device)
        host_memory(f"{cfg.name} training")
        t, launches, (model, params, prompts, n_quant) = serving_restart(
            cfg, device, batch=RG_BATCH, prompt=RG_PROMPT,
            gen_tokens=RG_GEN, requests=RG_REQUESTS, dram_capacity=4 << 30,
            train_state=False, params=params)
        want = {name: 0 for name in launches}
        want.update(flash_attention=_layers(cfg, "attn_local") * RG_REQUESTS,
                    rg_lru=_layers(cfg, "rglru") * RG_GEN * RG_REQUESTS,
                    quantize_blockwise=n_quant, dequantize_blockwise=n_quant)
        print(f"[main] launches in save -> restore -> serve: {launches} "
              f"(expected {want})", flush=True)
        check(launches == want, f"launch counts {launches} != {want}")
        serving_numbers(cfg, t, model, params, prompts, RG_GEN)
        del model, params, prompts
        training_numbers(cfg, device, RG_TRAIN_BATCH, RG_TRAIN_SEQ)
    return launches, train_launches


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
            "flash_attention_bwd": 0, "rg_lru": 0, "rg_lru_bwd": 0,
            "mlstm": 0, "quantize_blockwise": n_quant,
            "dequantize_blockwise": n_quant}
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


def absorbed_decode_check(cfg, model, params, prompts, tol):
    """The absorbed MLA decode held against the reconstructed path: one
    decode step at position S, fed each row's first greedy token, against a
    ``prefill`` over those S + 1 tokens (the flash kernel over K and V
    rebuilt from the latent), as relative L2 errors a row, at most ``tol``.
    Held first at the output of the first layer's MLA attention, whose
    input (the token embeddings) is the same in both runs, so that only
    the two attention paths differ there (the new token's attention output
    in decode against the prefill's last position): every row. A later
    layer's attention takes the first layer's differences with its input
    (on an H100 the second layer's reached 2.4e-2 to 3.1e-2 where the
    first's were 7.9e-3 to 9.7e-3), so it is printed, not held. Then at the
    logits over the real vocabulary: a row whose new token the two runs
    route to other experts, or which the prefill drops past an expert's
    capacity (a decode step of B tokens never drops), is a different
    function there, not an error of the attention, so such rows are named
    and left out of the logits, and at least one row must be left. Runs two prefills and one decode step.
    Returns ({row: the logits' relative error} of the rows held there,
    [each row's relative error at the first layer's attention output])."""
    import torch
    from repro_torch.models import mla, moe
    from repro_torch.runtime.serve_step import greedy_token

    b, s = prompts.shape
    routes, attn = [], []
    route, attend, decode = moe.route, mla.mla_attend, mla.decode_mla_attention

    def recording_route(cfg_, p, xt):
        topw, topi = route(cfg_, p, xt)
        routes.append(topi)
        return topw, topi

    def recording_attend(cfg_, p, x, positions):
        out = attend(cfg_, p, x, positions)
        attn.append(out[0][:, -1].float())
        return out

    def recording_decode(cfg_, p, x, cache, pos):
        out = decode(cfg_, p, x, cache, pos)
        attn.append(out[0][:, 0].float())
        return out

    def last_tokens(topi, n_seq):
        """(ids, kept) of each row's last token: (B, k) each."""
        t = topi.shape[0]
        flat = topi.reshape(-1)
        cap = moe.capacity(cfg, t)
        rows = torch.arange(b, device=topi.device) * n_seq + n_seq - 1
        idx = rows[:, None] * cfg.top_k + torch.arange(
            cfg.top_k, device=topi.device)
        # rank within expert, as the dispatch's stable sort orders them
        before = torch.arange(flat.numel(), device=topi.device)[None, None] \
            < idx[..., None]
        rank = ((flat[None, None] == flat[idx][..., None]) & before).sum(-1)
        return flat[idx], rank < cap

    moe.route = recording_route
    mla.mla_attend, mla.decode_mla_attention = recording_attend, \
        recording_decode
    try:
        with torch.inference_mode():
            cache = model.init_cache(b, s + 1, device=prompts.device)
            logits, cache = model.prefill(params, cache, prompts)
            tok = greedy_token(cfg, logits).to(prompts.dtype)
            routes.clear()
            attn.clear()
            dec, _ = model.decode_step(params, cache, tok, s)
            dec_routes = [last_tokens(r, 1) for r in routes]
            dec_attn = list(attn)
            routes.clear()
            attn.clear()
            full = torch.cat([prompts, tok], dim=1)
            ref, _ = model.prefill(
                params, model.init_cache(b, s + 1, device=prompts.device),
                full)
            pre_routes = [last_tokens(r, s + 1) for r in routes]
            pre_attn = list(attn)
    finally:
        moe.route = route
        mla.mla_attend, mla.decode_mla_attention = attend, decode
    check(len(dec_routes) == len(pre_routes), "absorbed decode check: "
          f"{len(dec_routes)} routed layers in decode, {len(pre_routes)} "
          f"in prefill")
    kinds = [k for unit, reps in cfg.segments for _ in range(reps)
             for k in unit]
    check(kinds[0].startswith("mla") and len(dec_attn) == len(pre_attn)
          == sum(k.startswith("mla") for k in kinds), "absorbed decode "
          f"check: {len(dec_attn)} MLA layers in decode, {len(pre_attn)} in "
          f"prefill, layers {kinds}")
    attn_rel = [((d - r).norm(dim=-1) / r.norm(dim=-1)).tolist()
                for d, r in zip(dec_attn, pre_attn)]
    print(f"[mla] absorbed decode at position {s} against a prefill over "
          f"{s + 1} tokens, relative L2 error a row at the attention output "
          + "; ".join(f"of MLA layer {i}: "
                      + ", ".join(f"row {r} {e:.3e}" for r, e in
                                  enumerate(errs))
                      for i, errs in enumerate(attn_rel))
          + f" (tol {tol:.3e}, held at layer 0, every row)", flush=True)
    worst = max(attn_rel[0])
    check(worst <= tol, f"absorbed decode check: relative error "
          f"{worst:.3e} above {tol:.3e} at the first layer's attention "
          f"output, row {attn_rel[0].index(worst)}")
    rerouted = torch.zeros(b, dtype=torch.bool, device=prompts.device)
    dropped = torch.zeros_like(rerouted)
    for (di, dk), (pi, pk) in zip(dec_routes, pre_routes):
        rerouted |= (di != pi).any(dim=-1)
        dropped |= (dk != pk).any(dim=-1)
    v = cfg.vocab_size
    diff = (dec[:, 0, :v].float() - ref[:, 0, :v].float()).norm(dim=-1)
    rel = (diff / ref[:, 0, :v].float().norm(dim=-1)).tolist()
    other = {r: ("routed otherwise" if rerouted[r] else "")
             + (" and " if rerouted[r] and dropped[r] else "")
             + ("dropped in the prefill" if dropped[r] else "")
             for r in range(b) if rerouted[r] or dropped[r]}
    held = {r: rel[r] for r in range(b) if r not in other}
    print(f"[mla] absorbed decode at position {s} against a prefill over "
          f"{s + 1} tokens, relative L2 error of the logits a row: "
          + ", ".join(f"row {r} {e:.3e}" for r, e in enumerate(rel))
          + f" (tol {tol:.3e}); rows left out: "
          + (", ".join(f"row {r} ({why})" for r, why in other.items())
             or "none"), flush=True)
    check(bool(held), "absorbed decode check: every row's new token was "
          "routed otherwise or dropped in the prefill")
    worst = max(held.values())
    check(worst <= tol, f"absorbed decode check: relative error {worst:.3e} "
          f"above {tol:.3e}")
    return held, attn_rel[0]


def serve_from_runs(cfg, model, states, prompts, gen_tokens, per_prefill,
                    enc_input=None):
    """Serve ``prompts`` from run B's params and then from run A's
    (``states``: run A's final train state, run B's): the same tokens, and
    the flash forward launched ``per_prefill`` times a prefill and no other
    kernel. ``enc_input``: the frames every prefill encodes. Returns the
    launch counts."""
    import torch
    from repro_torch.launch.serve import serve_batch
    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    runs = [[serve_batch(cfg, model, state.params, p, gen_tokens=gen_tokens,
                         enc_input=enc_input) for p in prompts]
            for state in reversed(states)]
    launches = {fn.__name__: fn.launches for fn in kernels}
    batch = prompts[0].shape[0]
    for r, (a, b) in enumerate(zip(*runs)):
        check(a.shape == (batch, gen_tokens), f"request {r}: {a.shape}")
        check(torch.equal(a, b), f"request {r}: run B's params served "
              f"other tokens than run A's")
    want = {name: 0 for name in launches}
    want["flash_attention"] = per_prefill * 2 * len(prompts)
    print(f"[main] launches in serve x 2: {launches} (expected {want}); "
          f"{len(prompts)} x {batch} requests served {gen_tokens} tokens "
          f"each from run B's restored and resumed params, equal to run "
          f"A's", flush=True)
    check(launches == want, f"launch counts {launches} != {want}")
    return launches


def deepseek_v3_path(device):
    """Phase 3h, slices 8 and 10: deepseek-v3-671b at full width through
    the MLA kinds. Part A (slice 10): one ``mla_dense`` layer and the MTP
    module (an ``mla_dense`` layer too) train with Adafactor and the MTP
    loss through ``train_loop`` and a checkpoint in the burst buffer (a
    restore into a state from another seed, no kill), run B bit for bit
    run A; then the same requests are served from run B's params and from
    run A's (equal tokens). Part B (slice 8): one ``mla_dense`` and one
    ``mla_moe`` layer (top-8 of 256 experts and a shared expert), no MTP,
    built on the card from the seed, serves the requests twice (equal
    tokens) and holds the absorbed decode against the reconstructed path.
    Prints both parts' numbers and returns the serving launch counts of
    parts A and B summed, and part A's training launch counts."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.registry import build_model

    full = get_config("deepseek-v3-671b")
    check((full.d_model, full.num_heads, full.q_lora_rank, full.kv_lora_rank,
           full.qk_nope_head_dim, full.qk_rope_head_dim, full.v_head_dim)
          == (7168, DS3_HEADS, 1536, 512, 128, 64, 128)
          and full.qk_nope_head_dim + full.qk_rope_head_dim == DS3_HEAD_DIM
          and (full.num_experts, full.top_k, full.d_ff_expert,
               full.num_shared_experts, full.d_ff_shared, full.d_ff,
               full.vocab_size) == (256, 8, 2048, 1, 2048, 18432, 129280)
          and full.param_dtype == "bfloat16", "deepseek-v3-671b shapes")
    print(f"[main] {full.name} full width (d_model {full.d_model}, "
          f"{full.num_heads} heads, MLA q_lora {full.q_lora_rank}, kv_lora "
          f"{full.kv_lora_rank}, qk_nope {full.qk_nope_head_dim}, qk_rope "
          f"{full.qk_rope_head_dim}, v {full.v_head_dim}; {full.num_experts}"
          f" experts at top-{full.top_k} of d_ff {full.d_ff_expert}, "
          f"capacity factor {full.capacity_factor}, "
          f"{full.num_shared_experts} shared of d_ff {full.d_ff_shared}; "
          f"dense d_ff {full.d_ff}; vocab {full.vocab_size}; "
          f"{full.param_dtype}); full config: segments {full.segments}, MTP "
          f"depth {full.mtp_depth}, {full.param_count()} params", flush=True)

    # part A: training through the burst buffer, then serving
    cfg = dataclasses.replace(full, segments=DS3_SEGMENTS_A)
    n = cfg.param_count()
    mla = _layers(cfg, "mla_dense") + cfg.mtp_depth
    print(f"[main] {full.name} part A, reduced: segments {full.segments} -> "
          f"{cfg.segments}, num_layers {full.num_layers} -> "
          f"{cfg.num_layers}, MTP depth {cfg.mtp_depth} (its layer "
          f"{cfg.segments[-1][0][-1]}, the trunk's last kind; mla_moe in the "
          f"full config); {n} params; trains with Adafactor (momentum 0.9 "
          f"in bf16, factored f32 second moments), grad accumulation "
          f"{cfg.grad_accum_dtype}, the MTP loss at weight 0.3; batch "
          f"{DS3_TRAIN_BATCH} x {DS3_TRAIN_SEQ} tokens, {DS3_TRAIN_STEPS} "
          f"steps; unquantized checkpoint about {4 * n / 1e9:.2f} GB (bf16 "
          f"params and m) and the second moments, over 4 servers of "
          f"{DS3_DRAM / 2**30:.0f} GiB DRAM, no server killed; then "
          f"{DS3_REQUESTS} x {DS3_BATCH} prompts of {DS3_PROMPT} tokens "
          f"served from run B's params", flush=True)
    train_launches, (state_a, state_b) = training_path(
        cfg, device, batch=DS3_TRAIN_BATCH, seq=DS3_TRAIN_SEQ,
        steps=DS3_TRAIN_STEPS, dram_capacity=DS3_DRAM,
        per_step={"flash_attention": mla, "flash_attention_bwd": mla},
        int8=False, timing=False, kill=False, keep_states=True)
    check(train_launches["flash_attention"] == 16, f"{train_launches}")
    host_memory(f"{full.name} part A training")

    host_step(f"{cfg.name} part A: serve run B's params and run A's")
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    prompts = [torch.randint(1, cfg.vocab_size, (DS3_BATCH, DS3_PROMPT),
                             generator=gen, device=device)
               for _ in range(DS3_REQUESTS)]
    # each prefill launches the flash forward once an MLA layer of the
    # trunk (serving never reads the MTP module)
    launches_a = serve_from_runs(cfg, model, (state_a, state_b), prompts,
                                 DS3_GEN, _layers(cfg, "mla_dense"))
    check(launches_a["flash_attention"] == 6, f"{launches_a}")
    del state_a
    prefill_ms, decode_tps = time_serving(cfg, model, state_b.params,
                                          prompts[0], DS3_GEN)
    print(f"[numbers] {cfg.name} part A: prefill {prefill_ms:.2f} ms "
          f"(B={DS3_BATCH}, S={DS3_PROMPT}), decode {decode_tps:.1f} tok/s "
          f"(B={DS3_BATCH}) from run B's params", flush=True)
    del model, prompts, state_b
    training_numbers(cfg, device, DS3_TRAIN_BATCH, DS3_TRAIN_SEQ)
    host_memory(f"{full.name} part A")

    # part B: the MoE layer at full width, on the card
    cfg = dataclasses.replace(full, segments=DS3_SEGMENTS_B, mtp_depth=0)
    n = cfg.param_count()
    print(f"[main] {full.name} part B, reduced: segments {full.segments} -> "
          f"{cfg.segments}, num_layers {full.num_layers} -> "
          f"{cfg.num_layers}, MTP depth {full.mtp_depth} -> 0 (training "
          f"only: prefill and decode never read it); {n} params, "
          f"{2 * n / 1e9:.2f} GB, drawn on the card from seed {SEED}, not "
          f"through the burst buffer: a restart holds the un-saved params, "
          f"the zero target and the restored params on the card "
          f"({3 * 2 * n / 1e9:.1f} GB of its 80) and about 4.75 x the "
          f"checkpoint on the host ({4.75 * 2 * n / 2**30:.0f} GiB of its "
          f"96)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    host_step(f"{cfg.name} part B: init, serve twice, absorbed decode check")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    prompts = [torch.randint(1, cfg.vocab_size, (DS3_BATCH, DS3_PROMPT),
                             generator=gen, device=device)
               for _ in range(DS3_REQUESTS)]
    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    runs = [[serve_batch(cfg, model, params, p, gen_tokens=DS3_GEN)
             for p in prompts] for _ in range(2)]
    for r, (a, b) in enumerate(zip(*runs)):
        check(a.shape == (DS3_BATCH, DS3_GEN), f"request {r}: {a.shape}")
        check(torch.equal(a, b), f"request {r}: two runs served other "
              f"tokens")
    absorbed_decode_check(cfg, model, params, prompts[0], MLA_DECODE_TOL)
    launches_b = {fn.__name__: fn.launches for fn in kernels}
    # each prefill launches the flash forward once an MLA layer: 2 serving
    # runs of the requests and the check's two prefills
    layers = _layers(cfg, "mla_dense") + _layers(cfg, "mla_moe")
    want = {name: 0 for name in launches_b}
    want["flash_attention"] = layers * (2 * DS3_REQUESTS + 2)
    print(f"[main] launches in serve x 2 -> absorbed decode check: "
          f"{launches_b} (expected {want}); {DS3_REQUESTS} x {DS3_BATCH} "
          f"requests served {DS3_GEN} tokens each, equal in both runs",
          flush=True)
    check(launches_b == want and launches_b["flash_attention"] == 16,
          f"launch counts {launches_b} != {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms, decode_tps = time_serving(cfg, model, params, prompts[0],
                                          DS3_GEN)
    print(f"[numbers] {cfg.name} part B: params drawn on the card in "
          f"{init_s:.3f}s, peak device memory {peak_gb:.2f} GB over serve x "
          f"2 -> check ({2 * n / 1e9:.2f} GB of params), prefill "
          f"{prefill_ms:.2f} ms (B={DS3_BATCH}, S={DS3_PROMPT}), decode "
          f"{decode_tps:.1f} tok/s (B={DS3_BATCH})", flush=True)
    del model, params, prompts, runs
    return ({name: launches_a[name] + launches_b[name]
             for name in launches_a}, train_launches)


def whisper_path(device):
    """Phase 3i, slices 9 and 11: whisper-large-v3 at full width, depth cut
    to WH_LAYERS enc and cross layers of its 32 + 32. It trains with AdamW
    through ``train_loop`` and a checkpoint in the burst buffer (slice 11:
    batches of 8 x 448 tokens over 8 x 1500 frames from the pipeline, a
    restore into a state from another seed with every server up, run B
    bit for bit run A); then serves slice 9's requests (4 x 1500 frames
    drawn from the seed, 224-token prompts) from run B's params and from
    run A's (equal tokens), and times the prefill, decode and a train step.
    Prints the path's numbers and returns the serving launch counts and the
    training launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model

    full = get_config("whisper-large-v3")
    check((full.d_model, full.num_heads, full.num_kv_heads,
           full.resolved_head_dim, full.d_ff, full.vocab_size)
          == (1280, WH_HEADS, WH_HEADS, WH_HEAD_DIM, 5120, 51866)
          and full.segments == ((("cross",), 32),)
          and (full.num_encoder_layers, full.encoder_seq, full.encoder_dim)
          == (32, WH_FRAMES, 1280)
          and (full.norm, full.act, full.mlp_gated, full.pos_embed,
               full.tie_embeddings) == ("layernorm", "gelu", False,
                                        "learned", True)
          and full.param_dtype == "bfloat16"
          and full.optimizer == "adamw", "whisper-large-v3 shapes")
    cfg = dataclasses.replace(full, segments=((("cross",), WH_LAYERS),),
                              num_encoder_layers=WH_LAYERS)
    n = cfg.param_count()
    # each forward launches the flash kernel once an enc layer and twice a
    # cross layer (self-attention over the tokens, attention to the frames)
    per_pass = cfg.num_encoder_layers + 2 * _layers(cfg, "cross")
    print(f"[main] {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads (MHA), head_dim {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff} GELU, LayerNorm, vocab {cfg.vocab_size} tied, "
          f"learned decoder positions ({cfg.max_position}), sincos encoder "
          f"positions, {cfg.param_dtype}), reduced: {full.num_encoder_layers}"
          f" enc + {full.num_layers} cross layers -> "
          f"{cfg.num_encoder_layers} + {cfg.num_layers}; {n} params; trains "
          f"with AdamW (moments and grad accumulation "
          f"{cfg.grad_accum_dtype}) on batches of {WH_TRAIN_BATCH} x "
          f"{WH_TRAIN_SEQ} tokens over {WH_TRAIN_BATCH} x {cfg.encoder_seq} "
          f"frames of {cfg.encoder_dim}, {WH_TRAIN_STEPS} steps; unquantized "
          f"checkpoint about {(2 + 2 * 4) * n / 1e9:.2f} GB over 4 servers "
          f"of {WH_DRAM / 2**30:.0f} GiB DRAM, no server killed; then "
          f"{WH_REQUESTS} requests of {WH_BATCH} x {cfg.encoder_seq} frames "
          f"(30 s of audio) and a {WH_PROMPT}-token prompt, {WH_GEN} new "
          f"tokens, served from run B's params", flush=True)
    train_launches, (state_a, state_b) = training_path(
        cfg, device, batch=WH_TRAIN_BATCH, seq=WH_TRAIN_SEQ,
        steps=WH_TRAIN_STEPS, dram_capacity=WH_DRAM,
        per_step={"flash_attention": per_pass,
                  "flash_attention_bwd": per_pass},
        int8=False, timing=False, kill=False, keep_states=True)
    check(train_launches["flash_attention"] == 48
          and train_launches["flash_attention_bwd"] == 48,
          f"{train_launches}")
    host_memory(f"{cfg.name} training")

    host_step(f"{cfg.name}: serve run B's params and run A's")
    model = build_model(cfg)
    enc = torch.as_tensor(np.random.default_rng(SEED).normal(
        0, 1, (WH_BATCH, cfg.encoder_seq, cfg.encoder_dim)),
        dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    prompts = [torch.randint(1, cfg.vocab_size, (WH_BATCH, WH_PROMPT),
                             generator=gen, device=device)
               for _ in range(WH_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    launches = serve_from_runs(cfg, model, (state_a, state_b), prompts,
                               WH_GEN, per_pass, enc_input=enc)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_attention"] == 36, f"{launches}")
    del state_a
    prefill_ms, decode_tps = time_serving(cfg, model, state_b.params,
                                          prompts[0], WH_GEN, enc)
    print(f"[numbers] {cfg.name}: prefill {prefill_ms:.2f} ms (B={WH_BATCH}"
          f", S={WH_PROMPT} over {cfg.encoder_seq} frames), decode "
          f"{decode_tps:.1f} tok/s (B={WH_BATCH}) from run B's params; "
          f"peak device memory {peak_gb:.2f} GB over serve x 2 (two train "
          f"states on the card)", flush=True)
    del model, prompts, state_b, enc
    training_numbers(cfg, device, WH_TRAIN_BATCH, WH_TRAIN_SEQ)
    return launches, train_launches


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
    start_host_watch()
    device = torch.device("cuda")

    environment()
    host_step("phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    err, bwd_ran = check_kernels(gen)
    host_memory("phase 2", phase_end=True)

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
            "rg_lru": 0, "rg_lru_bwd": 0, "mlstm": 0, "quantize_blockwise": n_quant,
            "dequantize_blockwise": n_quant}
    print(f"[main] launches in save -> restore -> serve: {launches} "
          f"(expected {want})", flush=True)
    check(launches == want, f"launch counts {launches} != {want}")
    serving_numbers(cfg, t, model, params, prompts, GEN)
    del model, params, prompts
    host_memory("phase 3", phase_end=True)

    # phase 3b: slices 12 and 2, recurrentgemma-9b trains, then restarts
    # from a params-only checkpoint of its trained params and serves
    rg_launches, rg_train_launches = recurrentgemma_path(device)
    host_memory("phase 3b", phase_end=True)

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
    xl_launches, _ = training_path(
        xl_cfg, device, batch=XL_BATCH, seq=XL_SEQ, steps=XL_STEPS,
        dram_capacity=XL_DRAM, per_step={"mlstm": _layers(xl_cfg, "mlstm")},
        int8=False, timing=False)
    host_memory("phase 3c", phase_end=True)

    # phase 3d: slice 4's path, starcoder2-3b training through a server
    # kill; depth cut to SC_LAYERS
    cfg = dataclasses.replace(cfg, segments=((("attn",), SC_LAYERS),))
    n = cfg.param_count()
    ckpt = 2 * n + 2 * 4 * n          # bf16 params, f32 AdamW m and v
    print(f"[main] {cfg.name} training, full width as in phase 3, params "
          f"{cfg.param_dtype}, compute {cfg.compute_dtype}, grad "
          f"accumulation and AdamW moments {cfg.grad_accum_dtype}; "
          f"reduced: num_layers 30 -> {SC_LAYERS}; {n} params; batch "
          f"{SC_BATCH} x {SC_SEQ} tokens, {SC_STEPS} steps; unquantized "
          f"checkpoint {ckpt / 1e9:.3f} GB, {2 * ckpt / 4 / 2**30:.2f} GiB "
          f"a server at replication 2 over 4 servers of "
          f"{SC_DRAM / 2**30:.0f} GiB DRAM", flush=True)
    sc_launches, _ = training_path(
        cfg, device, batch=SC_BATCH, seq=SC_SEQ, steps=SC_STEPS,
        dram_capacity=SC_DRAM,
        per_step={"flash_attention": SC_LAYERS,
                  "flash_attention_bwd": SC_LAYERS})
    host_memory("phase 3d", phase_end=True)

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
    ds_launches, _ = training_path(
        ds_cfg, device, batch=DS_BATCH, seq=DS_SEQ, steps=DS_STEPS,
        dram_capacity=DS_DRAM,
        per_step={"flash_attention": DS_LAYERS,
                  "flash_attention_bwd": DS_LAYERS})
    host_memory("phase 3e", phase_end=True)

    # phase 3f: slice 6's path, h2o-danube-1.8b at full width, depth cut
    # to H2O_LAYERS, from a params-only checkpoint, prompts past its window
    full = get_config("h2o-danube-1.8b")
    h2o_cfg = dataclasses.replace(full,
                                  segments=((("attn_local",), H2O_LAYERS),))
    check(h2o_cfg.resolved_head_dim == H2O_HEAD_DIM
          and h2o_cfg.window_size == H2O_WINDOW
          and full.segments == ((("attn_local",), 24),)
          and (h2o_cfg.num_heads, h2o_cfg.num_kv_heads)
          == (H2O_HEADS, H2O_KV), "h2o-danube-1.8b shapes")
    print(f"[main] {h2o_cfg.name} full width (d_model "
          f"{h2o_cfg.d_model}, {h2o_cfg.num_heads} heads / "
          f"{h2o_cfg.num_kv_heads} kv, head_dim {h2o_cfg.resolved_head_dim}, "
          f"d_ff {h2o_cfg.d_ff}, window {h2o_cfg.window_size}, vocab "
          f"{h2o_cfg.vocab_size}, {h2o_cfg.param_dtype}), reduced: "
          f"num_layers {full.num_layers} -> {h2o_cfg.num_layers}; "
          f"{h2o_cfg.param_count()} params; prompt {H2O_PROMPT} past the "
          f"window", flush=True)
    h2o_t, h2o_launches, (h2o_model, h2o_params, h2o_prompts, h2o_quant) = \
        serving_restart(h2o_cfg, device, batch=H2O_BATCH, prompt=H2O_PROMPT,
                        gen_tokens=H2O_GEN, requests=H2O_REQUESTS,
                        dram_capacity=H2O_DRAM, train_state=False)
    h2o_want = {"flash_attention": _layers(h2o_cfg, "attn_local")
                * H2O_REQUESTS, "flash_attention_bwd": 0, "rg_lru": 0,
                "rg_lru_bwd": 0, "mlstm": 0, "quantize_blockwise": h2o_quant,
                "dequantize_blockwise": h2o_quant}
    print(f"[main] launches in save -> restore -> serve: {h2o_launches} "
          f"(expected {h2o_want})", flush=True)
    check(h2o_launches == h2o_want and h2o_launches["flash_attention"] > 0,
          f"launch counts {h2o_launches} != {h2o_want}")
    serving_numbers(h2o_cfg, h2o_t, h2o_model, h2o_params, h2o_prompts,
                    H2O_GEN)
    del h2o_model, h2o_params, h2o_prompts
    host_memory("phase 3f", phase_end=True)

    # phase 3g: slice 7's path, llama4-scout-17b-a16e at full width
    ll_launches = llama4_path(device)
    host_memory("phase 3g", phase_end=True)

    # phase 3h: slice 8's path, deepseek-v3-671b at full width
    ds3_launches, ds3_train_launches = deepseek_v3_path(device)
    host_memory("phase 3h", phase_end=True)

    # phase 3i: slices 9 and 11, whisper-large-v3 at full width
    wh_launches, wh_train_launches = whisper_path(device)
    host_memory("phase 3i", phase_end=True)

    host_step("the kernels line")
    rows = kernel_line(gen, {"starcoder2-3b": launches,
                             "recurrentgemma-9b": rg_launches,
                             "recurrentgemma-9b train": rg_train_launches,
                             "xlstm-350m": xl_launches,
                             "starcoder2-3b train": sc_launches,
                             "deepseek-coder-33b": ds_launches,
                             "h2o-danube-1.8b": h2o_launches,
                             "llama4-scout-17b-a16e": ll_launches,
                             "deepseek-v3-671b": ds3_launches,
                             "deepseek-v3-671b train": ds3_train_launches,
                             "whisper-large-v3": wh_launches,
                             "whisper-large-v3 train": wh_train_launches},
                       err, bwd_ran)
    host_memory("the kernels line", phase_end=True)
    print(f"[done] {elapsed_s():.1f}s (from the script's start, the "
          f"[host] lines' clock)", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
