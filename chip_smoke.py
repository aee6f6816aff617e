#!/usr/bin/env python3
"""Drive the PyTorch port of STREAM on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:
  1. build the Hopper kernels from src/repro_torch/kernels/csrc (nvcc,
     one process per source, all started together) and time the build;
     print ptxas's registers, shared memory and spills for awq_matmul.cu,
     rmsnorm.cu, flash_attention_bwd.cu and ssd.cu, and count awq_matmul's
     tensor-core (HMMA) instructions;
  2. kernels: hold each kernel against its plain PyTorch version at the
     main path's full-width shapes, in float32 and bfloat16 (quantized
     paged attention over int8 and fp8 pages, awq_matmul at the four
     W4A16 shapes of a decode step with groups 64 and 128, two calls
     bit-equal, and at prefill row counts up to 250; rmsnorm also at
     training's 2048 rows), and time
     kernel, plain version and a PyTorch library yardstick the port never
     calls (F.rms_norm, F.scaled_dot_product_attention, and for the
     W4A16 product torch's int4 tinygemm, _weight_int4pack_mm, on the
     same codes; torch.matmul against the dequantized bf16 weight is
     printed beside it as a dense reference), each launch with a cold L2,
     and, for rmsnorm (8 and 2048 rows), awq_matmul (the three decode
     shapes, with its launch plan), decode attention (both shapes) and ssd
     (zamba2's piece at 32 live steps and fully live, each beside its
     bound on the units the bf16 body uses and the float32 CUDA-core one),
     the device time (profiler) beside the yardstick's;
  3. reference: small float32 models served on the card (kernels) and on
     the CPU (plain versions) with the same weights give identical greedy
     streams, through generate() and through the paged batcher: dense with
     unquantized pages, and W4A16 (group 64) over int8 and fp8 pages;
  4. main path: build_system on the card with the HPC tier at the full
     width of minitron-8b (bf16, 32 layers, random weights from seed 0)
     and the reference's default local tier, xlstm-125m at its published
     width (bf16, 256-page stateful prefix pool), four concurrent
     encrypted stream-hpc requests, one stream-auto and one stream-local
     request (served by the xLSTM on the card) through the OpenAI
     gateway; every kernel's launch counter, zeroed just before, must
     grow; then a breakdown of the engine alone and of one B=8 decode
     step, and of the xLSTM's B=8 decode step and 16-token prefill piece;
  5. quantized main path: once the dense system is freed, the same with
     int8 KV pages and W4A16 weights (the paper's AWQ HPC tier); the
     counters of awq_matmul, quantized paged attention and rmsnorm,
     zeroed just before, must grow; then its breakdown;
  6. hybrid main path: once the quantized system is freed, the HPC tier
     at the full width of zamba2-7b (bf16, 81 Mamba-2 layers and a shared
     attention block, random weights from seed 0) served through the
     contiguous splice path with a 32-page stateful prefix pool; the
     counters of ssd, decode_attention and rmsnorm, zeroed just before,
     must grow; then its breakdown, and the three paths' figures side by
     side;
  7. the other dense configs, each once the previous system is freed, at
     their published widths from get_config (full_width), bf16, the same
     requests and breakdown: gemma-7b (28 layers, D = 256) and granite-20b
     (52 layers, 56.3 GB, G = 48) over bf16 pages, each with the prefill
     check and generate() at B = 1 (decode_attention at their heads), and
     deepseek-67b cut to 16 of its 95 layers over int8 pages with W4A16
     weights (95 bf16 layers cannot exist on the card before they are
     quantized); every path's peak stays under the card's 80 GB; these
     paths name their local tier, minitron-8b at smoke size, as before;
  7a. the MoE family, each once the previous system is freed, the same
     requests and breakdown: "mla", deepseek-v2-lite-16b at full width
     and depth (27 layers, bf16, 15.7 B params: MLA's latent pages, a
     dense first block, 64 routed experts top-6 and 2 shared), whose
     naive MLA decode launches decode_attention at D = 192 a layer a
     tick, with the prefill check (MoE: the per-layer attention outputs
     held, flash at D = 192 end to end) and generate() at B = 1;
     "mla-quantized", the same cut to 8 layers over int8 latent pages with
     W4A16 weights; "grok", grok-1-314b cut to 2 of 64 layers (bf16, 23
     GB: a full layer's 8 experts hold 4.83 B params), paged attention at
     G = 6;
  7e. the cross-attention families, each once the previous system is
     freed, at their published widths and depths (bf16), the same
     requests and breakdown, served through the contiguous splice path
     with a 32-page stateful pool (their cross K/V are state leaves):
     "whisper", whisper-medium (24 + 24 layers, 16/16 heads of 64,
     0.76 B params), and "vision", llama-3.2-vision-11b (40 layers and 8
     gated cross blocks, 32/8 heads of 128, 10.1 B params); the counters
     of decode_attention and flash_attention (and rmsnorm on the vision
     path), zeroed just before, must grow while serving; then the extras
     check (extras_check): the stub frames / patches (seeded, x 0.1; the
     vision gates set non-zero for it) through prefill and through
     prefill_chunk pieces, each with two decode steps, against forward's
     logits within PREFILL_E2E_REL of max |logit|, with prefill's flash
     launches counted;
  7b. speculative paths, each once the previous system is freed:
     build_system(speculative=True, spec_k=4), HPC tier full-width
     minitron-8b over bf16 pages, (a) beside the xLSTM local tier (the
     HPC batcher drafts by n-grams, the local one runs plain decode) and
     (b) beside a local minitron-8b at full width cut to 4 layers, which
     drafts for the HPC tier (model drafting); the same requests, the
     SpecStats, a forced-acceptance run on (a) (a draft_hook replays a
     plain greedy run of the same prompt: a tick must accept all k
     drafts; where the streams first differ is printed, not asserted)
     and a breakdown of one B=8, W=5 verify step; rmsnorm and paged
     attention (a) and decode attention (b, the drafter) must launch;
  7c. rolling windows, inside the dense and the quantized paths (before
     their breakdowns free the weights): a second ServingEngine on the
     HPC tier's params under WindowPolicy(sink 1, window 12, roll 4: a cap
     of 14 pages), 8 concurrent sessions of 300-token prompts (they roll
     while they prefill) and 1024 new tokens (512 quantized) through
     submit; every session must roll, the pool's high-water stay at or
     under 8 x cap_pages and the spans reach the summarizer; decode tok/s
     of the last quarter against the first; then a batcher driven tick by
     tick (a B=8 tick with a roll against one without, wall and device)
     and one _shift_pages call's device time and kernels beside its byte
     bound; rmsnorm and paged attention (the quantized body, and
     awq_matmul, on the quantized path), zeroed just before, must launch;
  7d. desktop fleet, once the speculative paths are freed:
     build_desktop_system(replicas=2) with the xlstm-125m local tier at
     its published width on two replicas sharing the card and the params
     (the HPC tier the smoke minitron): stream-local chats through the
     gateway (x-stream-replica, fleet meta, one SQLite row a request), a
     replica killed mid-stream, greedy and seeded (the failed-over stream
     must equal an unkilled run), and 16 concurrent sessions on two
     replicas against one; rmsnorm must launch;
  8. training path: once the last system is freed, minitron-8b and then
     gemma-7b at full width cut to 4 layers (float32 params, bf16 compute,
     remat) train 6 steps each of the synthetic stream (batch 2 x seq
     1024) through make_train_step with the driver's AdamW schedule at a
     peak lr of 2e-5, the last step under the profiler; losses finite and
     falling, the counters of flash_attention, its backward kernel and
     rmsnorm, zeroed just before, must grow; then, the same way, the other
     families (FAMILY_TRAINS): zamba2-7b at 12 of 81 layers (ssd, its
     gradient by plain recompute, whose device share of the step is
     measured), deepseek-v2-lite-16b at 4 of 27 (MLA's flash backward at
     D = 192), whisper-medium at full depth over 448 tokens and 1500 stub
     frames (the backward at D = 64), llama-3.2-vision-11b at 5 of 40 (one
     cross block, gate 0.5, over 1601 stub patches), each peak under the
     card's 80 GB;
  8a. distribution: make_local_mesh() gives a (1, 1) NCCL mesh;
     full-width minitron-8b cut to 4 layers is saved with
     CheckpointManager and brought onto the mesh by elastic_restore, then
     trains 2 steps there (DTensor params, axis_rules(DEFAULT_RULES),
     grad_shardings) beside the same 2 steps on plain tensors: losses,
     updated params and the flash / flash backward / rmsnorm launch
     counts must agree; deepseek-v2-lite-16b at full width cut to 2 layers
     runs its moe_dispatch="shard_map" forward on the mesh against the
     gspmd forward (routing equal, logits within the bf16 tolerance);
     analyze_step counts the minitron step's FLOPs on meta tensors,
     printed beside analytic_costs and the step's device time;
  9. the training driver (python -m repro_torch.launch.train --smoke
     --device cuda), for its default arch (xlstm-125m's smoke config) and
     for --arch minitron-8b side by side: 6 steps with a checkpoint every
     3, then again to 8, which must resume at step 6 with the data stream
     where it stopped.
The kernel phase also holds the new call sites' shapes (rmsnorm at 8 and
16 rows of xLSTM's 768 and the verify window's 40 rows of 4096,
awq_matmul at M = 40, decode attention at the drafter's B = 8) and times
them. The reference phase also serves the small float32 xLSTM on card
and CPU (generate and the splice batcher with a prefix hit), and runs
speculative decoding of the small float32 minitron on the card (n-gram,
model drafter, 100% / 0% / mid-window draft_hook replays; paged over
float32 pages and over int8 pages with W4A16, and contiguous): every
stream equals the CPU's plain greedy stream; and rolling windows of the
small float32 minitron (float32 pages, int8 pages with W4A16): greedy
and seeded streams, roll counts, high-water and summarizer spans equal
on card and CPU, and n-gram speculation under the window equals plain.
The kernel phase also holds flash_attention against its plain version at
the training shape (2, 32/8, 1023, 128), the prefill shape, an offset
(Skv > Sq), a non-causal, a soft-cap, a D = 112 and a causal Skv < Sq
case, in both types, and at each its gradient (the backward kernel)
against plain autograd and against plain_bwd, two backward calls
bit-equal; it times the forward (bf16: the wgmma body, with its achieved
TFLOP/s; float32: the CUDA-core body) beside SDPA and the backward beside
the plain recompute and SDPA's backward, with its share of the bound,
and its device time (seven products) beside SDPA's backward.
Paged attention is also held at every head group the kernel takes (G 6,
8 and 48, the smoke 4/2, D = 112) over pages in q's type and int8 / fp8
codes, with a parked slot, and timed with its split plan; the kernels'
device times (profiler) are printed beside SDPA's. The reference phase
also trains a small float32 minitron 3 steps on card and CPU (losses and
params must agree). The dense path,
before it is freed, holds the whole-prompt prefill (flash_attention)
against the chunked one over a 250-token prompt.
Every breakdown profiles one B=8 decode step and one 16-token prefill
piece of the model alone. The kernel phase also holds ssd (the Mamba-2
chunked scan) against its plain version at the smoke chunk (16, float32,
with and without h0) and at zamba2-7b's prefill piece (T = 256 with 32
live steps and fully live, and T = 512, bf16, with h0), decode attention at zamba2's
shared block (B = 8, 32/32 heads of D = 112; timed, like B = 1, with its
split count beside SDPA) and rmsnorm at width 3584;
the reference phase also serves a small float32 zamba2 on card and CPU.
The kernel phase also holds the other dense configs' shapes against the
plain versions and times them (new_configs_phase): decode attention at
granite's G = 48 and gemma's D = 256 (B = 1 and 8), deepseek's 64/8 and
its smoke's D = 8; paged attention at 16/16 of 256, 16/2 of 256 and 8/2
of 8 over pages in q's type and int8/fp8 codes; flash_attention at gemma's
training and prefill shapes (forward and backward), D = 256 with an
offset, a cap and Skv < Sq, D = 8, and granite's prefill (G = 48, the
forward); rmsnorm at rows of 3072 (gemma style), 6144 and 8192;
awq_matmul at deepseek's three W4A16 shapes. The reference phase also
serves the smoke gemma, granite and deepseek (D = 8; and over int8 pages
with W4A16) on card and CPU, and the MoE family's smokes (deepseek-v2-lite
over float32 and int8 latent pages, grok-1). mla_shapes_phase holds and
times the MoE family's kernel shapes: decode attention and the flash
forward at MLA's D = 192 and the smoke's 24, rmsnorm at 2048,
awq_matmul at deepseek-v2-lite's W4A16 shapes (the dense block's w2 at K
= 10944, 171 groups of 64).
crossattn_shapes_phase holds and times the cross-attention families'
shapes: the flash forward at whisper's D = 64 (the encoder (1, 16/16,
1500) non-causal, the cross attention of a B = 8 decode step and of a
16-token piece over 1500 encoder positions, a causal 250-token prefill)
and at the vision cross shape (B = 8,
32/8, one query over 1601 image tokens, D = 128), decode attention at
whisper's (B = 8, 16/16 of 64, S = 256 ragged). The reference phase also
serves the whisper and vision smokes (float32, D = 16) on card and CPU
(crossattn_reference_phase: generate, generate_batch, the splice batcher
with a seeded stream and a prefix hit, then the model alone with its
stub input on the first prefill piece and four decode steps).
In the kernels JSON, ``launches`` is a kernel's count summed over the
eleven serving paths, the two speculative paths, the two rolling paths, the
desktop fleet, the six training paths and the distributed phase's mesh
runs (each zeroed just before its path and read just after); ``shapes`` lists
the other timed shapes.
The flash checks above also run at the training paths' shapes
(FLASH_BWD_NEW, appended to FLASH_SHAPES: whisper's encoder, cross and
decoder at D = 64, MLA's D = 192 and its smoke's 24, the vision cross
1023 over 1601 at D = 128, zamba2's shared block at D = 112) and at a
16-token whisper cross piece; training_shapes_phase times the backward
there beside SDPA's backward. ssd is also held at zamba2-7b's training
shape (b = 2, T = 1024, 1023 live steps, bf16), and its gradient (autograd
of the plain version, recomputed) is timed there beside its bound. The
reference phase also trains the other families' smokes (FAMILY_SMOKES:
zamba2, deepseek-v2-lite, grok-1, whisper with stub frames, llama-vision
with stub patches and gates 0.5) 3 float32 steps on card and CPU: losses
and params must agree, and their kernels launch.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Exits nonzero with no result line when
no CUDA device is present or the port's sources are missing.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": (5e-5, 1e-5), "bfloat16": (1e-2, 1.6e-2)}   # (atol, rtol)
FULL = dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
            d_ff=16384, vocab_size=256000, param_dtype="bfloat16",
            compute_dtype="bfloat16")
# zamba2-7b at its published widths (src/repro_torch/configs/zamba2_7b.py)
ZAMBA_FULL = dict(n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
                  d_ff=14336, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
                  ssm_expand=2, ssm_chunk=256, attn_every=6,
                  param_dtype="bfloat16", compute_dtype="bfloat16")
ZAMBA_POOL_PAGES = 32      # ~152 MB of state snapshot per page at full width
# deepseek-67b's 95 bf16 layers (134 GB) cannot exist on one card before
# build_system(quantize_mlp=True) quantizes them: its path keeps 16
DEEPSEEK_LAYERS = 16
# the MoE family: deepseek-v2-lite-16b (15.7 B params, 31.4 GB in bf16) runs
# at full depth; its quantized path keeps 8 of its 27 layers; grok-1-314b's
# 64 layers hold 4.83 B params of experts each (316 B in all), so its path
# keeps 2 (11.5 B params, 23 GB)
MLA_Q_LAYERS = 8
GROK_LAYERS = 2
# the cross-attention families at full width and depth take the splice path
# with a stateful pool: a whisper-medium page snapshots both cross leaves
# (24 x 16 x 1500 x 64 x 2 B x 2, ~147 MB), a llama-3.2-vision-11b page
# 8 x 8 x 1601 x 128 x 2 B x 2 (~52 MB)
CROSS_POOL_PAGES = 32
STUB_SCALE = 0.1     # stub frames / patches: randn x 0.1, as the reference's smoke tests
VISION_GATE = 0.5    # the cross gates in the extras checks (tanh(0) = 0 hides the cross path)
CARD_BYTES = 80e9          # the H100's device memory: a path's peak stays under it
B, HQ, HKV, D, PAGE, MAX_SEQ = 8, 32, 8, 128, 16, 256
SPEC_K = 4                 # the speculative paths' drafts a tick: windows of W = 5
N_TIMED = 100
# W4A16 shapes of one decode step's layer (M = B rows): w1 and w3, w2, wo
AWQ_SHAPES = {"w1/w3": (B, 4096, 16384), "w2": (B, 16384, 4096), "wo": (B, 4096, 4096)}
# deepseek-67b's (d_model 8192, d_ff 22016): its quantized path's shapes
AWQ_DEEPSEEK = {"w1/w3": (B, 8192, 22016), "w2": (B, 22016, 8192), "wo": (B, 8192, 8192)}
# a PyTorch yardstick may take its inputs in lower precision (bf16 scales
# for the int4 product): it is held to the plain version within this share
# of the largest |output|, enough to show it computes the same function
YARDSTICK_REL = 2e-2
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:26"),
    "paged_attention": ("src/repro_torch/kernels/csrc/attention.cu",
                        "src/repro/kernels/paged_attention.py:91"),
    "paged_attention_quant": ("src/repro_torch/kernels/csrc/attention_quant.cu",
                              "src/repro/kernels/paged_attention.py:85"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:65"),
    "awq_matmul": ("src/repro_torch/kernels/csrc/awq_matmul.cu",
                   "src/repro/kernels/awq_matmul.py:52"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssm_scan.py:72"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/ref.py:33 (XLA autodiff of mha)"),
}
# paged attention beyond the main path's heads: (Hq, Hkv, D), pages in q's
# type and int8 / fp8 codes, over a table with a parked slot: grok's G 6,
# granite-20b's G 48, deepseek-67b's G 8, the smoke, zamba2's D 112,
# gemma-7b's D 256 (and at G 8), deepseek-67b's smoke D 8
PAGED_HEADS = ((48, 8, 128), (48, 1, 128), (64, 8, 128), (4, 2, 16), (32, 32, 112),
               (16, 16, 256), (16, 2, 256), (8, 2, 8))
SSD_REL = 1e-5     # ssd's float32 outputs: max abs err <= SSD_REL * max(1, max |plain|)
# flash_attention at (B, Hq, Hkv, Sq, Skv, D, causal, cap): the training
# shape first (minitron-8b heads, T = seq - 1 = 1023), whole-prompt
# prefill, the offset diagonal (Skv > Sq), non-causal, soft cap, zamba2's
# D = 112, the smoke config's training shape and a causal Skv < Sq (rows
# that see no key: the mean of V); then gemma-7b's training and prefill
# shapes (D = 256), D = 256 with an offset and a cap and with Skv < Sq,
# deepseek-67b's smoke D = 8
FLASH_SHAPES = ((2, 32, 8, 1023, 1023, 128, True, 0.0), (1, 32, 8, 250, 250, 128, True, 0.0),
                (1, 32, 8, 100, 250, 128, True, 0.0), (2, 32, 8, 130, 200, 128, False, 0.0),
                (1, 32, 8, 300, 300, 128, True, 30.0), (1, 32, 32, 250, 250, 112, True, 0.0),
                (2, 4, 2, 63, 63, 16, True, 0.0), (1, 32, 8, 300, 200, 128, True, 0.0),
                (2, 16, 16, 1023, 1023, 256, True, 0.0), (1, 16, 16, 250, 250, 256, True, 0.0),
                (1, 4, 2, 100, 250, 256, True, 30.0), (1, 4, 2, 200, 130, 256, True, 0.0),
                (2, 8, 2, 63, 63, 8, True, 0.0))
# the flash backward at the training paths' shapes: (what, (B, Hq, Hkv,
# Sq, Skv, D, causal)); T = 447 is whisper's 448-token text context less
# one, 1023 the other paths' 1024 less one; 1500 and 1601 keys leave a
# partial last key tile. flash_phase holds them (appended to
# FLASH_SHAPES, with a 16-token whisper cross piece: one partial query
# tile); training_shapes_phase times them
FLASH_BWD_NEW = (
    ("whisper encoder", (2, 16, 16, 1500, 1500, 64, False)),
    ("whisper cross", (2, 16, 16, 447, 1500, 64, False)),
    ("whisper decoder", (2, 16, 16, 447, 447, 64, True)),
    ("deepseek-v2-lite MLA", (2, 16, 16, 1023, 1023, 192, True)),
    ("deepseek-v2-lite smoke MLA", (2, 4, 4, 63, 63, 24, True)),
    ("vision cross", (2, 32, 8, 1023, 1601, 128, False)),
    ("zamba2 shared block", (2, 32, 32, 1023, 1023, 112, True)))
FLASH_SHAPES += tuple(s + (0.0,) for _, s in FLASH_BWD_NEW) + (
    (1, 16, 16, 16, 1500, 64, False, 0.0),)
# granite-20b's whole-prompt prefill (G = 48), forward only: no path trains it
GRANITE_PREFILL = (1, 48, 1, 250, 250, 128, True, 0.0)
# training: full-width minitron-8b cut to 4 of its 32 layers (float32
# params, bf16 compute), batch 2 x seq 1024, the driver's AdamW schedule
# (warmup 5, decay over 10) at a peak lr for this width: at the driver's
# 1e-3 (set for the smoke widths) Adam's sign-like first steps move every
# 4096-wide matrix's output by O(1) and the loss climbs (13.15 -> 16.19
# over 6 steps on the card), so the peak is 2e-5
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 1024, 6
# the distributed phase's steps, on the (1, 1) mesh and on plain tensors
DIST_STEPS = 2
# the dry-run phase: one cell a family on the fake 16 x 16 world (the first
# on the 2 x 16 x 16 world too), each `python -m repro_torch.launch.dryrun`
# a process of its own, and `launch.perf`'s three cells beside them, all
# started together on the host's cores and ended by DRYRUN_WALL_S
DRYRUN_CELLS = (("minitron-8b", "train_4k", "both"),
                ("deepseek-v2-lite-16b", "decode_32k", "single"),
                ("grok-1-314b", "prefill_32k", "single"),
                ("zamba2-7b", "long_500k", "single"),
                ("whisper-medium", "decode_32k", "single"),
                ("llama-3.2-vision-11b", "prefill_32k", "single"),
                ("xlstm-125m", "train_4k", "single"))
DRYRUN_WALL_S = 300
# the anchor's temp memory: the card's measured peak less the arguments,
# over the dry-run's MemTracker peak of the same step walked on meta
# tensors, must lie in this band (the plain attention the meta walk takes
# holds its S x S scores, which the flash kernels never do, so the walk's
# peak is the larger)
ANCHOR_TEMP_BAND = (0.25, 1.0)
TRAIN_OC = dict(lr=2e-5, warmup_steps=5, decay_steps=10)
# card-vs-CPU training of the small float32 model: losses within
# TRAIN_LOSS_ATOL; each param within TRAIN_PARAM_ATOL + steps * lr *
# min(2, TRAIN_G_TOL / (sqrt(vh) + eps)), vh the CPU run's bias-corrected
# second moment: Adam turns a gradient error dg into a step error of
# about lr * dg / (sqrt(vh) + eps) (tests/test_torch_training.py)
TRAIN_LOSS_ATOL, TRAIN_PARAM_ATOL, TRAIN_G_TOL = 1e-4, 1e-5, 1e-6
# the other families at full width, each TRAIN_STEPS steps of batch
# TRAIN_BATCH: (arch, layers, seq, kernels that must launch): zamba2-7b at
# 12 of 81 layers (two calls of the shared block, D 112), deepseek-v2-lite
# at 4 of 27 (one dense block, three MoE; MLA's flash backward at D 192),
# whisper-medium at full depth over its 448-token text context and 1500
# stub frames (the backward at D 64: encoder, cross, decoder), and
# llama-3.2-vision at 5 of 40 (one cross block over 1601 stub patches: the
# non-causal Sq != Skv backward at D 128)
FAMILY_TRAINS = (
    ("zamba2-7b", 12, TRAIN_SEQ, ("ssd", "flash_attention", "flash_attention_bwd", "rmsnorm")),
    ("deepseek-v2-lite-16b", 4, TRAIN_SEQ, ("flash_attention", "flash_attention_bwd",
                                            "rmsnorm")),
    ("whisper-medium", 24, 448, ("flash_attention", "flash_attention_bwd")),
    ("llama-3.2-vision-11b", 5, TRAIN_SEQ, ("flash_attention", "flash_attention_bwd",
                                            "rmsnorm")))
# the other families' smokes trained card vs CPU, and the kernels each
# must launch on the card: zamba2's ssd (its gradient by plain recompute)
# and the shared block's flash at D 16; MLA's flash backward at D 24; the
# encoder-decoder's and the vision cross's non-causal backward
FAMILY_SMOKES = (
    ("zamba2-7b", ("ssd", "flash_attention", "flash_attention_bwd", "rmsnorm")),
    ("deepseek-v2-lite-16b", ("flash_attention", "flash_attention_bwd", "rmsnorm")),
    ("grok-1-314b", ("flash_attention", "flash_attention_bwd", "rmsnorm")),
    ("whisper-medium", ("flash_attention", "flash_attention_bwd")),
    ("llama-3.2-vision-11b", ("flash_attention", "flash_attention_bwd", "rmsnorm")))
PREFILL_E2E_REL = 0.05     # end-to-end prefill vs chunked: share of max |logit|
# rolling windows on the full-width HPC tier: 1 sink + 12 rolling pages + 1
# spare = a cap of 14 pages (224 tokens) a slot, 4 pages (64 tokens) a roll;
# 8 concurrent sessions of ~300-token prompts (they roll while they
# prefill) and 1024 new tokens each, about 6 windows; the quantized path
# takes half the tokens
WINDOW = dict(sink_pages=1, window_pages=12, roll_pages=4)
ROLL_SESSIONS, ROLL_PROMPT, ROLL_NEW = 8, 300, 1024
ROLL_TICKS = 140           # the per-tick measurement's tokens a session: 2 roll ticks
# the desktop fleet: two replicas of the local tier on the one card, 16
# concurrent sessions against one replica's share
FLEET_SESSIONS, FLEET_TOKENS = 16, 64


def log(*a):
    print(*a, flush=True)


def since(t0, what):
    """Log the seconds since the kernel build began, at the end of a phase."""
    log(f"elapsed {time.perf_counter() - t0:.1f} s: {what} done")


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch, as the serving path finds KV and activations cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, n=N_TIMED):
        torch = self.torch
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for a, b in ev:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / n


def check_close(name, got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not bool(got.isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name} [{dtype}]: max_abs_err {err.max().item():.3e} "
                             f"beyond atol {atol} + rtol {rtol}")
    return err.max().item()


def int4pack_mm(torch, x, qw, sc, zr, gs):
    """PyTorch's own grouped int4 product (tinygemm) on the same codes,
    as a closure over its packed inputs (the conversion is not timed).
    Its dequantization is (q - 8) * s + zero with bf16 scales and zeros,
    so AWQ's (q - z) * s has zero = (8 - z) * s."""
    from repro_torch.kernels import ref
    q = ref.awq_unpack(qw).t().contiguous()                  # (N, K) codes
    wp = torch.ops.aten._convert_weight_to_int4pack(
        (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack((sc, (8 - zr) * sc), -1).to(torch.bfloat16).contiguous()
    return lambda: torch.ops.aten._weight_int4pack_mm(x, wp, gs, sz)


def check_ssd(name, got, want):
    """ssd's bf16 y is held like any bf16 output; its float32 outputs (y
    in float32, the state always) to SSD_REL of the largest |plain|: sums
    over up to 256 steps run in another order than the plain version's,
    so an element near zero carries the rounding of larger terms."""
    if str(got.dtype) == "torch.bfloat16":
        return check_close(name, got, want, "bfloat16")
    err = (got.float() - want.float()).abs().max().item()
    lim = SSD_REL * max(1.0, want.float().abs().max().item())
    if not bool(got.isfinite().all()) or not err <= lim:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} beyond {lim:.3e}")
    return err


def device_ms(torch, fn, n=20):
    """Device time a call of ``fn`` takes, by kernel (profiler, n calls
    after one warm-up), as text: host time and the L2 state of the
    per-call timer do not enter it. Where the tracer drops all three
    windows, CUDA events around n back-to-back calls, labelled so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # the tracer now and then drops a window's kernels: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.key_averages()
                      if getattr(e, "self_device_time_total", 0) > 0),
                     key=lambda e: -e.self_device_time_total)
        if sum(e.count for e in evs) >= n:      # every call launches a kernel at least
            break
    if not evs:     # the tracer dropped every window: CUDA events over n calls
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return f"{a.elapsed_time(b) / n:.4f} ms (CUDA events, the profiler saw no kernel)"
    total = sum(e.self_device_time_total for e in evs) / n / 1e3
    names = [re.search(r"[A-Za-z]\w*kernel\w*", e.key) for e in evs[:4]]
    return f"{total:.4f} ms (" + "; ".join(
        f"{m.group(0) if m else e.key[:40]} {e.self_device_time_total / n / 1e3:.4f}"
        for m, e in zip(names, evs)) + ")"


def ptxas_lines(log_text):
    """One line a kernel from nvcc's -Xptxas -v report: its name, registers,
    shared memory and spills."""
    out, name, spill = [], "?", ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers{m.group(2)}; {spill}")
    return out


def sass_count(lib, opcode):
    """How many instructions of ``opcode`` cuobjdump finds in a built library."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([str(tool if tool.exists() else "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for line in sass.splitlines() if re.search(rf"\b{opcode}\b", line))


def rounding_model(torch, q, k, v, go):
    """The flash backward's rounding choice at the training shape, as
    text: the three gradient products in float32 math on the same bf16
    inputs, over P or dS rounded once to bf16 and over bf16 hi/lo halves,
    each gradient's largest error against the float32 one as a share of
    the bf16 tolerance (above 1: past it)."""
    atol, rtol = TOL["bfloat16"]
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    bf = lambda t: t.to(torch.bfloat16).float()
    hilo = lambda t: bf(t) + bf(t - bf(t))
    qf, df = q.float(), go.float()
    kf, vf = (t.float().repeat_interleave(g, dim=1) for t in (k, v))
    x = (qf @ kf.transpose(-1, -2)) * scale
    mask = torch.ones(sq, sq, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(x.masked_fill(~mask, -math.inf), dim=-1)
    dp = df @ vf.transpose(-1, -2)
    ds = (p * (dp - (df * (p @ vf)).sum(-1, keepdim=True))).masked_fill(~mask, 0.0)
    heads = lambda t: t.reshape(b, hq // g, g, *t.shape[2:]).sum(2)
    def share(got, want):
        got, want = bf(got), bf(want)
        return ((got - want).abs() / (atol + rtol * want.abs())).max().item()
    out = []
    for name, f, gm in (("dV over P", p, lambda m: heads(m.transpose(-1, -2) @ df)),
                        ("dK over dS", ds, lambda m: heads(m.transpose(-1, -2) @ qf) * scale),
                        ("dQ over dS", ds, lambda m: (m @ kf) * scale)):
        want = gm(f)
        out.append(f"{name} once {share(gm(bf(f)), want):.3f}, hi/lo {share(gm(hilo(f)), want):.3f}")
    return ("flash_attention_bwd rounding model (float32 math of the gradient products at "
            f"{(b, hq, k.shape[1], sq, sq, d)}, share of the bf16 tolerance): " + "; ".join(out))


def ssd_tensor_flops(dt, P, N, L):
    """The tensor-core operations ssd's bf16 body does on these inputs
    (csrc/ssd.cu): per (batch, sub-chunk) the C.B pass's lower-triangle
    16 x 8 tiles; per (batch, head, sub-chunk) C h^T over h's two bf16
    pieces, and where any dt != 0 (a sub-chunk of dt = 0 is skipped) S_j
    over x o w's three pieces and M x over M's two, up to the diagonal."""
    from repro_torch.kernels import ssm_scan as ssd_k
    b, T, H = dt.shape
    Q = ssd_k.sub_chunk(L)
    ns = T // Q
    live = int((dt.reshape(b, ns, Q, H) != 0).any(dim=2).sum())
    mt = Q // 16
    cb_tiles = sum(1 for m in range(mt) for n in range(Q // 8) if n * 8 <= m * 16 + 15)
    return (b * ns * cb_tiles * 2 * 16 * 8 * N + b * ns * H * 2 * 2 * Q * N * P
            + live * (3 * 2 * P * N * Q + 2 * mt * (mt + 1) // 2 * 2 * 16 * 16 * P))


def ssd_grad_bound(torch, timer, randn, x, dt, A, Bm, Cm, Dv, L):
    """ssd's gradient at these inputs (no h0, as training calls it): its
    bound -- bytes: x, dt, A, B, C, D and the output's gradient read once,
    the six input gradients written once; operations: two products (one a
    operand) for each tensor-core product of the forward, ssd_tensor_flops
    -- and the measured time of _SSD's backward alone (the plain version
    recomputed and differentiated). Returns (bound ms, bound by, ms)."""
    from repro_torch.kernels import ssm_scan as ssd_k
    ins = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, Dv)]
    y, _ = ssd_k.ssd(*ins, chunk=L)
    gy = randn(*y.shape, dtype=y.dtype)
    b, T, H, P = x.shape
    N = Bm.shape[-1]
    elt = x.element_size()
    nbytes = (3 * x.numel() * elt + 2 * dt.numel() * 4 + 4 * Bm.numel() * elt
              + 4 * A.numel() * 4)
    bms, by = bound_ms(nbytes, 2 * ssd_tensor_flops(dt, P, N, L), "bfloat16")
    ms = timer.ms(lambda: torch.autograd.grad(y, ins, gy, retain_graph=True), n=10)
    del y, ins
    return bms, by, ms


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- kernels
def kernel_phase(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import awq_matmul as awq_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import paged_attention as pa_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssm_scan as ssd_k

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    # ---- rmsnorm: the decode tick's (B, 1, 4096) rows
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = randn(B, 1, 4096, dtype=dt)
        for gemma in (False, True):
            w = (0.1 * randn(4096, dtype=dt)) if gemma else (1 + 0.1 * randn(4096, dtype=dt))
            err = check_close(f"rmsnorm gemma={gemma}",
                              rms_k.rmsnorm(x, w, eps=1e-5, gemma_style=gemma),
                              rms_k.plain(x, w, eps=1e-5, gemma_style=gemma), dname)
            rows.setdefault(("rmsnorm", dname), []).append(err)
        if dname == "bfloat16":
            w = 1 + 0.1 * randn(4096, dtype=dt)
            t_k = timer.ms(lambda: rms_k.rmsnorm(x, w, eps=1e-5))
            t_p = timer.ms(lambda: rms_k.plain(x, w, eps=1e-5))
            t_l = timer.ms(lambda: F.rms_norm(x, (4096,), w, eps=1e-5))
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            bms, by = bound_ms(nbytes, 4 * x.numel(), dname)
            rows["rmsnorm"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                   bound_ms=bms, bound_by=by)
            log(f"time rmsnorm 8x4096 bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  library "
                f"(F.rms_norm) {t_l:.4f} ms  bound {bms:.6f} ms ({by}); device time: kernel "
                + device_ms(torch, lambda: rms_k.rmsnorm(x, w, eps=1e-5)) + ", F.rms_norm "
                + device_ms(torch, lambda: F.rms_norm(x, (4096,), w, eps=1e-5)))
    # training's rows: 2048 x 4096 (batch 2 x seq 1024), where bytes bound it
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x, w = randn(TRAIN_BATCH * TRAIN_SEQ, 4096, dtype=dt), 1 + 0.1 * randn(4096, dtype=dt)
        rows[("rmsnorm", dname)].append(check_close(
            "rmsnorm 2048x4096", rms_k.rmsnorm(x, w), rms_k.plain(x, w), dname))
        if dname != "bfloat16":
            continue
        t_k, t_l = timer.ms(lambda: rms_k.rmsnorm(x, w)), timer.ms(
            lambda: F.rms_norm(x, (4096,), w, eps=1e-5))
        bms, by = bound_ms(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), dname)
        log(f"time rmsnorm 2048x4096 bf16: kernel {t_k:.4f} ms  library (F.rms_norm) "
            f"{t_l:.4f} ms  bound {bms:.6f} ms ({by}); device time: kernel "
            + device_ms(torch, lambda: rms_k.rmsnorm(x, w)) + ", F.rms_norm "
            + device_ms(torch, lambda: F.rms_norm(x, (4096,), w, eps=1e-5)))

    # ---- paged attention: ragged lengths, rolled-out offsets, shared
    # pages, garbage in the trash page and in dead pages
    n_pages, P = MAX_SEQ // PAGE, 257
    kv_len = torch.tensor([1, 17, 40, 64, 100, 150, 200, 256], dtype=torch.int32,
                          device="cuda")
    poff = torch.tensor([0, 0, 16, 0, 32, 0, 48, 0], dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:B * n_pages] + 1
    bt = perm.reshape(B, n_pages).to(torch.int32)
    bt[3, :2] = bt[2, :2]                         # slots 2 and 3 share a prefix
    live = ((kv_len - poff + PAGE - 1) // PAGE).tolist()
    for b in range(B):
        bt[b, live[b]:] = 0                       # padding -> trash page
    bt = bt.contiguous()
    n_live = (kv_len - poff).tolist()
    n_live_keys = sum(n_live)                     # per-slot work: shared pages count twice
    bt_host = bt.tolist()
    # bytes: a position two slots share is read from memory once
    n_distinct_keys = len({(bt_host[b][j // PAGE], j % PAGE)
                           for b in range(B) for j in range(n_live[b])})
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q = randn(B, HQ, 1, D, dtype=dt)
        kp = randn(P, HKV, PAGE, D, dtype=dt)
        vp = randn(P, HKV, PAGE, D, dtype=dt)
        kp[0], vp[0] = 1e4, -1e4                  # trash page garbage
        for cap in (0.0, 30.0):
            err = check_close(
                f"paged_attention cap={cap}",
                pa_k.paged_attention(q, kp, vp, block_tables=bt, kv_len=kv_len,
                                     pos_offset=poff, logit_soft_cap=cap),
                pa_k.plain(q, kp, vp, block_tables=bt, kv_len=kv_len,
                           pos_offset=poff, logit_soft_cap=cap), dname)
            rows.setdefault(("paged_attention", dname), []).append(err)
        if dname == "bfloat16":
            t_k = timer.ms(lambda: pa_k.paged_attention(
                q, kp, vp, block_tables=bt, kv_len=kv_len, pos_offset=poff))
            t_p = timer.ms(lambda: pa_k.plain(
                q, kp, vp, block_tables=bt, kv_len=kv_len, pos_offset=poff))
            gk = ref.gather_kv_pages(kp, bt).repeat_interleave(HQ // HKV, dim=1)
            gv = ref.gather_kv_pages(vp, bt).repeat_interleave(HQ // HKV, dim=1)
            mask = (torch.arange(n_pages * PAGE, device="cuda")[None, :]
                    < (kv_len - poff)[:, None])[:, None, None, :]
            t_l = timer.ms(lambda: F.scaled_dot_product_attention(
                q, gk, gv, attn_mask=mask))
            elt = q.element_size()
            nbytes = (2 * q.numel() * elt + 2 * n_distinct_keys * HKV * D * elt
                      + 4 * (sum(live) + 2 * B))
            bms, by = bound_ms(nbytes, 4 * D * HQ * n_live_keys, dname)
            rows["paged_attention"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                           bound_ms=bms, bound_by=by)
            log(f"time paged_attention B={B} {HQ}/{HKV} D={D} bf16 pages: kernel {t_k:.4f} ms"
                f"  plain {t_p:.4f} ms  library (SDPA) {t_l:.4f} ms  bound {bms:.6f} ms "
                f"({by}); {paged_plan(torch, B, HQ, HKV, n_pages, False)}")
            log("device time paged_attention B=8 bf16 pages: kernel " + device_ms(
                torch, lambda: pa_k.paged_attention(q, kp, vp, block_tables=bt, kv_len=kv_len,
                                                    pos_offset=poff))
                + ", SDPA " + device_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, gk, gv, attn_mask=mask)))

    # ---- quantized paged attention: int8 / fp8 pages, the same tables;
    # saturated codes in the trash page, and scales of 1e6 in the trash
    # page and in every page no slot reads live
    live_pages = {bt_host[b][j] for b in range(B) for j in range(live[b])}
    dead = torch.tensor(sorted(set(range(P)) - live_pages), device="cuda")
    n_distinct_pos = len({(bt_host[b][j // PAGE], j % PAGE)
                          for b in range(B) for j in range(n_live[b])})
    for kv in ("int8", "float8_e4m3fn"):
        kdt = getattr(torch, kv)
        kq, ks = ref.quantize_kv(randn(P, HKV, PAGE, D, dtype=torch.float32), kdt)
        vq, vs = ref.quantize_kv(randn(P, HKV, PAGE, D, dtype=torch.float32), kdt)
        top = 127 if kv == "int8" else 448
        kq[0] = torch.tensor(float(top), device="cuda").to(kdt)    # saturated codes
        vq[0] = torch.tensor(float(-top), device="cuda").to(kdt)
        for sc in (ks, vs):
            sc[dead] = 1e6
        qkw = dict(block_tables=bt, kv_len=kv_len, pos_offset=poff,
                   k_scales=ks, v_scales=vs)
        for dname in ("float32", "bfloat16"):
            q = randn(B, HQ, 1, D, dtype=getattr(torch, dname))
            for cap in (0.0, 30.0):
                err = check_close(
                    f"paged_attention_quant {kv} cap={cap}",
                    pa_k.paged_attention(q, kq, vq, logit_soft_cap=cap, **qkw),
                    pa_k.plain(q, kq, vq, logit_soft_cap=cap, **qkw), dname)
                rows.setdefault(("paged_attention_quant", dname), []).append(err)
            if dname == "bfloat16" and kv == "int8":     # the main path's pool
                t_k = timer.ms(lambda: pa_k.paged_attention(q, kq, vq, **qkw))
                t_p = timer.ms(lambda: pa_k.plain(q, kq, vq, **qkw))
                gk = ref.gather_dequant_kv_pages(kq, ks, bt).to(q.dtype).repeat_interleave(
                    HQ // HKV, dim=1)
                gv = ref.gather_dequant_kv_pages(vq, vs, bt).to(q.dtype).repeat_interleave(
                    HQ // HKV, dim=1)
                mask = (torch.arange(n_pages * PAGE, device="cuda")[None, :]
                        < (kv_len - poff)[:, None])[:, None, None, :]
                t_l = timer.ms(lambda: F.scaled_dot_product_attention(
                    q, gk, gv, attn_mask=mask))
                elt = q.element_size()
                # codes (1 byte) and their f32 scale, each distinct position once
                nbytes = (2 * q.numel() * elt + 2 * n_distinct_pos * HKV * (D + 4)
                          + 4 * (sum(live) + 2 * B))
                bms, by = bound_ms(nbytes, 4 * D * HQ * n_live_keys, dname)
                rows["paged_attention_quant"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                                     bound_ms=bms, bound_by=by)
                log(f"time paged_attention_quant B={B} {HQ}/{HKV} D={D} int8 pages, bf16 q: "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  library (SDPA) {t_l:.4f} ms  "
                    f"bound {bms:.6f} ms ({by}); "
                    f"{paged_plan(torch, B, HQ, HKV, n_pages, True)}")
                log("device time paged_attention_quant B=8 int8 pages: kernel " + device_ms(
                    torch, lambda: pa_k.paged_attention(q, kq, vq, **qkw))
                    + ", SDPA " + device_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, gk, gv, attn_mask=mask)))

    paged_heads_phase(torch, timer, rows, randn, g)

    # ---- awq_matmul: a decode step's four W4A16 shapes per layer
    for (wname, (M, K, N)) in AWQ_SHAPES.items():
        for gs in (64, 128):
            qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
            sc = 0.002 * torch.rand((K // gs, N), generator=g, device="cuda")
            zr = torch.randint(0, 16, (K // gs, N), generator=g, device="cuda").float()
            for dname in ("float32", "bfloat16"):
                x = randn(M, K, dtype=getattr(torch, dname))
                want = awq_k.plain(x, qw, sc, zr, group_size=gs)
                got = awq_k.awq_matmul(x, qw, sc, zr, group_size=gs)
                err = check_close(f"awq_matmul {wname} ({M}, {K}, {N}) group {gs}",
                                  got, want, dname)
                rows.setdefault(("awq_matmul", dname), []).append(err)
                if not torch.equal(got, awq_k.awq_matmul(x, qw, sc, zr, group_size=gs)):
                    raise AssertionError(f"awq_matmul {wname} group {gs} [{dname}]: two "
                                         "calls differ")
                if dname != "bfloat16" or gs != 64:       # the main path's: bf16, group 64
                    continue
                t_k = timer.ms(lambda: awq_k.awq_matmul(x, qw, sc, zr, group_size=gs))
                t_p = timer.ms(lambda: awq_k.plain(x, qw, sc, zr, group_size=gs), n=20)
                grp = torch.arange(K, device="cuda") // gs
                wd = ((ref.awq_unpack(qw).float() - zr[grp]) * sc[grp]).to(x.dtype)
                t_d = timer.ms(lambda: torch.matmul(x, wd))
                del wd
                lib = int4pack_mm(torch, x, qw, sc, zr, gs)
                lib_err = (lib().float() - want.float()).abs().max().item()
                if not lib_err <= YARDSTICK_REL * want.float().abs().max().item():
                    raise AssertionError(f"_weight_int4pack_mm at ({M}, {K}, {N}) is "
                                         f"{lib_err:.3e} from the plain version")
                t_l = timer.ms(lib)
                nbytes = (qw.numel() * 4 + 2 * sc.numel() * 4
                          + x.numel() * x.element_size() + M * N * x.element_size())
                bms, by = bound_ms(nbytes, 2 * M * K * N, dname)
                log(f"time awq_matmul {wname:6s} ({M}, {K}, {N}) bf16 group 64: kernel "
                    f"{t_k:.4f} ms  plain {t_p:.4f} ms  library (_weight_int4pack_mm, "
                    f"max_abs_err {lib_err:.3e}) {t_l:.4f} ms  bound {bms:.5f} ms ({by}); "
                    f"{awq_k.splits(M, K, N, gs, awq_k._sm_count(0))}; dense "
                    f"reference (torch.matmul, dequantized bf16 weight) {t_d:.4f} ms")
                log(f"device time awq_matmul {wname} ({M}, {K}, {N}) bf16 group 64: kernel "
                    + device_ms(torch, lambda: awq_k.awq_matmul(x, qw, sc, zr, group_size=gs))
                    + ", _weight_int4pack_mm " + device_ms(torch, lib))
                del lib
                if wname == "w1/w3":
                    rows["awq_matmul"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                              bound_ms=bms, bound_by=by)

    # prefill chunks reach awq_matmul with M = 16 (a page) down to 1; a whole
    # 250-token prompt loops over 16 row tiles
    K, N = AWQ_SHAPES["w1/w3"][1:]
    qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
    sc = 0.002 * torch.rand((K // 64, N), generator=g, device="cuda")
    zr = torch.randint(0, 16, (K // 64, N), generator=g, device="cuda").float()
    for M in (1, 3, 16, 250):
        for dname in ("float32", "bfloat16"):
            x = randn(M, K, dtype=getattr(torch, dname))
            err = check_close(f"awq_matmul prefill ({M}, {K}, {N}) group 64",
                              awq_k.awq_matmul(x, qw, sc, zr, group_size=64),
                              awq_k.plain(x, qw, sc, zr, group_size=64), dname)
            rows.setdefault(("awq_matmul", dname), []).append(err)

    # ---- contiguous decode attention: warmup/generate() run it at B=1,
    # S=max_seq; B=8 ragged is checked too
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for bb, lens in ((1, [256]), (B, [1, 5, 16, 17, 100, 128, 255, 256])):
            q = randn(bb, HQ, 1, D, dtype=dt)
            k = randn(bb, HKV, MAX_SEQ, D, dtype=dt)
            v = randn(bb, HKV, MAX_SEQ, D, dtype=dt)
            kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for cap in (0.0, 30.0):
                err = check_close(
                    f"decode_attention B={bb} cap={cap}",
                    dec_k.decode_attention(q, k, v, kv_len=kl, logit_soft_cap=cap),
                    dec_k.plain(q, k, v, kv_len=kl, logit_soft_cap=cap), dname)
                rows.setdefault(("decode_attention", dname), []).append(err)
    # ---- zamba2-7b's shared block: decode attention at B=8, 32/32 heads of
    # D=112 over a ragged 256-position contiguous cache; rmsnorm at 3584
    zl = [1, 5, 16, 17, 100, 128, 255, 256]
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q = randn(B, 32, 1, 112, dtype=dt)
        k, v = randn(B, 32, MAX_SEQ, 112, dtype=dt), randn(B, 32, MAX_SEQ, 112, dtype=dt)
        kl = torch.tensor(zl, dtype=torch.int32, device="cuda")
        rows[("decode_attention", dname)].append(check_close(
            "decode_attention zamba2 B=8 32/32 D=112",
            dec_k.decode_attention(q, k, v, kv_len=kl), dec_k.plain(q, k, v, kv_len=kl),
            dname))
        x, w = randn(B, 1, 3584, dtype=dt), 1 + 0.1 * randn(3584, dtype=dt)
        rows[("rmsnorm", dname)].append(check_close(
            "rmsnorm 8x3584", rms_k.rmsnorm(x, w), rms_k.plain(x, w), dname))
        if dname != "bfloat16":
            continue
        elt = q.element_size()
        t_k, t_p = timer.ms(lambda: rms_k.rmsnorm(x, w)), timer.ms(lambda: rms_k.plain(x, w))
        t_l = timer.ms(lambda: F.rms_norm(x, (3584,), w, eps=1e-5))
        bms, by = bound_ms(2 * x.numel() * elt + w.numel() * elt, 4 * x.numel(), dname)
        log(f"time rmsnorm zamba2 8x3584: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  library "
            f"{t_l:.4f} ms  bound {bms:.6f} ms ({by})")

    # decode attention timed at both main-path shapes (bf16): minitron-8b at
    # B=1 (warmup and generate()), zamba2-7b's shared block at B=8, ragged;
    # the yardstick is SDPA over K/V expanded to the query heads
    shapes = []
    for what, (bb, hq, hkv, d, lens) in (
            ("B=1 32/8 D=128 S=256", (1, HQ, HKV, D, [256])),
            ("zamba2 B=8 32/32 D=112 S=256 ragged", (B, 32, 32, 112, zl))):
        dt = torch.bfloat16
        q = randn(bb, hq, 1, d, dtype=dt)
        k, v = randn(bb, hkv, MAX_SEQ, d, dtype=dt), randn(bb, hkv, MAX_SEQ, d, dtype=dt)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ke = k.repeat_interleave(hq // hkv, dim=1)
        ve = v.repeat_interleave(hq // hkv, dim=1)
        mask = None
        if min(lens) < MAX_SEQ:
            mask = (torch.arange(MAX_SEQ, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
        t_k = timer.ms(lambda: dec_k.decode_attention(q, k, v, kv_len=kl))
        t_p = timer.ms(lambda: dec_k.plain(q, k, v, kv_len=kl))
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask))
        elt = q.element_size()
        keys = sum(lens)
        nbytes = 2 * q.numel() * elt + 2 * keys * hkv * d * elt + 4 * bb
        bms, by = bound_ms(nbytes, 4 * d * hq * keys, "bfloat16")
        n_split, chunk = dec_k.splits(bb, hkv, MAX_SEQ,
                                      torch.cuda.get_device_properties(0).multi_processor_count)
        shapes.append(dict(shape=what, n_split=n_split, ms=t_k, plain_ms=t_p, library_ms=t_l,
                           bound_ms=bms, bound_by=by))
        log(f"time decode_attention {what} bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
            f"library (SDPA) {t_l:.4f} ms  bound {bms:.6f} ms ({by}); {n_split} splits of "
            f"{chunk} keys, {bb * hkv * n_split} blocks")
        log(f"device time decode_attention {what} bf16: kernel "
            + device_ms(torch, lambda: dec_k.decode_attention(q, k, v, kv_len=kl)) + ", SDPA "
            + device_ms(torch, lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                                      attn_mask=mask)))
    rows["decode_attention"] = dict(shapes[0], shapes=shapes)

    # ---- ssd: the smoke chunk (16) in float32, with and without h0; then
    # zamba2-7b's prefill piece -- a 32-token piece padded to one 256-step
    # chunk (dt = 0 on the padding) -- the same chunk fully live, two full
    # chunks (the carry), and its training shape: batch 2, T = 1023 padded
    # to four chunks
    for dname, (b, T, H, P, N, L, live) in (
            ("float32", (2, 48, 4, 16, 16, 16, 37)),
            ("float32", (1, 256, 112, 64, 64, 256, 32)),
            ("bfloat16", (1, 256, 112, 64, 64, 256, 32)),
            ("bfloat16", (1, 256, 112, 64, 64, 256, 256)),
            ("bfloat16", (1, 512, 112, 64, 64, 256, 512)),
            ("bfloat16", (TRAIN_BATCH, 1024, 112, 64, 64, 256, TRAIN_SEQ - 1))):
        dt = getattr(torch, dname)
        x = randn(b, T, H, P, dtype=dt)
        dtv = 1e-3 + 0.1 * torch.rand((b, T, H), generator=g, device="cuda")
        dtv[:, live:] = 0.0
        A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
        Bm, Cm = randn(b, T, N, dtype=dt), randn(b, T, N, dtype=dt)
        Dv, h0 = randn(H, dtype=torch.float32), randn(b, H, P, N, dtype=torch.float32)
        what = f"ssd ({b}, {T}, {H}, {P}, {N}) chunk {L}, {live} live steps"
        for h in (None, h0):
            y, hf = ssd_k.ssd(x, dtv, A, Bm, Cm, Dv, chunk=L, h0=h)
            yp, hp = ssd_k.plain(x, dtv, A, Bm, Cm, Dv, chunk=L, h0=h)
            errs = rows.setdefault(("ssd", dname), [])
            errs.append(check_ssd(f"{what} h0={h is not None} y", y, yp))
            errs.append(check_ssd(f"{what} h0={h is not None} state", hf, hp))
        if dname == "bfloat16" and T == 256:      # the main path's piece, and fully live
            t_k = timer.ms(lambda: ssd_k.ssd(x, dtv, A, Bm, Cm, Dv, chunk=L, h0=h0))
            t_p = timer.ms(lambda: ssd_k.plain(x, dtv, A, Bm, Cm, Dv, chunk=L, h0=h0),
                           n=20)
            elt = x.element_size()
            nbytes = (2 * x.numel() * elt + dtv.numel() * 4 + 2 * H * 4
                      + 2 * Bm.numel() * elt + 2 * h0.numel() * 4)
            # float32 math per (batch, chunk): the causal C.B triangle once
            # (B and C are shared by the heads), then per head the M.x
            # triangle, the inter-chunk term and the state update
            f32_flops = b * (T // L) * (L * (L + 1) * N
                                        + H * (L * (L + 1) * P + 4 * L * P * N))
            flops = ssd_tensor_flops(dtv, P, N, L)
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            f32_bms, f32_by = bound_ms(nbytes, f32_flops, "float32")
            dev = device_ms(torch, lambda: ssd_k.ssd(x, dtv, A, Bm, Cm, Dv, chunk=L, h0=h0))
            dev_total = float(dev.split()[0])
            if live == 32:
                rows["ssd"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                                   bound_ms=bms, bound_by=by)
            log(f"time {what} bf16 with h0: kernel {t_k:.4f} ms, plain {t_p:.4f} ms; the "
                f"design's tensor-core work {flops / 1e9:.4f} GFLOP (bf16 pieces, dead "
                f"sub-chunks skipped), {nbytes / 1e6:.2f} MB: bound {bms:.6f} ms ({by}; "
                f"float32 CUDA-core bound of the scan's {f32_flops / 1e9:.3f} GFLOP "
                f"{f32_bms:.6f} ms, {f32_by}); device time {dev}, {bms / dev_total:.1%} of "
                f"the bound, {f32_bms / dev_total:.1%} of the float32 one")
        if dname == "bfloat16" and T == 1024:     # zamba2's training shape: the gradient
            gbms, gby, g_ms = ssd_grad_bound(torch, timer, randn, x, dtv, A, Bm, Cm, Dv, L)
            log(f"time {what} bf16: the gradient (autograd of the plain version, "
                f"recomputed: _SSD's backward) {g_ms:.4f} ms; its bound {gbms:.6f} ms "
                f"({gby}: each input and output gradient moved once, two products for each "
                f"of the forward's tensor-core products); {gbms / g_ms:.2%} of the bound")

    flash_phase(torch, timer, rows, randn)
    new_configs_phase(torch, timer, rows, randn, g)
    spec_shapes_phase(torch, timer, rows, randn, g)
    mla_shapes_phase(torch, timer, rows, randn, g)
    crossattn_shapes_phase(torch, timer, rows, randn, g)
    training_shapes_phase(torch, timer, rows, randn)

    for (name, dname), errs in sorted((k, v) for k, v in rows.items()
                                      if isinstance(k, tuple)):
        tol = (f"atol {TOL[dname][0]} + rtol {TOL[dname][1]}"
               + (f"; float32 outputs {SSD_REL} x max |plain|" if name == "ssd" else ""))
        log(f"kernel {name:21s} {dname:9s} max_abs_err {max(errs):.3e} (tolerance {tol})")
    for name in KERNELS:
        r = rows[name]
        r["max_abs_err"] = max(rows[(name, "float32")] + rows[(name, "bfloat16")])
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"time {name:21s} bf16 kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
            f"  library {lib}  bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


def time_shape(torch, timer, rows, name, what, kern, plain, lib, nbytes, flops,
               plain_n=N_TIMED):
    """Time ``kern`` (one bf16 call) beside its plain version and the
    library yardstick ``lib`` (per-call timer, cold L2), their device
    times (profiler) and the bound of ``nbytes`` / ``flops``; log the line
    and add it to rows[name]["shapes"]."""
    t_k, t_p, t_l = timer.ms(kern), timer.ms(plain, n=plain_n), timer.ms(lib)
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    dev_k, dev_l = device_ms(torch, kern), device_ms(torch, lib)
    dk = float(dev_k.split()[0])
    rows[name].setdefault("shapes", []).append(dict(
        shape=what, ms=t_k, device_ms=dk, plain_ms=t_p, library_ms=t_l,
        library_device_ms=float(dev_l.split()[0]), bound_ms=bms, bound_by=by))
    log(f"time {name} {what} bf16: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  library "
        f"{t_l:.4f} ms  bound {bms:.6f} ms ({by}); device time: kernel {dev_k}, "
        f"{bms / dk:.1%} of the bound; library {dev_l}")


def new_configs_phase(torch, timer, rows, randn, g):
    """The head shapes and widths of gemma-7b (D = 256, 16/16 heads, rows
    of 3072 with (1+w) norms), granite-20b (48/1 heads: G = 48, rows of
    6144) and deepseek-67b (64/8 heads, rows of 8192, its W4A16 shapes;
    its smoke's D = 8) against the plain versions in both types, and, in
    bf16 at the serving and training shapes, timed beside the library
    yardstick (SDPA, F.rms_norm, tinygemm) with device times and bounds.
    Paged attention's new heads are held in paged_heads_phase and
    flash_attention's in flash_phase (PAGED_HEADS, FLASH_SHAPES); here they
    are timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import awq_matmul as awq_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import paged_attention as pa_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms_k
    zl = [1, 5, 16, 17, 100, 128, 255, 256]
    # ---- decode attention over the contiguous cache (warmup, generate())
    for what, (bb, hq, hkv, d, lens, timed) in (
            ("granite-20b B=1 48/1 D=128 S=256", (1, 48, 1, 128, [256], True)),
            ("granite-20b B=8 48/1 D=128 ragged", (B, 48, 1, 128, zl, False)),
            ("gemma-7b B=1 16/16 D=256 S=256", (1, 16, 16, 256, [256], True)),
            ("gemma-7b B=8 16/16 D=256 ragged", (B, 16, 16, 256, zl, False)),
            ("deepseek-67b B=1 64/8 D=128 S=256", (1, 64, 8, 128, [256], False)),
            ("deepseek-67b smoke B=2 8/2 D=8", (2, 8, 2, 8, [20, 41], False))):
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q = randn(bb, hq, 1, d, dtype=dt)
            k, v = randn(bb, hkv, MAX_SEQ, d, dtype=dt), randn(bb, hkv, MAX_SEQ, d, dtype=dt)
            for cap in (0.0, 30.0):
                rows[("decode_attention", dname)].append(check_close(
                    f"decode_attention {what} cap={cap}",
                    dec_k.decode_attention(q, k, v, kv_len=kl, logit_soft_cap=cap),
                    dec_k.plain(q, k, v, kv_len=kl, logit_soft_cap=cap), dname))
        if not timed:
            continue
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        keys, elt = sum(lens), q.element_size()
        gb = dec_k.heads_per_block(hq // hkv)
        n_split, chunk = dec_k.splits(bb, hq // gb, MAX_SEQ, dec_k._sm_count(0))
        time_shape(torch, timer, rows, "decode_attention",
                   f"{what} ({gb} query heads a block, {n_split} splits of {chunk} keys)",
                   lambda: dec_k.decode_attention(q, k, v, kv_len=kl),
                   lambda: dec_k.plain(q, k, v, kv_len=kl),
                   lambda: F.scaled_dot_product_attention(q, ke, ve),
                   2 * q.numel() * elt + 2 * keys * hkv * d * elt + 4 * bb,
                   4 * d * hq * keys)

    # ---- paged attention at gemma-7b's heads, the serving batch of 8:
    # bf16 pages and int8 codes (the B=8 step's tables)
    n_pages, P = MAX_SEQ // PAGE, 257
    lens = torch.tensor([1, 17, 40, 64, 100, 150, 200, 256], dtype=torch.int32,
                        device="cuda")
    bt = (torch.randperm(P - 1, generator=g, device="cuda")[:B * n_pages] + 1).reshape(
        B, n_pages).to(torch.int32)
    live = ((lens + PAGE - 1) // PAGE).tolist()
    for b in range(B):
        bt[b, live[b]:] = 0
    bt = bt.contiguous()
    mask = (torch.arange(n_pages * PAGE, device="cuda")[None, :] < lens[:, None])[:, None,
                                                                                 None, :]
    keys = int(lens.sum())
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")   # as the B=8 step passes it
    for hq, hkv, d in ((16, 16, 256), (48, 1, 128)):
        q = randn(B, hq, 1, d, dtype=torch.bfloat16)
        kp, vp = (randn(P, hkv, PAGE, d, dtype=torch.float32) for _ in "kv")
        for kv in (None, "int8"):
            if kv is None:
                kk, vv, extra, name = kp.bfloat16(), vp.bfloat16(), {}, "paged_attention"
                gk, gv = ref.gather_kv_pages(kk, bt), ref.gather_kv_pages(vv, bt)
                per_key = d * 2
            else:
                (kk, ks), (vv, vs) = ref.quantize_kv(kp, torch.int8), ref.quantize_kv(vp, torch.int8)
                extra, name = dict(k_scales=ks, v_scales=vs), "paged_attention_quant"
                gk = ref.gather_dequant_kv_pages(kk, ks, bt).bfloat16()
                gv = ref.gather_dequant_kv_pages(vv, vs, bt).bfloat16()
                per_key = d + 4
            gk, gv = (t.repeat_interleave(hq // hkv, dim=1) for t in (gk, gv))
            kw = dict(block_tables=bt, kv_len=lens, pos_offset=zero, **extra)
            time_shape(torch, timer, rows, name,
                       f"B={B} {hq}/{hkv} D={d} {kv or 'bf16'} pages ragged; "
                       + paged_plan(torch, B, hq, hkv, n_pages, kv is not None),
                       lambda: pa_k.paged_attention(q, kk, vv, **kw),
                       lambda: pa_k.plain(q, kk, vv, **kw),
                       lambda: F.scaled_dot_product_attention(q, gk, gv, attn_mask=mask),
                       2 * q.numel() * 2 + 2 * keys * hkv * per_key + 4 * (sum(live) + 2 * B),
                       4 * d * hq * keys)

    # ---- flash_attention: gemma-7b's training shape (forward and
    # backward), its prefill and granite-20b's prefill (forward)
    b, hq, hkv, sq, skv, d, _, _ = GRANITE_PREFILL
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q, k, v = randn(b, hq, sq, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt), \
            randn(b, hkv, skv, d, dtype=dt)
        rows[("flash_attention", dname)].append(check_close(
            f"flash_attention {(b, hq, hkv, sq, skv, d)} causal (G = 48)",
            fa_k.flash_attention(q, k, v), fa_k.plain(q, k, v), dname))
    for (b, hq, hkv, sq, skv, d, causal, cap), bwd in (
            (FLASH_SHAPES[8], True), (FLASH_SHAPES[9], False), (GRANITE_PREFILL, False)):
        dt = torch.bfloat16
        q, k, v = randn(b, hq, sq, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt), \
            randn(b, hkv, skv, d, dtype=dt)
        pairs = sum(min(skv, skv - sq + i + 1) for i in range(sq))
        flops = 4 * b * hq * d * pairs
        what = f"{(b, hq, hkv, sq, skv, d)} causal"
        time_shape(torch, timer, rows, "flash_attention", what,
                   lambda: fa_k.flash_attention(q, k, v), lambda: fa_k.plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True),
                   (2 * q.numel() + k.numel() + v.numel()) * 2, flops, plain_n=20)
        if not bwd:
            continue
        go = randn(b, hq, sq, d, dtype=dt)
        sc = 1.0 / math.sqrt(d)
        with torch.no_grad():
            o, lse, o_lo = fa_k._launch(q, k, v, True, sc, 0.0, True)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        time_shape(torch, timer, rows, "flash_attention_bwd", what + " (the backward "
                   "kernel's launches, Delta included; plain: autograd of the plain "
                   "version, forward included; library: SDPA's backward)",
                   lambda: fa_k._launch_bwd(q, k, v, o, o_lo, lse, go, True, sc, 0.0,
                                            True, True),
                   lambda: torch.autograd.grad(fa_k.plain(qg, kg, vg), (qg, kg, vg), go),
                   lambda: torch.autograd.grad(sdpa, (qg, kg, vg), go, retain_graph=True),
                   (5 * q.numel() + 4 * k.numel()) * 2 + 4 * lse.numel(), 2.5 * flops,
                   plain_n=20)
        del o, lse, o_lo, sdpa, qg, kg, vg

    # ---- rmsnorm at the new widths: a decode tick's 8 rows, and gemma's
    # training rows (2048 x 3072), gemma style where the config is
    for width, gemma in ((3072, True), (6144, False), (8192, False)):
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            w = 0.1 * randn(width, dtype=dt) + (0 if gemma else 1)
            for rws in (B, TRAIN_BATCH * TRAIN_SEQ):
                x = randn(rws, width, dtype=dt)
                rows[("rmsnorm", dname)].append(check_close(
                    f"rmsnorm {rws}x{width} gemma={gemma}",
                    rms_k.rmsnorm(x, w, gemma_style=gemma),
                    rms_k.plain(x, w, gemma_style=gemma), dname))
        x = randn(B, width, dtype=torch.bfloat16)
        wl = (1 + w) if gemma else w
        time_shape(torch, timer, rows, "rmsnorm", f"{B}x{width} gemma={gemma}",
                   lambda: rms_k.rmsnorm(x, w, gemma_style=gemma),
                   lambda: rms_k.plain(x, w, gemma_style=gemma),
                   lambda: F.rms_norm(x, (width,), wl, eps=1e-5),
                   2 * x.numel() * 2 + width * 2, 4 * x.numel())

    # ---- awq_matmul at deepseek-67b's W4A16 shapes, group 64
    for wname, (M, K, N) in AWQ_DEEPSEEK.items():
        qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
        sc = 0.002 * torch.rand((K // 64, N), generator=g, device="cuda")
        zr = torch.randint(0, 16, (K // 64, N), generator=g, device="cuda").float()
        for dname in ("float32", "bfloat16"):
            x = randn(M, K, dtype=getattr(torch, dname))
            got = awq_k.awq_matmul(x, qw, sc, zr, group_size=64)
            rows[("awq_matmul", dname)].append(check_close(
                f"awq_matmul deepseek {wname} ({M}, {K}, {N}) group 64", got,
                awq_k.plain(x, qw, sc, zr, group_size=64), dname))
            if not torch.equal(got, awq_k.awq_matmul(x, qw, sc, zr, group_size=64)):
                raise AssertionError(f"awq_matmul deepseek {wname}: two calls differ")
        time_shape(torch, timer, rows, "awq_matmul",
                   f"deepseek-67b {wname} ({M}, {K}, {N}) group 64; "
                   f"{awq_k.splits(M, K, N, 64, awq_k._sm_count(0))}; library: tinygemm",
                   lambda: awq_k.awq_matmul(x, qw, sc, zr, group_size=64),
                   lambda: awq_k.plain(x, qw, sc, zr, group_size=64),
                   int4pack_mm(torch, x, qw, sc, zr, 64),
                   qw.numel() * 4 + 2 * sc.numel() * 4 + x.numel() * 2 + M * N * 2,
                   2 * M * K * N, plain_n=20)


def spec_shapes_phase(torch, timer, rows, randn, g):
    """The kernels at this slice's new call sites, against the plain
    versions in both types and timed in bf16 beside the library yardstick
    with device times and bounds: rmsnorm at xLSTM-125M's width 768 (a B=8
    decode step's 8 rows and a 16-token prefill piece) and at the
    speculative verify window's B x W = 8 x 5 = 40 rows of 4096;
    awq_matmul at M = 40 (the W4A16 verify window, w1/w3, group 64);
    decode attention at the model drafter's B = 8 (32/8 heads of 128 over
    MAX_SEQ positions, ragged)."""
    import torch.nn.functional as F
    from repro_torch.kernels import awq_matmul as awq_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms_k
    for rws, width in ((B, 768), (PAGE, 768), (B * (SPEC_K + 1), 4096)):
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            x, w = randn(rws, width, dtype=dt), 1 + 0.1 * randn(width, dtype=dt)
            rows[("rmsnorm", dname)].append(check_close(
                f"rmsnorm {rws}x{width}", rms_k.rmsnorm(x, w), rms_k.plain(x, w), dname))
        time_shape(torch, timer, rows, "rmsnorm", f"{rws}x{width}",
                   lambda: rms_k.rmsnorm(x, w), lambda: rms_k.plain(x, w),
                   lambda: F.rms_norm(x, (width,), w, eps=1e-5),
                   2 * x.numel() * 2 + width * 2, 4 * x.numel())
    M, K, N = B * (SPEC_K + 1), 4096, 16384
    qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
    sc = 0.002 * torch.rand((K // 64, N), generator=g, device="cuda")
    zr = torch.randint(0, 16, (K // 64, N), generator=g, device="cuda").float()
    for dname in ("float32", "bfloat16"):
        x = randn(M, K, dtype=getattr(torch, dname))
        got = awq_k.awq_matmul(x, qw, sc, zr, group_size=64)
        rows[("awq_matmul", dname)].append(check_close(
            f"awq_matmul verify window ({M}, {K}, {N}) group 64", got,
            awq_k.plain(x, qw, sc, zr, group_size=64), dname))
        if not torch.equal(got, awq_k.awq_matmul(x, qw, sc, zr, group_size=64)):
            raise AssertionError(f"awq_matmul at M = {M}: two calls differ")
    time_shape(torch, timer, rows, "awq_matmul",
               f"verify window w1/w3 ({M}, {K}, {N}) group 64; "
               f"{awq_k.splits(M, K, N, 64, awq_k._sm_count(0))}; library: tinygemm",
               lambda: awq_k.awq_matmul(x, qw, sc, zr, group_size=64),
               lambda: awq_k.plain(x, qw, sc, zr, group_size=64),
               int4pack_mm(torch, x, qw, sc, zr, 64),
               qw.numel() * 4 + 2 * sc.numel() * 4 + x.numel() * 2 + M * N * 2,
               2 * M * K * N, plain_n=20)
    lens = [20, 41, 64, 100, 128, 200, 255, 256]
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q = randn(B, HQ, 1, D, dtype=dt)
        k, v = randn(B, HKV, MAX_SEQ, D, dtype=dt), randn(B, HKV, MAX_SEQ, D, dtype=dt)
        rows[("decode_attention", dname)].append(check_close(
            "decode_attention drafter B=8 32/8 D=128", dec_k.decode_attention(q, k, v, kv_len=kl),
            dec_k.plain(q, k, v, kv_len=kl), dname))
    ke, ve = (t.repeat_interleave(HQ // HKV, dim=1) for t in (k, v))
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
    gb = dec_k.heads_per_block(HQ // HKV)
    n_split, chunk = dec_k.splits(B, HQ // gb, MAX_SEQ, dec_k._sm_count(0))
    time_shape(torch, timer, rows, "decode_attention",
               f"drafter B={B} {HQ}/{HKV} D={D} S={MAX_SEQ} ragged ({gb} query heads a "
               f"block, {n_split} splits of {chunk} keys)",
               lambda: dec_k.decode_attention(q, k, v, kv_len=kl),
               lambda: dec_k.plain(q, k, v, kv_len=kl),
               lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask),
               2 * q.numel() * 2 + 2 * sum(lens) * HKV * D * 2 + 4 * B,
               4 * D * HQ * sum(lens))


def mla_shapes_phase(torch, timer, rows, randn, g):
    """The MoE family's kernel shapes against the plain versions in both
    types, each timed in bf16 beside the library yardstick with device
    times and bounds: decode attention at MLA's D = 192 (the naive path's
    K = [K_nope, K_rope] and zero-padded V over every head: B = 8, 16/16
    heads, the gathered view of MAX_SEQ positions, ragged) and at the
    smoke's D = 24 (B = 2, 4/4 heads); the flash forward at D = 192 (the
    whole-prompt prefill, (1, 16/16, 250)) and D = 24; rmsnorm at
    deepseek-v2-lite's 2048; awq_matmul at its W4A16 shapes (MLA's wo, the
    shared experts' w1/w3 and w2, the dense first block's w1/w3 and w2, K =
    10944 being 171 groups of 64). grok-1's paged attention (G = 6, D =
    128) is held and timed in paged_heads_phase, its rmsnorm (6144) in
    new_configs_phase."""
    import torch.nn.functional as F
    from repro_torch.kernels import awq_matmul as awq_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms_k
    for what, (bb, h, d, dv, lens) in (
            ("deepseek-v2-lite MLA B=8 16/16 D=192", (B, 16, 192, 128,
                                                      [1, 5, 16, 17, 100, 128, 255, 256])),
            ("deepseek-v2-lite smoke MLA B=2 4/4 D=24", (2, 4, 24, 16, [20, 41]))):
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(d)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q = randn(bb, h, 1, d, dtype=dt)
            k, v = randn(bb, h, MAX_SEQ, d, dtype=dt), randn(bb, h, MAX_SEQ, d, dtype=dt)
            v[..., dv:] = 0                 # V zero-padded to K's width
            for cap in (0.0, 30.0):
                rows[("decode_attention", dname)].append(check_close(
                    f"decode_attention {what} cap={cap}",
                    dec_k.decode_attention(q, k, v, kv_len=kl, scale=sc, logit_soft_cap=cap),
                    dec_k.plain(q, k, v, kv_len=kl, scale=sc, logit_soft_cap=cap), dname))
        mask = (torch.arange(MAX_SEQ, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
        n_split, chunk = dec_k.splits(bb, h, MAX_SEQ, dec_k._sm_count(0))
        time_shape(torch, timer, rows, "decode_attention",
                   f"{what} S={MAX_SEQ} ragged (1 query head a block, {n_split} splits of "
                   f"{chunk} keys)",
                   lambda: dec_k.decode_attention(q, k, v, kv_len=kl, scale=sc),
                   lambda: dec_k.plain(q, k, v, kv_len=kl, scale=sc),
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=sc),
                   2 * q.numel() * 2 + 2 * sum(lens) * h * d * 2 + 4 * bb,
                   4 * d * h * sum(lens))
    for what, (b, h, sq, d) in (("deepseek-v2-lite MLA prefill", (1, 16, 250, 192)),
                                ("deepseek-v2-lite smoke MLA", (2, 4, 63, 24))):
        sc = 1.0 / math.sqrt(d)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q, k, v = (randn(b, h, sq, d, dtype=dt) for _ in "qkv")
            for causal in (True, False):
                rows[("flash_attention", dname)].append(check_close(
                    f"flash_attention {what} {(b, h, h, sq, sq, d)} causal={causal}",
                    fa_k.flash_attention(q, k, v, causal=causal, scale=sc),
                    fa_k.plain(q, k, v, causal=causal, scale=sc), dname))
        pairs = sum(i + 1 for i in range(sq))
        time_shape(torch, timer, rows, "flash_attention", f"{what} {(b, h, h, sq, sq, d)} causal",
                   lambda: fa_k.flash_attention(q, k, v, scale=sc),
                   lambda: fa_k.plain(q, k, v, scale=sc),
                   lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=sc),
                   4 * q.numel() * 2, 4 * b * h * d * pairs, plain_n=20)
    width = 2048
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x, w = randn(B, width, dtype=dt), 1 + 0.1 * randn(width, dtype=dt)
        rows[("rmsnorm", dname)].append(check_close(
            f"rmsnorm {B}x{width}", rms_k.rmsnorm(x, w), rms_k.plain(x, w), dname))
    time_shape(torch, timer, rows, "rmsnorm", f"{B}x{width} (deepseek-v2-lite)",
               lambda: rms_k.rmsnorm(x, w), lambda: rms_k.plain(x, w),
               lambda: F.rms_norm(x, (width,), w, eps=1e-5),
               2 * x.numel() * 2 + width * 2, 4 * x.numel())
    for wname, (M, K, N) in (("MLA wo", (B, 2048, 2048)), ("shared w1/w3", (B, 2048, 2816)),
                             ("shared w2", (B, 2816, 2048)), ("dense0 w1/w3", (B, 2048, 10944)),
                             ("dense0 w2", (B, 10944, 2048))):
        qw = ref.awq_pack(torch.randint(0, 16, (K, N), generator=g, device="cuda"))
        sc = 0.002 * torch.rand((K // 64, N), generator=g, device="cuda")
        zr = torch.randint(0, 16, (K // 64, N), generator=g, device="cuda").float()
        for dname in ("float32", "bfloat16"):
            x = randn(M, K, dtype=getattr(torch, dname))
            got = awq_k.awq_matmul(x, qw, sc, zr, group_size=64)
            rows[("awq_matmul", dname)].append(check_close(
                f"awq_matmul deepseek-v2-lite {wname} ({M}, {K}, {N}) group 64", got,
                awq_k.plain(x, qw, sc, zr, group_size=64), dname))
            if not torch.equal(got, awq_k.awq_matmul(x, qw, sc, zr, group_size=64)):
                raise AssertionError(f"awq_matmul deepseek-v2-lite {wname}: two calls differ")
        if wname in ("shared w2", "dense0 w2"):
            # tinygemm packs K in tiles of 128: 10944 is not, so that row's
            # yardstick is torch.matmul against the dequantized bf16 weight
            if K % 128 == 0:
                lib, lname = int4pack_mm(torch, x, qw, sc, zr, 64), "tinygemm"
            else:
                wd = ((ref.awq_unpack(qw).float() - zr.repeat_interleave(64, 0))
                      * sc.repeat_interleave(64, 0)).bfloat16()
                lib, lname = (lambda: x @ wd), "torch.matmul, dequantized bf16 weight"
            time_shape(torch, timer, rows, "awq_matmul",
                       f"deepseek-v2-lite {wname} ({M}, {K}, {N}) group 64, {K // 64} groups; "
                       f"{awq_k.splits(M, K, N, 64, awq_k._sm_count(0))}; library: {lname}",
                       lambda: awq_k.awq_matmul(x, qw, sc, zr, group_size=64),
                       lambda: awq_k.plain(x, qw, sc, zr, group_size=64), lib,
                       qw.numel() * 4 + 2 * sc.numel() * 4 + x.numel() * 2 + M * N * 2,
                       2 * M * K * N, plain_n=20)


def crossattn_shapes_phase(torch, timer, rows, randn, g):
    """The encoder-decoder and vision families' kernel shapes against the
    plain versions in both types, each timed in bf16 beside SDPA with
    device times and bounds: the flash forward at whisper-medium's D = 64
    (the encoder (1, 16/16, 1500) non-causal; the decoder's cross
    attention over 1500 encoder positions at a B = 8 decode step and at a
    16-token prefill piece; a causal 250-token prefill) and at
    llama-3.2-vision's cross shape (B = 8, 32/8, one query over 1601 image
    tokens, D = 128, non-causal); decode attention at whisper's decoder
    (B = 8, 16/16 heads of 64, S = 256, ragged). flash_phase holds the
    gradient at D = 64 (FLASH_SHAPES)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    for what, (b, hq, hkv, sq, skv, d, causal) in (
            ("whisper encoder", (1, 16, 16, 1500, 1500, 64, False)),
            ("whisper cross, B=8 decode step", (B, 16, 16, 1, 1500, 64, False)),
            ("whisper cross, 16-token piece", (1, 16, 16, PAGE, 1500, 64, False)),
            ("whisper prefill", (1, 16, 16, 250, 250, 64, True)),
            ("vision cross, B=8 decode step", (B, 32, 8, 1, 1601, 128, False))):
        shape = (b, hq, hkv, sq, skv, d)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q = randn(b, hq, sq, d, dtype=dt)
            k, v = randn(b, hkv, skv, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt)
            rows[("flash_attention", dname)].append(check_close(
                f"flash_attention {what} {shape} causal={causal}",
                fa_k.flash_attention(q, k, v, causal=causal),
                fa_k.plain(q, k, v, causal=causal), dname))
        pairs = sum(min(skv, skv - sq + i + 1) for i in range(sq)) if causal else sq * skv
        time_shape(torch, timer, rows, "flash_attention",
                   f"{what} {shape} {'causal' if causal else 'non-causal'}",
                   lambda: fa_k.flash_attention(q, k, v, causal=causal),
                   lambda: fa_k.plain(q, k, v, causal=causal),
                   lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                          enable_gqa=True),
                   (2 * q.numel() + k.numel() + v.numel()) * 2, 4 * b * hq * d * pairs,
                   plain_n=20)
    h, d, lens = 16, 64, [1, 5, 16, 17, 100, 128, 255, 256]
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q = randn(B, h, 1, d, dtype=dt)
        k, v = randn(B, h, MAX_SEQ, d, dtype=dt), randn(B, h, MAX_SEQ, d, dtype=dt)
        rows[("decode_attention", dname)].append(check_close(
            f"decode_attention whisper decoder B={B} {h}/{h} D={d}",
            dec_k.decode_attention(q, k, v, kv_len=kl), dec_k.plain(q, k, v, kv_len=kl),
            dname))
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
    n_split, chunk = dec_k.splits(B, h, MAX_SEQ, dec_k._sm_count(0))
    time_shape(torch, timer, rows, "decode_attention",
               f"whisper decoder B={B} {h}/{h} D={d} S={MAX_SEQ} ragged (1 query head a "
               f"block, {n_split} splits of {chunk} keys)",
               lambda: dec_k.decode_attention(q, k, v, kv_len=kl),
               lambda: dec_k.plain(q, k, v, kv_len=kl),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
               2 * q.numel() * 2 + 2 * sum(lens) * h * d * 2 + 4 * B, 4 * d * h * sum(lens))


def training_shapes_phase(torch, timer, rows, randn):
    """The flash backward at the training paths' shapes (FLASH_BWD_NEW;
    flash_phase holds them against the plain versions): in bf16 the
    backward kernel's launches timed beside the plain recompute and SDPA's
    backward (a yardstick the port never calls), with device times and the
    bound of five products of the forward's size."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k
    for what, (b, hq, hkv, sq, skv, d, causal) in FLASH_BWD_NEW:
        shape, sc, dt = (b, hq, hkv, sq, skv, d), 1.0 / math.sqrt(d), torch.bfloat16
        q, go = randn(b, hq, sq, d, dtype=dt), randn(b, hq, sq, d, dtype=dt)
        k, v = randn(b, hkv, skv, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt)
        pairs = sum(min(skv, skv - sq + i + 1) for i in range(sq)) if causal else sq * skv
        with torch.no_grad():
            o, lse, o_lo = fa_k._launch(q, k, v, causal, sc, 0.0, True)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
        time_shape(torch, timer, rows, "flash_attention_bwd",
                   f"{what} {shape} {'causal' if causal else 'non-causal'} (the backward "
                   f"kernel's launches, Delta included, DP {fa_k.bwd_width(d)}; plain: "
                   f"autograd of the plain version, forward included; library: SDPA's "
                   f"backward)",
                   lambda: fa_k._launch_bwd(q, k, v, o, o_lo, lse, go, causal, sc, 0.0,
                                            True, True),
                   lambda: torch.autograd.grad(fa_k.plain(qg, kg, vg, causal=causal),
                                               (qg, kg, vg), go),
                   lambda: torch.autograd.grad(sdpa, (qg, kg, vg), go, retain_graph=True),
                   (5 * q.numel() + 4 * k.numel()) * 2 + 4 * lse.numel(),
                   10 * b * hq * d * pairs, plain_n=10)
        del o, lse, o_lo, sdpa, qg, kg, vg


def paged_plan(torch, b, hq, hkv, n_pages, quant):
    """The split plan the paged wrapper makes for these heads, as text."""
    from repro_torch.kernels import paged_attention as pa_k
    gb = pa_k.heads_per_block(hq // hkv, quant)
    n_split, chunk = pa_k.splits(b, hq // gb, n_pages, PAGE,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"{n_split} splits of {chunk} keys, {gb} query heads a block, "
            f"{b * hq // gb * n_split} blocks")


def paged_heads_phase(torch, timer, rows, randn, g):
    """Paged attention at every head group the kernel takes (PAGED_HEADS:
    grok's 48/8, granite's 48/1, deepseek-67b's 64/8, the smoke 4/2,
    zamba2's D = 112) over pages in q's type and int8 / fp8 codes, with
    and without a soft cap: ragged kv_len from 1 to the table's length,
    rolled-out offsets, a parked slot (kv_len 1 on an all-zero row, its
    output finite and discarded), garbage in the trash page and 1e6 scales
    in dead pages. G = 48 and G = 6 are timed (bf16 pages) with their
    split plans."""
    from repro_torch.kernels import paged_attention as pa_k
    from repro_torch.kernels import ref
    n_pages, P, bb = MAX_SEQ // PAGE, 160, 9
    lens = torch.tensor([1, 2, 16, 17, 40, 100, 200, 256, 1], dtype=torch.int32,
                        device="cuda")
    poff = torch.tensor([0, 0, 0, 16, 0, 32, 48, 0, 0], dtype=torch.int32, device="cuda")
    bt = (torch.randperm(P - 1, generator=g, device="cuda")[:bb * n_pages] + 1).reshape(
        bb, n_pages).to(torch.int32)
    live = ((lens - poff + PAGE - 1) // PAGE).tolist()
    for b in range(bb):
        bt[b, live[b]:] = 0
    bt[bb - 1] = 0                                # parked
    bt = bt.contiguous()
    dead = torch.tensor(sorted(set(range(P)) - {int(p) for p in bt.flatten().tolist()})
                        + [0], device="cuda")
    kw = dict(block_tables=bt, kv_len=lens, pos_offset=poff)
    for (hq, hkv, d) in PAGED_HEADS:
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q = randn(bb, hq, 1, d, dtype=dt)
            for kv in (None, "int8", "float8_e4m3fn"):
                kp = randn(P, hkv, PAGE, d, dtype=torch.float32)
                vp = randn(P, hkv, PAGE, d, dtype=torch.float32)
                if kv is None:
                    kp, vp, extra, name = kp.to(dt), vp.to(dt), {}, "paged_attention"
                    kp[0], vp[0] = 1e4, -1e4
                else:
                    kp, ks = ref.quantize_kv(kp, getattr(torch, kv))
                    vp, vs = ref.quantize_kv(vp, getattr(torch, kv))
                    ks[dead], vs[dead] = 1e6, 1e6
                    extra, name = dict(k_scales=ks, v_scales=vs), "paged_attention_quant"
                for cap in (0.0, 30.0):
                    got = pa_k.paged_attention(q, kp, vp, logit_soft_cap=cap, **kw, **extra)
                    if not bool(got[-1].isfinite().all()):
                        raise AssertionError(f"paged_attention {hq}/{hkv}: parked slot")
                    rows[(name, dname)].append(check_close(
                        f"{name} {hq}/{hkv} D={d} {kv or 'pages in q type'} cap={cap}",
                        got[:-1], pa_k.plain(q, kp, vp, logit_soft_cap=cap, **kw,
                                             **extra)[:-1], dname))
                if dname == "bfloat16" and kv is None and hkv != hq and hq // hkv in (6, 48):
                    t_k = timer.ms(lambda: pa_k.paged_attention(q, kp, vp, **kw))
                    t_p = timer.ms(lambda: pa_k.plain(q, kp, vp, **kw))
                    log(f"time paged_attention B={bb} (a parked slot) {hq}/{hkv} D={d} G="
                        f"{hq // hkv} bf16 pages: kernel {t_k:.4f} ms  plain {t_p:.4f} ms; "
                        f"{paged_plan(torch, bb, hq, hkv, n_pages, False)}")


def flash_phase(torch, timer, rows, randn):
    """flash_attention against its plain version at FLASH_SHAPES in both
    types, forward and gradient: the backward kernel's (dq, dk, dv)
    against plain autograd and against ``plain_bwd`` on the kernel's own
    out and lse, under TOL, and two backward calls bit-equal. At the
    training shape (bf16) the forward is timed beside SDPA, and the
    backward (autograd.grad through the kernels) beside the plain
    recompute (autograd of the plain version, forward included: the
    backward before this kernel) and SDPA's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k

    def grads(fn, q, k, v, go, **kw):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, **kw), leaves, go)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for (b, hq, hkv, sq, skv, d, causal, cap) in FLASH_SHAPES:
            q, k, v = randn(b, hq, sq, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt), \
                randn(b, hkv, skv, d, dtype=dt)
            what = f"flash_attention {(b, hq, hkv, sq, skv, d)} causal={causal} cap={cap}"
            kw = dict(causal=causal, logit_soft_cap=cap)
            rows.setdefault(("flash_attention", dname), []).append(check_close(
                what, fa_k.flash_attention(q, k, v, **kw), fa_k.plain(q, k, v, **kw), dname))
            go = randn(b, hq, sq, d, dtype=dt)
            got = grads(fa_k.flash_attention, q, k, v, go, **kw)
            again = grads(fa_k.flash_attention, q, k, v, go, **kw)
            want = grads(fa_k.plain, q, k, v, go, **kw)
            with torch.no_grad():
                out, lse, out_lo = fa_k._launch(q, k, v, causal, 1.0 / math.sqrt(d), cap, True)
                if out_lo is not None:           # bf16: the float32 output
                    out = out.float() + out_lo.float()
                mine = fa_k.plain_bwd(q, k, v, out, lse, go, **kw)
            errs = rows.setdefault(("flash_attention_bwd", dname), [])
            for name, a, a2, w, m in zip("qkv", got, again, want, mine):
                if not torch.equal(a, a2):
                    raise AssertionError(f"{what} d{name}: two backward calls differ")
                errs.append(check_close(f"{what} d{name} vs plain autograd", a, w, dname))
                errs.append(check_close(f"{what} d{name} vs plain_bwd", a, m, dname))
            del got, again, want, mine
    b, hq, hkv, sq, skv, d, _, _ = FLASH_SHAPES[0]
    dt = torch.bfloat16
    q, k, v = randn(b, hq, sq, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt), \
        randn(b, hkv, skv, d, dtype=dt)
    t_k = timer.ms(lambda: fa_k.flash_attention(q, k, v))
    t_p = timer.ms(lambda: fa_k.plain(q, k, v), n=20)
    t_l = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True))
    off = skv - sq
    pairs = sum(min(skv, off + i + 1) for i in range(sq))        # visible (query, key)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * b * hq * d * pairs
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    rows["flash_attention"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                   bound_ms=bms, bound_by=by)
    # the backward at the training shape: through autograd, as training calls it
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    go = randn(b, hq, sq, d, dtype=dt)
    out = fa_k.flash_attention(qg, kg, vg)
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    t_bk = timer.ms(lambda: torch.autograd.grad(out, (qg, kg, vg), go, retain_graph=True))
    t_bp = timer.ms(lambda: torch.autograd.grad(fa_k.plain(qg, kg, vg), (qg, kg, vg), go),
                    n=20)
    t_bl = timer.ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), go, retain_graph=True))
    with torch.no_grad():
        o, lse, o_lo = fa_k._launch(q, k, v, True, 1.0 / math.sqrt(d), 0.0, True)
    t_raw = timer.ms(lambda: fa_k._launch_bwd(q, k, v, o, o_lo, lse, go, True,
                                              1.0 / math.sqrt(d), 0.0, True, True))
    # five products of the forward's size; read q, k, v, out, out_lo, dout
    # and lse once, write dq, dk, dv once
    b_flops = 10 * b * hq * d * pairs
    b_bytes = (5 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
    b_bms, b_by = bound_ms(b_bytes, b_flops, "bfloat16")
    rows["flash_attention_bwd"] = dict(ms=t_bk, plain_ms=t_bp, library_ms=t_bl,
                                       bound_ms=b_bms, bound_by=b_by)
    peak = PEAK_FLOPS["bfloat16"] / 1e12
    log(f"time flash_attention {(b, hq, hkv, sq, skv, d)} bf16 causal (wgmma body): {pairs} "
        f"visible (query, key) pairs a head, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"forward kernel {t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s, "
        f"{flops / t_k / 1e9 / peak:.1%} of the bf16 peak), plain {t_p:.4f} ms, SDPA "
        f"{t_l:.4f} ms ({flops / t_l / 1e9:.1f} TFLOP/s), bound {bms:.5f} ms ({by})")
    log(f"time flash_attention_bwd {(b, hq, hkv, sq, skv, d)} bf16 causal: "
        f"{b_flops / 1e9:.2f} GFLOP (five products; the bf16 kernel does seven: S and dP "
        f"once, dV and dK over bf16 hi/lo halves, dQ over dS rounded once), "
        f"{b_bytes / 1e6:.1f} MB; backward through autograd {t_bk:.4f} ms "
        f"({b_flops / t_bk / 1e9:.1f} TFLOP/s, {b_bms / t_bk:.1%} of the bound "
        f"{b_bms:.5f} ms ({b_by})), the kernel launch alone {t_raw:.4f} ms; plain recompute "
        f"{t_bp:.4f} ms; SDPA's backward {t_bl:.4f} ms ({b_flops / t_bl / 1e9:.1f} TFLOP/s)")
    dev = {}
    # device time by kernel (profiler): the backward's two launches and
    # SDPA's backward, the forward with and without what the backward
    # needs (lse, out_lo) and SDPA's forward
    for what, fn in (
            ("backward kernel", lambda: fa_k._launch_bwd(q, k, v, o, o_lo, lse, go, True,
                                                         1.0 / math.sqrt(d), 0.0, True, True)),
            ("backward kernel, dK and dV only", lambda: fa_k._launch_bwd(
                q, k, v, o, o_lo, lse, go, True, 1.0 / math.sqrt(d), 0.0, False, True)),
            ("backward kernel, dQ only", lambda: fa_k._launch_bwd(
                q, k, v, o, o_lo, lse, go, True, 1.0 / math.sqrt(d), 0.0, True, False)),
            ("SDPA's backward", lambda: torch.autograd.grad(sdpa, (qg, kg, vg), go,
                                                            retain_graph=True)),
            ("forward writing lse and out_lo",
             lambda: fa_k._launch(q, k, v, True, 1.0 / math.sqrt(d), 0.0, True)),
            ("forward", lambda: fa_k._launch(q, k, v, True, 1.0 / math.sqrt(d), 0.0, False)),
            ("SDPA's forward", lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))):
        dev[what] = device_ms(torch, fn)
        log(f"device time flash_attention {(b, hq, hkv, sq, skv, d)} {what}: {dev[what]}")
    mine, kv_only, theirs = (float(dev[w].split()[0]) for w in (
        "backward kernel", "backward kernel, dK and dV only", "SDPA's backward"))
    log(f"device time flash_attention_bwd {(b, hq, hkv, sq, skv, d)} bf16 causal: seven "
        f"products {mine:.4f} ms ({b_bms / mine:.1%} of the bound {b_bms:.6f} ms) against "
        f"SDPA's backward {theirs:.4f} ms ({b_bms / theirs:.1%}): {mine / theirs:.3f}x; "
        f"dQ (its product and the ordered sum) adds {mine - kv_only:.4f} ms to dK and dV's")
    log(rounding_model(torch, q, k, v, go))
    del out, sdpa, o, o_lo, lse
    # the whole-prompt prefill's shape (32 launches in the prefill check),
    # and the float32 bodies at the training shape
    for (b, hq, hkv, sq, skv, d, _, _), dt in ((FLASH_SHAPES[1], torch.bfloat16),
                                               (FLASH_SHAPES[0], torch.float32)):
        q, k, v = randn(b, hq, sq, d, dtype=dt), randn(b, hkv, skv, d, dtype=dt), \
            randn(b, hkv, skv, d, dtype=dt)
        t_k = timer.ms(lambda: fa_k.flash_attention(q, k, v))
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True))
        pairs = sum(min(skv, skv - sq + i + 1) for i in range(sq))
        flops = 4 * b * hq * d * pairs
        extra = ""
        if dt == torch.float32:
            go = randn(b, hq, sq, d, dtype=dt)
            with torch.no_grad():
                o, lse, _ = fa_k._launch(q, k, v, True, 1.0 / math.sqrt(d), 0.0, True)
            t_b = timer.ms(lambda: fa_k._launch_bwd(q, k, v, o, None, lse, go, True,
                                                    1.0 / math.sqrt(d), 0.0, True, True),
                           n=20)
            extra = f"; backward kernel {t_b:.4f} ms ({2.5 * flops / t_b / 1e9:.1f} TFLOP/s)"
        log(f"time flash_attention {(b, hq, hkv, sq, skv, d)} {str(dt)[6:]} causal: kernel "
            f"{t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s), SDPA {t_l:.4f} ms{extra}")


# ---------------------------------------------------------------- reference
def reference_phase(torch):
    """The same small float32 model on the card and on the CPU: greedy
    streams must agree token for token. Dense weights over unquantized
    pages, then W4A16 weights (group 64) over int8 and over fp8 pages."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.quantize import quantize_mlp_tree

    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64,
                                                  compute_dtype="float32")
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over",
               "x"]
    dense = ServingEngine(cfg, max_seq=96, device="cuda").params
    for kv_dtype, params in (("fp32", dense),
                             ("int8", quantize_mlp_tree(dense, group_size=64)),
                             ("fp8_e4m3", quantize_mlp_tree(dense, group_size=64))):
        gpu = ServingEngine(cfg, max_seq=96, device="cuda", params=params,
                            kv_dtype=kv_dtype)
        cpu = ServingEngine(cfg, max_seq=96, device="cpu", kv_dtype=kv_dtype,
                            params=tree_map(lambda t: t.cpu(), params))
        for p in prompts:
            a, c = gpu.generate(p, max_new_tokens=12).tokens, cpu.generate(p, max_new_tokens=12).tokens
            if a != c:
                raise AssertionError(f"{kv_dtype}: generate() differs card vs CPU: {a} vs {c}")
        hg = [gpu.submit(p, max_new_tokens=12) for p in prompts]
        hc = [cpu.submit(p, max_new_tokens=12) for p in prompts]
        for a, c in zip(hg, hc):
            ta, tc = a.result(timeout=300).tokens, c.result(timeout=300).tokens
            if ta != tc:
                raise AssertionError(f"{kv_dtype}: batcher stream differs card vs CPU: "
                                     f"{ta} vs {tc}")
        gpu.shutdown()
        cpu.shutdown()
        log(f"reference: {len(prompts)} prompts token-identical card vs CPU "
            f"(generate and paged batcher, float32, "
            f"{'dense weights' if kv_dtype == 'fp32' else 'W4A16 group 64'}, "
            f"{kv_dtype} pages)")

    # the other dense configs' smoke models: gemma (GeGLU, (1+w) norms, tied
    # embeddings), granite (MQA), deepseek (D = 8), the last also over int8
    # pages with W4A16 weights
    for arch, kv_dtype in (("gemma-7b", "fp32"), ("granite-20b", "fp32"),
                           ("deepseek-67b", "fp32"), ("deepseek-67b", "int8"),
                           ("deepseek-v2-lite-16b", "fp32"), ("deepseek-v2-lite-16b", "int8"),
                           ("grok-1-314b", "fp32")):
        acfg = get_smoke_config(arch).replace(vocab_size=300, vocab_pad_to=64,
                                              compute_dtype="float32")
        params = ServingEngine(acfg, max_seq=96, device="cuda").params
        if kv_dtype != "fp32":
            params = quantize_mlp_tree(params, group_size=64)
        gpu = ServingEngine(acfg, max_seq=96, device="cuda", params=params,
                            kv_dtype=kv_dtype)
        cpu = ServingEngine(acfg, max_seq=96, device="cpu", kv_dtype=kv_dtype,
                            params=tree_map(lambda t: t.cpu(), params))
        for p in prompts:
            a, c = gpu.generate(p, max_new_tokens=12).tokens, cpu.generate(p, max_new_tokens=12).tokens
            if a != c:
                raise AssertionError(f"{arch} {kv_dtype}: generate() differs card vs CPU: "
                                     f"{a} vs {c}")
        hg = [gpu.submit(p, max_new_tokens=12) for p in prompts]
        hc = [cpu.submit(p, max_new_tokens=12) for p in prompts]
        for a, c in zip(hg, hc):
            ta, tc = a.result(timeout=300).tokens, c.result(timeout=300).tokens
            if ta != tc:
                raise AssertionError(f"{arch} {kv_dtype}: batcher stream differs card vs "
                                     f"CPU: {ta} vs {tc}")
        gpu.shutdown()
        cpu.shutdown()
        width = (acfg.qk_nope_head_dim + acfg.qk_rope_head_dim if acfg.use_mla
                 else acfg.head_dim)
        log(f"reference: {len(prompts)} prompts token-identical card vs CPU ({arch} smoke, "
            f"{acfg.n_heads}/{acfg.n_kv_heads} heads of {width}"
            f"{' (MLA)' if acfg.use_mla else ''}"
            f"{f', {acfg.n_experts} experts top-{acfg.top_k}' if acfg.n_experts else ''}"
            f", float32, generate "
            f"and paged batcher, {kv_dtype} pages"
            f"{', W4A16 group 64' if kv_dtype != 'fp32' else ''})")

    # the hybrid family: ssd in every prefill piece, the contiguous splice
    # batcher with a stateful prefix pool (the repeat is a prefix hit)
    zcfg = get_smoke_config("zamba2-7b").replace(vocab_size=300, vocab_pad_to=64,
                                                 compute_dtype="float32")
    gpu = ServingEngine(zcfg, max_seq=96, device="cuda")
    cpu = ServingEngine(zcfg, max_seq=96, device="cpu",
                        params=tree_map(lambda t: t.cpu(), gpu.params))
    for p in prompts:
        a, c = gpu.generate(p, max_new_tokens=12).tokens, cpu.generate(p, max_new_tokens=12).tokens
        if a != c:
            raise AssertionError(f"zamba2: generate() differs card vs CPU: {a} vs {c}")
    streams = []
    for eng in (gpu, cpu):
        res = [h.result(timeout=300) for h in
               [eng.submit(p, max_new_tokens=12) for p in prompts]]
        res.append(eng.submit(prompts[1], max_new_tokens=12).result(timeout=300))
        streams.append(res)
    for a, c in zip(*streams):
        if a.tokens != c.tokens or a.prefix_hit_tokens != c.prefix_hit_tokens:
            raise AssertionError(f"zamba2: batcher stream differs card vs CPU: "
                                 f"{a.tokens} vs {c.tokens}")
    b = gpu.scheduler.batcher
    if b.paged or not streams[0][-1].prefix_hit_tokens:
        raise AssertionError("zamba2: not served by the splice path with a prefix hit")
    gpu.shutdown()
    cpu.shutdown()
    log(f"reference: {len(prompts)} prompts + a prefix hit token-identical card vs CPU "
        f"(zamba2 smoke, float32, generate and the contiguous splice batcher; "
        f"{b.bytes_copied_per_admission():.0f} B copied per admission)")


def crossattn_reference_phase(torch):
    """The encoder-decoder and vision smokes (float32, D = 16: whisper's
    2 + 2 layers over 24 frames, the vision model's 4 layers with 2 gated
    cross blocks over 12 patches, its gates set to VISION_GATE) on the
    card and on the CPU with the same weights: greedy and seeded streams
    token-identical through generate(), generate_batch and
    ServingEngine.submit (the contiguous splice batcher with a stateful
    prefix pool; a repeated prompt is a prefix hit); then the model alone
    with its stub input (seeded, STUB_SCALE): prefill_chunk pieces with
    the frames / patches on the first, then four greedy decode steps,
    logits within the float32 tolerance and the same tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.models.common import tree_map
    from repro_torch.serving import GenerationParams, ServingEngine
    from repro_torch.serving.pagepool import chunk_plan

    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over",
               "x"]
    seeded = GenerationParams(max_tokens=12, temperature=0.9, seed=77)
    for arch in ("whisper-medium", "llama-3.2-vision-11b"):
        cfg = get_smoke_config(arch).replace(vocab_size=300, vocab_pad_to=64,
                                             compute_dtype="float32")
        gpu = ServingEngine(cfg, max_seq=96, device="cuda")
        if "cross" in gpu.params:
            gpu.params["cross"]["attn"]["gate"].fill_(VISION_GATE)
        cpu = ServingEngine(cfg, max_seq=96, device="cpu",
                            params=tree_map(lambda t: t.cpu(), gpu.params))
        for p in prompts:
            a, c = (gpu.generate(p, max_new_tokens=12).tokens,
                    cpu.generate(p, max_new_tokens=12).tokens)
            if a != c:
                raise AssertionError(f"{arch}: generate() differs card vs CPU: {a} vs {c}")
        a, c = gpu.generate_batch(prompts)[1], cpu.generate_batch(prompts)[1]
        if a != c:
            raise AssertionError(f"{arch}: generate_batch differs card vs CPU: {a} vs {c}")
        streams = []
        for eng in (gpu, cpu):
            res = [h.result(timeout=300) for h in
                   [eng.submit(p, max_new_tokens=12) for p in prompts]
                   + [eng.submit(prompts[0], params=seeded)]]
            res.append(eng.submit(prompts[1], max_new_tokens=12).result(timeout=300))
            streams.append(res)
        for a, c in zip(*streams):
            if a.tokens != c.tokens or a.prefix_hit_tokens != c.prefix_hit_tokens:
                raise AssertionError(f"{arch}: batcher stream differs card vs CPU: "
                                     f"{a.tokens} vs {c.tokens}")
        b = gpu.scheduler.batcher
        if b.paged or not streams[0][-1].prefix_hit_tokens:
            raise AssertionError(f"{arch}: not served by the splice path with a prefix hit")
        gpu.shutdown()
        cpu.shutdown()

        # the model alone with its stub input on the first piece
        gen = torch.Generator().manual_seed(0)
        if cfg.is_encoder_decoder:
            key, shape = "frames", (1, cfg.encoder_seq_len, cfg.d_model)
        else:
            key, shape = "vision", (1, cfg.n_image_tokens, cfg.vision_dim)
        stub = STUB_SCALE * torch.randn(shape, generator=gen)
        ids = torch.randint(3, 259, (1, 37), generator=gen)
        out = {}
        before = fa_k.launches
        for eng in (gpu, cpu):
            m, dev = eng.model, eng.device
            cache, off, steps = m.init_cache(1, 96, dev), 0, []
            with torch.inference_mode():
                for i, n in enumerate(chunk_plan(0, ids.shape[1], 16)):
                    logits, cache = m.prefill_chunk(
                        eng.params, ids[:, off:off + n].to(dev), cache,
                        {key: stub.to(dev)} if i == 0 else None)
                    off += n
                steps.append(logits)
                for _ in range(4):
                    tok = torch.argmax(logits, -1)[:, None]
                    logits, cache = m.decode_step(eng.params, tok, cache)
                    steps.append(logits)
            out[dev.type] = steps
        worst = max(check_close(f"{arch} smoke with {key}: step {i}", a.cpu(), c, "float32")
                    for i, (a, c) in enumerate(zip(out["cuda"], out["cpu"])))
        if [int(t.argmax()) for t in out["cuda"]] != [int(t.argmax()) for t in out["cpu"]]:
            raise AssertionError(f"{arch} smoke with {key}: greedy tokens differ card vs CPU")
        if fa_k.launches == before:
            raise AssertionError(f"{arch} smoke with {key}: flash_attention not launched")
        log(f"reference: {len(prompts)} prompts, a seeded stream and a prefix hit "
            f"token-identical card vs CPU ({cfg.name}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
            f"of {cfg.head_dim}, float32, generate, generate_batch and the contiguous splice "
            f"batcher; {b.bytes_copied_per_admission():.0f} B copied per admission); "
            f"prefill_chunk with {key} {tuple(shape)} on the first piece and 4 decode "
            f"steps: logits max abs diff {worst:.3e}, same greedy tokens, "
            f"{fa_k.launches - before} flash_attention launches")


def xlstm_reference_phase(torch):
    """The small float32 xLSTM (the default local tier's family) on the
    card (the rmsnorm kernel at its norms) and on the CPU with the same
    weights: greedy streams identical through generate() and through the
    contiguous splice batcher with a stateful prefix pool (the repeat is
    a prefix hit)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine

    cfg = get_smoke_config("xlstm-125m").replace(vocab_size=300, vocab_pad_to=64,
                                                 compute_dtype="float32")
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over",
               "x"]
    gpu = ServingEngine(cfg, max_seq=96, device="cuda")
    cpu = ServingEngine(cfg, max_seq=96, device="cpu",
                        params=tree_map(lambda t: t.cpu(), gpu.params))
    for p in prompts:
        a, c = gpu.generate(p, max_new_tokens=12).tokens, cpu.generate(p, max_new_tokens=12).tokens
        if a != c:
            raise AssertionError(f"xlstm: generate() differs card vs CPU: {a} vs {c}")
    streams = []
    for eng in (gpu, cpu):
        res = [h.result(timeout=300) for h in
               [eng.submit(p, max_new_tokens=12) for p in prompts]]
        res.append(eng.submit(prompts[1], max_new_tokens=12).result(timeout=300))
        streams.append(res)
    for a, c in zip(*streams):
        if a.tokens != c.tokens or a.prefix_hit_tokens != c.prefix_hit_tokens:
            raise AssertionError(f"xlstm: batcher stream differs card vs CPU: "
                                 f"{a.tokens} vs {c.tokens}")
    b = gpu.scheduler.batcher
    if b.paged or not b.pool.stateful or not streams[0][-1].prefix_hit_tokens:
        raise AssertionError("xlstm: not served by the splice path with a prefix hit")
    gpu.shutdown()
    cpu.shutdown()
    log(f"reference: {len(prompts)} prompts + a prefix hit token-identical card vs CPU "
        f"(xlstm smoke, float32, generate and the contiguous splice batcher with a "
        f"stateful pool; {b.bytes_copied_per_admission():.0f} B copied per admission)")


def speculative_reference_phase(torch):
    """Speculative decoding of the small float32 minitron on the card, over
    float32 pages, over int8 pages with W4A16 weights (both paged) and on
    the contiguous splice path: n-gram drafts, a model drafter (the smoke
    gemma, decode_attention in its propose_k), and draft_hook replays of
    the plain stream at 100% acceptance, with every draft wrong (0%) and
    with the third draft of each window wrong (mid-window) all give the
    CPU's plain greedy stream (float32: token identity is exact there)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ContinuousBatcher, Request, ServingEngine
    from repro_torch.serving.quantize import quantize_mlp_tree

    kw = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
    cfg = get_smoke_config("minitron-8b").replace(**kw)
    small = get_smoke_config("gemma-7b").replace(**kw)
    dense = ServingEngine(cfg, max_seq=96, device="cuda").params
    dparams = ServingEngine(small, max_seq=96, device="cuda", seed=1).params
    prompt = "speculative parity prompt, speculative parity prompt"

    def run(eng, mode="off", hook=None):
        eng.speculative = mode
        cb = ContinuousBatcher(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
        eng.speculative = "off"
        if cb.spec_mode != mode:
            raise AssertionError(f"speculative mode {cb.spec_mode}, asked for {mode}")
        if hook is not None:
            cb.draft_hook = hook(cb.spec_k)
        req = Request(rid="r", prompt_ids=eng.tokenizer.encode(prompt), max_new_tokens=16)
        cb.submit(req)
        cb.run_until_drained()
        return req.output_ids, cb.spec_stats, cb.paged

    def replay(plain, at=None):
        def make(k):
            def hook(slot, req):
                d = list(plain[len(req.output_ids):len(req.output_ids) + k])
                for i in range(len(d)):
                    if at == "all" or i == at:
                        d[i] = (d[i] + 1) % 300
                return d
            return hook
        return make

    for paged, kv_dtype in ((True, "fp32"), (False, "fp32"), (True, "int8")):
        params = dense if kv_dtype == "fp32" else quantize_mlp_tree(dense, group_size=64)
        gpu = ServingEngine(cfg, max_seq=96, device="cuda", params=params, paged_kv=paged,
                            kv_dtype=kv_dtype, drafter_cfg=small, drafter_params=dparams)
        cpu = ServingEngine(cfg, max_seq=96, device="cpu", paged_kv=paged, kv_dtype=kv_dtype,
                            params=tree_map(lambda t: t.cpu(), params))
        plain = run(cpu)[0]
        out = []
        for name, mode, hook in (("plain", "off", None), ("ngram", "ngram", None),
                                 ("model", "model", None),
                                 ("100%", "ngram", replay(plain)),
                                 ("0%", "ngram", replay(plain, "all")),
                                 ("mid-window", "ngram", replay(plain, 2))):
            toks, st, is_paged = run(gpu, mode, hook)
            if toks != plain or is_paged != paged:
                raise AssertionError(f"speculative {name} ({kv_dtype} pages, paged {paged}): "
                                     f"{toks} vs the CPU's plain {plain}")
            if name == "100%" and st.acceptance_rate != 1.0:
                raise AssertionError(f"speculative 100%: {st}")
            if name == "0%" and st.accepted != 0:
                raise AssertionError(f"speculative 0%: {st}")
            if mode != "off" and st.spec_ticks == 0:
                raise AssertionError(f"speculative {name}: no verify tick")
            out.append(f"{name} {st.accepted}/{st.proposed} in {st.spec_ticks} verify + "
                       f"{st.plain_ticks} plain ticks" if mode != "off" else name)
        log(f"reference: speculative streams token-identical to the CPU's plain stream "
            f"(minitron smoke, float32, {'paged' if paged else 'contiguous'}, {kv_dtype} "
            f"pages{', W4A16 group 64' if kv_dtype != 'fp32' else ''}): " + "; ".join(out))
        gpu.shutdown()
        cpu.shutdown()


def stub_extra(cfg, B, seed, device):
    """The stub inputs ``cfg``'s forward takes, made on ``device`` from a
    numpy seed x STUB_SCALE (float32), or None: encoder frames (B,
    encoder_seq_len, d_model) or vision patches (B, n_image_tokens,
    vision_dim)."""
    import numpy as np
    import torch
    if cfg.is_encoder_decoder:
        shape, key = (B, cfg.encoder_seq_len, cfg.d_model), "frames"
    elif cfg.cross_attn_every:
        shape, key = (B, cfg.n_image_tokens, cfg.vision_dim), "vision"
    else:
        return None
    x = STUB_SCALE * np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return {key: torch.from_numpy(x).to(device)}


def training_reference_phase(torch, arch="minitron-8b",
                             must=("flash_attention", "flash_attention_bwd", "rmsnorm")):
    """The small float32 ``arch`` trains TRAIN_STEPS // 2 steps on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batches (batch 2 x seq 64, T = 63: ragged against the tiles and the
    SSD chunk; stub frames / patches from a numpy seed x STUB_SCALE, the
    vision gates at VISION_GATE so that the cross attention's dO is not
    zero): losses and params must agree, and every kernel in ``must``
    must launch on the card. An MoE config's routing is recorded on the
    card; where the CPU's float32 routing differs, the CPU run is made
    again with the card's routing pinned (``moe_routing``)."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten, tree_map
    from repro_torch.training import (AdamWConfig, SyntheticLMData, adamw_init,
                                      make_train_step)

    t0 = time.perf_counter()
    cfg = get_smoke_config(arch).replace(vocab_size=300, vocab_pad_to=64,
                                         compute_dtype="float32")
    model = build_model(cfg)
    oc = AdamWConfig(lr=1e-3, warmup_steps=5, decay_steps=10)     # the driver's defaults
    gpu = model.init(0, "cuda")
    if "cross" in gpu:
        gpu["cross"]["attn"]["gate"].fill_(VISION_GATE)
    cpu0 = tree_map(lambda t: t.to("cpu", copy=True), gpu)    # the step updates in place

    def run(params, dev):
        data = SyntheticLMData(cfg.vocab_size, 2, 64, seed=0)
        step = make_train_step(model, oc)
        opt, losses = adamw_init(params), []
        for i in range(3):
            batch = {"tokens": torch.from_numpy(data.next()["tokens"]).to(dev)}
            extra = stub_extra(cfg, 2, i, dev)
            if extra is not None:
                batch["extra"] = extra
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        return params, opt, losses

    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    routes = {"card": [], "cpu": []}
    with (moe_routing(routes["card"]) if cfg.n_experts else contextlib.nullcontext()):
        pg, _, lg = run(gpu, "cuda")
    launched = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    for name in must:
        if launched[name] <= 0:
            raise AssertionError(f"reference training ({arch}) did not launch {name}")
    pinned = ""
    with (moe_routing(routes["cpu"]) if cfg.n_experts else contextlib.nullcontext()):
        pc, oc_cpu, lc = run(tree_map(lambda t: t.clone(), cpu0), "cpu")
    if cfg.n_experts:
        differ = sum(not torch.equal(a.cpu(), b) for a, b in zip(routes["card"], routes["cpu"]))
        pinned = (f"; MoE routing: {differ} of {len(routes['card'])} router calls differ "
                  "card vs CPU")
        if differ:
            with moe_routing(routes["card"], replay=True):
                pc, oc_cpu, lc = run(tree_map(lambda t: t.clone(), cpu0), "cpu")
            pinned += ", so the CPU run was made again with the card's routing pinned"
    if not np.allclose(lg, lc, atol=TRAIN_LOSS_ATOL, rtol=0):
        raise AssertionError(f"training losses ({arch}) differ card vs CPU: {lg} vs {lc}")
    worst, beyond, n_w = 0.0, 0, 0
    for (path, a), (_, b), (_, nu) in zip(flatten(pg), flatten(pc), flatten(oc_cpu["nu"])):
        err = (a.cpu() - b).abs()
        vh = nu / (1 - oc.b2 ** 3)
        lim = TRAIN_PARAM_ATOL + 3 * oc.lr * torch.clamp(
            TRAIN_G_TOL / (vh.sqrt() + oc.eps), max=2.0)
        if bool((err > lim).any()):
            raise AssertionError(f"{arch} {'/'.join(path)}: card vs CPU params differ by up "
                                 f"to {(err - lim).max().item():.3e} beyond their bound")
        worst = max(worst, err.max().item())
        beyond += int((err > TRAIN_PARAM_ATOL).sum())
        n_w += err.numel()
    log(f"reference: small float32 {cfg.name} trained 3 steps (batch 2 x seq 64, T = 63) "
        f"on card and CPU: losses {[round(x, 6) for x in lg]} vs "
        f"{[round(x, 6) for x in lc]}; params max abs diff {worst:.3e}, {beyond} of "
        f"{n_w} weights beyond {TRAIN_PARAM_ATOL} (within lr * {TRAIN_G_TOL} / "
        f"(sqrt(vh) + eps) a step); card launches "
        f"{ {k: v for k, v in launched.items() if v} }{pinned} "
        f"({time.perf_counter() - t0:.1f} s)")


@contextlib.contextmanager
def moe_routing(record, replay=False):
    """Record every MoE call's top-k experts into ``record`` (a list, in
    call order), or with ``replay`` route each call to the experts
    recorded there, its gates taken from its own router probabilities at
    them (renormalized where the config says)."""
    from repro_torch.models import moe
    route = moe._route
    calls = iter(list(record)) if replay else None

    def pinned(xt, router, cfg, K):
        if calls is None:
            gates, idx = route(xt, router, cfg, K)
            record.append(idx)
            return gates, idx
        idx = next(calls)
        gates = (xt.float() @ router.float()).softmax(-1).gather(-1, idx)
        if cfg.router_renorm:
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return gates, idx

    moe._route = pinned
    try:
        yield
    finally:
        moe._route = route


def prefill_check(torch, hpc, label):
    """On a full-width dense system, a 250-token prompt through the
    whole-prompt prefill branch (flash_attention) and the chunked one
    (the plain chunk attention):
      * layer by layer from the same residual input (the chunked path's):
        each block's output within the bf16 tolerance, element by
        element, and the K/V each branch writes bit-equal;
      * end to end, model.prefill against model.prefill_chunk: finite
        logits, pos = 250, one kernel launch a layer, and the last logits
        within PREFILL_E2E_REL of max |logit| (the greedy token is
        reported: a random model's top two logits may sit closer). Two
        valid bf16 computations drift apart through 32 random layers by
        a few bf16 ulps of the largest logit, about the size of the
        element-wise bf16 tolerance, which is why that tolerance is held
        per layer; a masking fault moves the logits by O(their spread).
        For the MoE family the per-layer check holds the attention
        outputs, and the end-to-end one reruns the whole prompt on the
        chunked pass's experts (``moe_routing``): a bf16 ulp moves some
        tokens' top-k, which is a different function, not a rounding;
      * generate() at B = 1 (the contiguous cache): one decode_attention
        launch a layer a decode step, at this model's heads (granite-20b:
        G = 48).
    """
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.models import layers
    from repro_torch.models.lm import _layer
    model, params, cfg = hpc.model, hpc.params, hpc.cfg
    n = 250
    g = torch.Generator(device=hpc.device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=hpc.device)
    atol, rtol = TOL["bfloat16"]
    with torch.inference_mode():
        whole = model.init_cache(1, MAX_SEQ, hpc.device)
        chunk = model.init_cache(1, MAX_SEQ, hpc.device)
        x = layers.embed(toks, params["embed"], cfg)
        positions = torch.arange(n, device=hpc.device)
        worst = 0.0
        # (params, cache entry, MoE block?) of every layer: the leading
        # dense blocks of deepseek-v2-lite first
        stack = ([(params[f"dense{i}"], lambda c, i=i: model._dense_cache(c, i), False)
                  for i in range(cfg.first_dense_layers)]
                 + [(_layer(params["blocks"], i), lambda c, i=i: model._layer_cache(c, i),
                     True) for i in range(model.n_scan)])
        for i, (bp, lc, moe_block) in enumerate(stack):
            if cfg.n_experts:
                # MoE: the attention outputs are held, and both branches go
                # on through one MLP (a bf16 ulp may move a token's top-k)
                h = layers.rmsnorm(x, bp["ln1"], cfg)
                aw = model._attn(h, bp["attn"], positions=positions, cache_index=0,
                                 cache=lc(whole))
                ac = model._attn(h, bp["attn"], positions=positions, cache_index=0,
                                 chunked=True, cache=lc(chunk))
                worst = max(worst, check_close(f"prefill layer {i} attention", aw, ac,
                                               "bfloat16"))
                x = x + ac
                x = x + model._mlp(layers.rmsnorm(x, bp["ln2"], cfg), bp["mlp"], moe_block,
                                   True)
                continue
            yw = model._block(x, bp, positions=positions, cache_index=0, cache=lc(whole))
            yc = model._block(x, bp, positions=positions, cache_index=0, chunked=True,
                              cache=lc(chunk))
            worst = max(worst, check_close(f"prefill layer {i}", yw, yc, "bfloat16"))
            x = yc
        kv_keys = [k for k in whole if k != "pos"]
        for key in kv_keys:
            if not torch.equal(whole[key], chunk[key]):
                raise AssertionError(f"prefill branches wrote different {key} caches")
        del whole, chunk, x
        out, ms, routes = {}, {}, {}
        before = fa_k.launches
        for name in ("prefill", "prefill_chunk"):
            cache = model.init_cache(1, MAX_SEQ, hpc.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with moe_routing(routes.setdefault(name, [])):
                out[name] = getattr(model, name)(params, toks, cache)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        launched = fa_k.launches - before
        moe_note = ""
        if cfg.n_experts:
            # a bf16 ulp between the branches moves some tokens' top-k, and a
            # moved token's MoE output changes by O(1): the whole prompt
            # again on the chunked pass's experts, so the end-to-end bound
            # measures attention and numerics, not the router's ties
            moved = sum(int((a != b).any(-1).sum())
                        for a, b in zip(routes["prefill"], routes["prefill_chunk"]))
            free = (out["prefill"][0] - out["prefill_chunk"][0]).float().abs().max().item()
            with moe_routing(routes["prefill_chunk"], replay=True):
                out["prefill"] = model.prefill(params, toks,
                                               model.init_cache(1, MAX_SEQ, hpc.device))
            moe_note = (f"; MoE: {moved} of {n * len(routes['prefill'])} (token, layer) "
                        f"routings differ between the branches, last logits {free:.4e} "
                        f"apart with each its own routing, held below with the chunked "
                        f"pass's")
    (lw, cw), (lc, cc) = out["prefill"], out["prefill_chunk"]
    top = lc.float().abs().max().item()
    err = (lw - lc).float().abs().max().item()
    kv_err = max((cw[k] - cc[k]).float().abs().max().item() for k in kv_keys)
    same_token = bool((lw.argmax(-1) == lc.argmax(-1)).all())
    if (launched != cfg.n_layers or cw["pos"] != n or not bool(lw.isfinite().all())
            or not err <= PREFILL_E2E_REL * top):
        raise AssertionError(f"whole-prompt prefill vs chunked: {launched} launches, pos "
                             f"{cw['pos']}, same greedy token {same_token}, last-logit "
                             f"max abs diff {err:.4e} (bound {PREFILL_E2E_REL * top:.4e})")
    before, steps = dec_k.launches, 4
    res = hpc.generate("Explain the dual-channel relay.", max_new_tokens=steps + 1,
                       stop_on_eos=False)
    dec = dec_k.launches - before
    if dec != cfg.n_layers * steps or res.n_generated != steps + 1:
        raise AssertionError(f"{label} generate(): {res.n_generated} tokens, {dec} "
                             f"decode_attention launches for {cfg.n_layers} layers")
    width, heads = cfg.head_dim, (cfg.n_heads, cfg.n_kv_heads)
    if cfg.use_mla:     # K = [K_nope, K_rope] over every head, V padded to it
        width, heads = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, (cfg.n_heads,) * 2
    log(f"{label} path generate() at B = 1: {res.n_generated} tokens, {dec} "
        f"decode_attention launches ({cfg.n_layers} a decode step) at {heads[0]}/"
        f"{heads[1]} heads of {width} (G = {heads[0] // heads[1]}, "
        f"{dec_k.heads_per_block(heads[0] // heads[1])} query heads a block)")
    held = "attention outputs" if cfg.n_experts else "block outputs"
    log(f"{label} path prefill check: {n} tokens, {cfg.n_layers} layers; layer by layer "
        f"from one input: {held} max abs diff {worst:.3e} (bf16 atol {atol} + rtol "
        f"{rtol}), K/V caches bit-equal; end to end: prefill ({launched} flash_attention "
        f"launches, {ms['prefill']:.1f} ms) vs prefill_chunk ({ms['prefill_chunk']:.1f} "
        f"ms): same greedy token {same_token}, last logits max abs diff {err:.4e} (bound "
        f"{PREFILL_E2E_REL} x max |logit| {top:.3f} = {PREFILL_E2E_REL * top:.4e}; the "
        f"bf16 tolerance of max |logit| would be {atol + rtol * top:.4e}), K/V max abs "
        f"diff {kv_err:.4e}{moe_note}")


def crossattn_served_check(stats, hpc, label, must):
    """The HPC tier of a cross-attention path served its requests through
    ``must``'s kernels, on the contiguous splice path (a function of its
    own, so that no reference to the batcher outlives the path)."""
    idle = [k for k in must if stats["during"][k] <= 0]
    if idle:
        raise AssertionError(f"{label} path: {idle} not launched while serving")
    hb = hpc.scheduler.batcher
    if hb.paged:
        raise AssertionError(f"{label} path: served by the paged path, not the splice path")
    log(f"{label} path: served through the contiguous splice path, stateful pool of "
        f"{hb.pool.capacity} pages, {hb.pool._state_bytes / 1e6:.1f} MB of cross K/V a page "
        f"snapshot; launches while serving {json.dumps(stats['during'])}")


def extras_check(torch, hpc, label):
    """On a full-width cross-attention system (whisper-medium, or
    llama-3.2-vision-11b with its cross gates set to VISION_GATE for the
    check): the stub frontend's input drawn from a seeded generator at
    STUB_SCALE (whisper's encoder_seq_len frames of d_model, the vision
    model's n_image_tokens patches of vision_dim) and 252 tokens.
    forward(tokens, extra) is the reference; the first 250 tokens go
    through prefill(extra) and, on a fresh cache, through page-aligned
    prefill_chunk pieces (the extra on the first), each then two
    decode_steps teacher-forced on tokens 250 and 251. Every one of the
    three logit rows is held to the forward's within PREFILL_E2E_REL of
    max |logit| (bf16 through every layer, bounded as prefill_check bounds
    its own) and to its greedy token wherever the forward's top two
    logits are further apart than that bound. prefill's flash_attention
    launches are counted: whisper's encoder and cross attention a layer
    each beside the causal prefill a layer, the vision model's causal
    prefill a layer and one cross block every cross_attn_every layers."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.serving.pagepool import chunk_plan
    model, params, cfg = hpc.model, hpc.params, hpc.cfg
    n = 250
    g = torch.Generator(device=hpc.device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, n + 2), generator=g, device=hpc.device)
    if cfg.is_encoder_decoder:
        key, shape = "frames", (1, cfg.encoder_seq_len, cfg.d_model)
        want_flash = cfg.n_encoder_layers + 2 * cfg.n_layers
    else:
        key, shape = "vision", (1, cfg.n_image_tokens, cfg.vision_dim)
        want_flash = cfg.n_layers + model.n_cross
    extra = {key: (STUB_SCALE * torch.randn(shape, generator=g, device=hpc.device))
             .to(cfg.cdtype())}
    gate = params["cross"]["attn"]["gate"] if "cross" in params else None
    if gate is not None:
        saved = gate.clone()
        gate.fill_(VISION_GATE)
    rows, ms = {}, {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = model.forward(params, toks, extra)[0, n - 1:]
        torch.cuda.synchronize()
        ms["forward"] = (time.perf_counter() - t0) * 1e3
        for name in ("prefill", "prefill_chunk"):
            cache = model.init_cache(1, MAX_SEQ, hpc.device)
            before = (fa_k.launches, dec_k.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "prefill":
                last, cache = model.prefill(params, toks[:, :n], cache, extra)
            else:
                off = 0
                for i, m in enumerate(chunk_plan(0, n, PAGE)):
                    last, cache = model.prefill_chunk(params, toks[:, off:off + m], cache,
                                                      extra if i == 0 else None)
                    off += m
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            launched = fa_k.launches - before[0]
            got = [last]
            for t in (n, n + 1):
                logits, cache = model.decode_step(params, toks[:, t:t + 1], cache)
                got.append(logits)
            rows[name] = (torch.cat(got).float(), launched, dec_k.launches - before[1])
    if gate is not None:
        gate.copy_(saved)
    full = full.float()
    top = full.abs().max().item()
    bound = PREFILL_E2E_REL * top
    top2 = full.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > bound     # a greedy token the bound cannot move
    notes = []
    for name, (got, launched, dec) in rows.items():
        err = (got - full).abs().max().item()
        same = got.argmax(-1) == full.argmax(-1)
        if (not bool(got.isfinite().all()) or not err <= bound
                or not bool((same | ~clear).all())):
            raise AssertionError(f"{label} extras check, {name}: logits max abs diff "
                                 f"{err:.4e} (bound {bound:.4e}), same greedy tokens "
                                 f"{same.tolist()} (clear of the bound {clear.tolist()})")
        if name == "prefill" and launched != want_flash:
            raise AssertionError(f"{label} extras check: prefill launched flash_attention "
                                 f"{launched} times, not {want_flash}")
        if dec != 2 * cfg.n_layers:
            raise AssertionError(f"{label} extras check, {name}: {dec} decode_attention "
                                 f"launches in 2 decode steps of {cfg.n_layers} layers")
        notes.append(f"{name} ({ms[name]:.1f} ms, {launched} flash_attention launches) + 2 "
                     f"decode_steps: logits max abs diff {err:.4e}, same greedy tokens "
                     f"{same.tolist()}")
    log(f"{label} path extras check: {key} {tuple(shape)} at x{STUB_SCALE}"
        f"{f', cross gates {VISION_GATE}' if gate is not None else ''}, {n} + 2 tokens "
        f"against forward ({ms['forward']:.1f} ms); bound {PREFILL_E2E_REL} x max |logit| "
        f"{top:.3f} = {bound:.4e}; greedy tokens clear of it {clear.tolist()}; "
        + "; ".join(notes))


def training_phase(torch, arch, n_layers=TRAIN_LAYERS, seq=TRAIN_SEQ,
                   must=("flash_attention", "flash_attention_bwd", "rmsnorm")):
    """``arch`` at full width cut to ``n_layers`` layers trains TRAIN_STEPS
    steps of the synthetic stream (batch TRAIN_BATCH x ``seq`` tokens, T =
    seq - 1) through make_train_step, with the stub frames / patches its
    forward takes (seeded, STUB_SCALE; the vision gates at VISION_GATE);
    the last step runs under the profiler. The kernels in ``must`` must
    launch; the peak stays under the card's memory. Returns the kernel
    launches of the path and its figures."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten
    from repro_torch.training import AdamWConfig, SyntheticLMData, make_train_step
    from repro_torch.training.train import init_train_state

    t_start = time.perf_counter()
    cfg = get_config(arch, n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(model, 0, "cuda")
    if "cross" in params:
        params["cross"]["attn"]["gate"].fill_(VISION_GATE)
    n_params = sum(t.numel() for _, t in flatten(params))
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = make_train_step(model, AdamWConfig(**TRAIN_OC))
    data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, seq)
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        batch = {"tokens": torch.from_numpy(data.next()["tokens"]).cuda()}
        extra = stub_extra(cfg, TRAIN_BATCH, i, "cuda")
        if extra is not None:
            batch["extra"] = extra
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if i == TRAIN_STEPS - 1 else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"training {arch} step {i + 1}: loss {losses[-1]:.4f} grad_norm "
            f"{float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} wall {walls[-1]:.1f} ms"
            + (" (profiled)" if i == TRAIN_STEPS - 1 else ""))
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    peak = torch.cuda.max_memory_allocated()
    evs = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -getattr(e, "self_device_time_total", 0))[:10]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training {arch}: losses {losses}: not finite, or not falling")
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"training path {arch}: kernel {name} was not launched")
    if peak > CARD_BYTES:
        raise AssertionError(f"training path {arch}: peak {peak / 1e9:.2f} GB, over the "
                             f"card's {CARD_BYTES / 1e9:.0f} GB")
    steady = sorted(walls[1:-1])[len(walls[1:-1]) // 2]
    tokens = TRAIN_BATCH * (seq - 1)
    what = "" if extra is None else " over " + " ".join(
        f"{tuple(t.shape)} stub {k}" for k, t in extra.items())
    log(f"training path: {arch} at full width, {n_layers} of "
        f"{get_config(arch).n_layers} layers, "
        f"{n_params / 1e9:.3f} B params (float32, bf16 compute, remat), "
        f"{state_gb:.2f} GB of params and moments; batch {TRAIN_BATCH} x seq {seq}{what}, "
        f"AdamW peak lr {TRAIN_OC['lr']} warmup {TRAIN_OC['warmup_steps']}: losses "
        f"{[round(x, 4) for x in losses]}; step wall median {steady:.1f} ms over steps "
        f"2-{TRAIN_STEPS - 1} (first {walls[0]:.1f} ms), {tokens / steady * 1e3:.0f} tokens/s; "
        f"profiled step {walls[-1]:.1f} ms wall, {dev_ms:.1f} ms device -> busy "
        f"{dev_ms / walls[-1] * 100:.0f}%; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB); {time.perf_counter() - t_start:.1f} s")
    for e in top:
        log(f"  {getattr(e, 'self_device_time_total', 0) / 1e3:8.3f} ms "
            f"{e.count:5d} calls  {e.key[:90]}")
    log(f"training path ({arch}) launches: {json.dumps(launches)}")
    out = dict(step_ms=steady, tok_s=tokens / steady * 1e3, dev_ms=dev_ms,
               busy=dev_ms / walls[-1], peak_gib=peak / 2**30, losses=losses)
    if "ssd" in must:
        # the profiled step's own ssd work: the kernel forward (its first
        # pass and remat's recompute) and the gradient, autograd of the
        # plain version recomputed (the _SSD node's backward)
        f_ms, n_f = device_ms_under(prof, "_SSD")
        b_ms, n_b = device_ms_under(prof, "autograd::engine::evaluate_function: _SSDBackward",
                                    skip=("_SSD",))
        log(f"training path ({arch}) ssd in the profiled step: {n_f} kernel forwards "
            f"{f_ms:.2f} ms of device time ({f_ms / dev_ms:.1%}); {n_b} gradients (plain "
            f"recompute and autograd) {b_ms:.2f} ms ({b_ms / dev_ms:.1%} of the step's "
            f"{dev_ms:.1f} ms)")
        if n_b == 0:
            raise AssertionError(f"training path {arch}: no ssd gradient went through _SSD")
        if b_ms > 0:        # else the profiler linked no kernel to the node: not measured
            out.update(ssd_fwd_ms=f_ms, ssd_grad_ms=b_ms, ssd_grad_share=b_ms / dev_ms)
    del params, opt, m, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def device_ms_under(prof, name, skip=()):
    """(device ms, count) of the kernels launched under the profiled host
    events called ``name`` and their children, leaving out the subtrees of
    events called in ``skip``."""
    def under(e):
        if e.name in skip:
            return 0
        return sum(k.duration for k in e.kernels) + sum(under(c) for c in e.cpu_children)
    evs = [e for e in prof.events() if e.name == name]
    return sum(under(e) for e in evs) / 1e3, len(evs)


def driver_phase(torch):
    """The training driver on the card, for its default arch (the JAX
    package's, xlstm-125m: its smoke config) and for minitron-8b named
    explicitly, the two side by side: 6 steps with a checkpoint every 3,
    then again to 8, which must resume at step 6 with the data stream
    where it stopped."""
    import shutil
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {"xlstm-smoke": [], "minitron-smoke": ["--arch", "minitron-8b"]}
    errors, logs = [], {}

    def drive(name, extra):
        ckpt = ROOT / "build" / f"train_ckpt_{name}"
        shutil.rmtree(ckpt, ignore_errors=True)
        outs = []
        for steps in (6, 8):
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                                "--device", "cuda", "--steps", str(steps), "--ckpt-every",
                                "3", "--ckpt-dir", str(ckpt), *extra], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=600)
            if p.returncode != 0:
                errors.append(f"launch.train {extra} --steps {steps} failed:\n{p.stdout}\n"
                              f"{p.stderr}")
                return
            outs.append(p.stdout)
            logs.setdefault(name, []).append(
                f"driver {' '.join(extra) or '(default arch)'} --steps {steps} "
                f"({time.perf_counter() - t0:.1f} s): "
                + " | ".join(p.stdout.strip().splitlines()))
        man = json.loads((ckpt / "step_000000008" / "MANIFEST.json").read_text())
        if (f"arch={name}" not in outs[0] or "resumed from checkpoint step 6" not in outs[1]
                or "resumed" in outs[0] or man["aux"]["data"]["step"] != 8
                or not (ckpt / "step_000000006" / "MANIFEST.json").exists()):
            errors.append(f"the driver ({name}) did not resume at step 6: {outs[1]!r}, "
                          f"manifest aux {man['aux']}")
        shutil.rmtree(ckpt, ignore_errors=True)

    threads = [threading.Thread(target=drive, args=item) for item in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for lines in logs.values():
        for line in lines:
            log(line)
    if errors:
        raise AssertionError("\n".join(errors))


def distributed_phase(torch, card):
    """The distribution on the card's one-device mesh: make_local_mesh()
    gives a (1, 1) NCCL mesh; full-width minitron-8b cut to TRAIN_LAYERS
    (float32 params, bf16 compute) is initialised, saved with
    CheckpointManager and brought back onto the mesh by elastic_restore;
    DIST_STEPS train steps run there under axis_rules(DEFAULT_RULES) with
    grad_shardings, beside the same steps on plain tensors first: losses
    within TRAIN_LOSS_ATOL, updated params within TRAIN_PARAM_ATOL, and
    flash_attention, its backward and rmsnorm launched as many times (the
    local shards are the whole tensors). Then deepseek-v2-lite-16b at full
    width cut to 2 layers (the dense first block and one MoE block, bf16):
    the moe_dispatch="shard_map" forward on the mesh against the gspmd
    forward on plain tensors, routing indices equal and logits within the
    bf16 tolerance. Then analyze_step counts the minitron step's FLOPs on
    meta tensors, printed beside analytic_costs and the plain step's
    device time. Returns the mesh runs' kernel launches."""
    import shutil

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.distributed.fault import elastic_restore, shardings_for_mesh
    from repro_torch.distributed.sharding import DEFAULT_RULES, axis_rules, use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import PEAK_FLOPS as H100_BF16, analytic_costs, \
        analyze_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, shape_tree
    from repro_torch.models.common import flatten
    from repro_torch.training import (AdamWConfig, CheckpointManager, SyntheticLMData,
                                      adamw_init, make_train_step)

    t_start = time.perf_counter()
    mesh = make_local_mesh()
    if tuple(mesh.shape) != (1, 1) or dist.get_backend() != "nccl":
        raise AssertionError(f"make_local_mesh() gave {mesh} over {dist.get_backend()}")
    cfg = get_config("minitron-8b", n_layers=TRAIN_LAYERS)
    model = build_model(cfg)
    data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    batches = [{"tokens": torch.from_numpy(data.next()["tokens"]).cuda()}
               for _ in range(DIST_STEPS)]
    ckpt_dir = ROOT / "build" / "dist_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(str(ckpt_dir), keep_last=1)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    t0 = time.perf_counter()
    ckpt.save(0, {"params": params}, aux={"seed": 0})
    save_s = time.perf_counter() - t0
    ckpt_gb = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy")) / 1e9

    def run(step, ps, opt, label, ctx):
        for mod, attr in counters().values():
            setattr(mod, attr, 0)
        losses, walls, prof = [], [], None
        with ctx:
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                last = i == len(batches) - 1
                with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                      if last else contextlib.nullcontext()) as pr:
                    t0 = time.perf_counter()
                    ps, opt, m = step(ps, opt, batch)
                    losses.append(float(m["loss"]))
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                if last:
                    prof = pr
        dev = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
        log(f"distributed phase, {label}: losses {losses}; step walls "
            f"{[round(w, 1) for w in walls]} ms; last step {dev:.1f} ms device time "
            f"(profiled); launches {json.dumps(launches)}")
        return ps, opt, losses, walls, dev, launches

    oc = AdamWConfig(**TRAIN_OC)
    params, opt, plain_losses, plain_walls, plain_dev, plain_launch = run(
        make_train_step(model, oc), params, adamw_init(params), "plain tensors",
        contextlib.nullcontext())
    if plain_dev <= 0:
        raise AssertionError("the profiler saw no device time in the plain step")
    plain_final = {path: t.detach().cpu() for path, t in flatten(params)}
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dparams, aux, step0 = elastic_restore(ckpt, model, mesh)
    restore_s = time.perf_counter() - t0
    if step0 != 0 or aux != {"seed": 0}:
        raise AssertionError(f"elastic_restore gave step {step0}, aux {aux}")
    places = {tuple(t.placements) for _, t in flatten(dparams)}
    shardings = shardings_for_mesh(model, mesh)
    on_mesh = contextlib.ExitStack()
    on_mesh.enter_context(axis_rules(DEFAULT_RULES))
    on_mesh.enter_context(use_mesh(mesh))
    dparams, dopt, mesh_losses, mesh_walls, mesh_dev, mesh_launch = run(
        make_train_step(model, oc, grad_shardings=shardings), dparams, adamw_init(dparams),
        "(1, 1) mesh, DTensor params", on_mesh)
    card_arg_bytes = dryrun.local_bytes((dparams, dopt, batches[-1]))
    loss_err = max(abs(a - b) for a, b in zip(plain_losses, mesh_losses))
    param_err = max(float((t.to_local() - plain_final[path].to(t.device)).abs().max())
                    for path, t in flatten(dparams))
    peak = torch.cuda.max_memory_allocated()
    del dparams, dopt, plain_final
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"distributed phase: {card}: minitron-8b at full width, {TRAIN_LAYERS} layers "
        f"(float32 params, bf16 compute), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: "
        f"checkpoint {ckpt_gb:.2f} GB saved in {save_s:.1f} s, elastic_restore onto "
        f"{mesh} in {restore_s:.1f} s (placements {sorted(map(str, places))}); "
        f"{DIST_STEPS} steps: plain losses {plain_losses}, mesh losses {mesh_losses}: max "
        f"|diff| {loss_err:.3e} (tolerance {TRAIN_LOSS_ATOL}); updated params max |diff| "
        f"{param_err:.3e} (tolerance {TRAIN_PARAM_ATOL}); step walls plain "
        f"{plain_walls} ms, mesh {mesh_walls} ms; last step device time plain "
        f"{plain_dev:.1f} ms, mesh {mesh_dev:.1f} ms; peak {peak / 2**30:.2f} GiB")
    if loss_err > TRAIN_LOSS_ATOL or param_err > TRAIN_PARAM_ATOL:
        raise AssertionError("the mesh train step differs from the plain one")
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm"):
        if mesh_launch[name] <= 0 or mesh_launch[name] != plain_launch[name]:
            raise AssertionError(f"distributed phase: {name} launched {mesh_launch[name]} "
                                 f"times on the mesh, {plain_launch[name]} on plain tensors")
    if peak > CARD_BYTES:
        raise AssertionError(f"distributed phase: peak {peak / 1e9:.2f} GB")

    # the step's FLOPs on meta tensors (the plain versions stand in for the
    # kernels), beside the closed form and the measured device time
    meta = shape_tree(model.param_defs(), cfg.pdtype())

    def grad_step(ps, batch):
        leaves = [t.requires_grad_() for _, t in flatten(ps)]
        loss, _ = model.loss(ps, batch)
        return torch.autograd.grad(loss, leaves)

    t0 = time.perf_counter()
    counted = analyze_step(grad_step, meta, {"tokens": torch.empty(
        (TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64, device="meta")})
    analyze_s = time.perf_counter() - t0
    closed = analytic_costs(cfg, ShapeCell("train", TRAIN_SEQ - 1, TRAIN_BATCH, "train"))
    achieved = counted["flops"] / (plain_dev / 1e3)
    log(f"distributed phase: {card}: analyze_step (meta tensors, {analyze_s:.1f} s) counts "
        f"{counted['flops'] / 1e12:.4f} TFLOP of matmuls in the minitron step (forward, "
        f"remat recompute, backward; the plain attention's full S x S products); "
        f"analytic_costs for (B {TRAIN_BATCH}, S {TRAIN_SEQ - 1}, L {TRAIN_LAYERS}) "
        f"{closed['model_flops_global'] / 1e12:.4f} TFLOP (6 N D + causal attention); "
        f"ratio {counted['flops'] / closed['model_flops_global']:.4f}; over the plain step's "
        f"{plain_dev:.1f} ms of device time: {achieved / 1e12:.1f} TFLOP/s counted, "
        f"{closed['model_flops_global'] / (plain_dev / 1e3) / 1e12:.1f} TFLOP/s closed form, "
        f"{achieved / H100_BF16:.1%} / "
        f"{closed['model_flops_global'] / (plain_dev / 1e3) / H100_BF16:.1%} of the "
        f"{H100_BF16 / 1e12:.0f} TFLOP/s bf16 peak; collectives {counted['collective_bytes']}")
    if counted["flops"] <= 0:
        raise AssertionError("analyze_step counted no FLOPs")

    dryrun_anchor(torch, card, mesh, counted["flops"], card_arg_bytes, mesh_dev, peak)
    moe_launch = shard_map_moe_check(torch, mesh)
    dist.destroy_process_group()
    log(f"distributed phase done in {time.perf_counter() - t_start:.1f} s")
    return {k: mesh_launch[k] + moe_launch[k] for k in mesh_launch}


def dryrun_anchor(torch, card, mesh, counted_flops, card_arg_bytes, mesh_dev_ms, peak):
    """The dry-run's anchor on the card: its own step builder
    (``dryrun.cell_record``) on the card's (1, 1) NCCL mesh over meta
    tensors makes the record of the distributed phase's cell (minitron-8b
    at full width cut to TRAIN_LAYERS, batch TRAIN_BATCH x TRAIN_SEQ,
    accumulation 1). Its argument bytes must equal what the card held for
    params, AdamW state and batch, to the byte, and its FLOPs the phase's
    own analyze_step count; its roofline bound is printed beside the
    measured device time of the mesh step, as a ratio with no gate; the
    card's peak less the arguments over its mem_temp_bytes lies in
    ANCHOR_TEMP_BAND. Then
    the analyzer must count the autograd all-to-all that the shard_map MoE
    dispatch issues as one all-to-all on the card's NCCL group, whatever
    this torch names its op."""
    import torch.distributed._functional_collectives as funcol
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import analyze_step

    cell = ShapeCell("distributed phase", TRAIN_SEQ - 1, TRAIN_BATCH, "train")
    cfg = dryrun.cell_config("minitron-8b", "train", {"n_layers": TRAIN_LAYERS})
    t0 = time.perf_counter()
    rec = dryrun.cell_record("minitron-8b", cfg, cell, mesh, "1x1",
                             dryrun.rules_for(cfg, cell, mesh), accum_steps=1)
    walk_s = time.perf_counter() - t0
    bound_ms = rec["roofline"]["step_time_bound_s"] * 1e3
    log(f"dry-run anchor: {card}: the dry-run's record of the distributed phase's cell "
        f"on the (1, 1) NCCL mesh over meta tensors ({walk_s:.1f} s): mem_argument_bytes "
        f"{rec['mem_argument_bytes']} (the card held {card_arg_bytes} for params, AdamW "
        f"state and batch); hlo_flops_per_device {rec['hlo_flops_per_device']:.1f} "
        f"(analyze_step of the phase: {counted_flops:.1f}); mem_output_bytes "
        f"{rec['mem_output_bytes']}, mem_temp_bytes {rec['mem_temp_bytes']}; roofline on the "
        f"H100 data sheet: {rec['roofline']['bottleneck']}, step_time_bound_s "
        f"{rec['roofline']['step_time_bound_s']:.6f} beside the mesh step's measured "
        f"{mesh_dev_ms:.1f} ms of device time: bound / measured "
        f"{bound_ms / mesh_dev_ms:.4f}; collectives {rec['collective_bytes_by_kind']}")
    if rec["mem_argument_bytes"] != card_arg_bytes:
        raise AssertionError("the dry-run's argument bytes differ from the card's")
    if rec["hlo_flops_per_device"] != counted_flops:
        raise AssertionError("the dry-run's FLOPs differ from the phase's count")
    temp = rec["mem_temp_bytes"]
    if temp is not None:
        ratio = (peak - card_arg_bytes) / temp
        log(f"dry-run anchor: {card}: the card's peak {peak} less the arguments "
            f"{card_arg_bytes} is {peak - card_arg_bytes} bytes; the walk's MemTracker "
            f"peak (mem_temp_bytes) {temp}: measured / walked {ratio:.4f} (band "
            f"{ANCHOR_TEMP_BAND})")
        if not ANCHOR_TEMP_BAND[0] <= ratio <= ANCHOR_TEMP_BAND[1]:
            raise AssertionError("the card's temp memory is outside the anchor's band")

    seen = []

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    def a2a():
        y = funcol.all_to_all_single_autograd(torch.ones(4, 8, device="cuda"), None, None,
                                              (mesh, 1))
        return y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y

    with Names():
        a2a()
    got = analyze_step(a2a)
    log(f"dry-run anchor: torch {torch.__version__}: funcol.all_to_all_single_autograd "
        f"dispatches {sorted(set(seen))}; analyze_step counts {got['collective_op_counts']}, "
        f"bytes {got['collective_bytes']}")
    if got["collective_op_counts"]["all-to-all"] != 1 or \
            got["collective_bytes"]["all-to-all"] != 4 * 8 * 4:
        raise AssertionError("analyze_step does not count the autograd all-to-all once")
    return rec


def dryrun_phase(card):
    """The dry-run's entry points on the fake worlds, no card needed: each
    cell of DRYRUN_CELLS is a ``python -m repro_torch.launch.dryrun``
    process and ``python -m repro_torch.launch.perf`` one more (in a
    temporary working directory), all started together and killed at
    DRYRUN_WALL_S. A non-zero exit or a record with ``"ok": false`` fails
    the phase; each record's bound and collectives are printed."""
    import shutil
    import tempfile

    t_start = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        out = tmp / f"{arch}_{shape}.jsonl"
        runs.append(([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                      "--shape", shape, "--mesh", mesh, "--out", str(out)], ROOT, out))
    (tmp / "perf").mkdir()
    runs.append(([sys.executable, "-m", "repro_torch.launch.perf"], tmp / "perf",
                 tmp / "perf" / "results" / "optimized.jsonl"))
    procs = [subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd, cwd, _ in runs]
    logs, failed = [], []
    try:
        for p in procs:
            left = max(1.0, DRYRUN_WALL_S - (time.perf_counter() - t_start))
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        failed.append(f"not done within {DRYRUN_WALL_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = []
    for (cmd, _, out), p, text in zip(runs, procs, logs + [""] * (len(runs) - len(logs))):
        got = [json.loads(line) for line in out.read_text().splitlines()] \
            if out.exists() else []
        if p.returncode != 0 or not got or not all(r.get("ok") for r in got):
            failed.append(f"{' '.join(cmd[2:])}: exit {p.returncode}, "
                          f"{len(got)} records\n{text[-3000:]}")
        recs += got
    for r in recs:
        if not r.get("ok"):
            continue
        rf = r["roofline"]
        log(f"dry-run: {r.get('tag', r['arch'] + '/' + r['shape'])} on {r['mesh']}: "
            f"bound {rf['bottleneck']}, step_time_bound_s {rf['step_time_bound_s']:.6g}, "
            f"mfu_bound {rf['mfu_bound']:.4f}, hlo_flops_per_device "
            f"{r['hlo_flops_per_device']:.6g}, collective bytes {r['collective_bytes_by_kind']}"
            f", lower_s {r['lower_s']}, scaled {json.dumps(r['scaled'])} (analysis on the "
            f"H100 data sheet, not a measurement)")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"dry-run phase ({card}'s host): {len(recs)} records from {len(runs)} processes in "
        f"{time.perf_counter() - t_start:.1f} s")
    if failed:
        raise AssertionError("dry-run phase failed:\n" + "\n".join(failed))


def shard_map_moe_check(torch, mesh):
    """deepseek-v2-lite-16b at full width cut to 2 layers (the dense first
    block and one MoE block, bf16): the moe_dispatch="shard_map" forward
    on ``mesh`` against the gspmd forward on plain tensors; routing
    indices equal, logits within the bf16 tolerance, and flash_attention
    and rmsnorm launched as many times in each (the counts set to 0 just
    before each forward). Returns the mesh forward's kernel launches."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import shardings_for_mesh
    from repro_torch.distributed.sharding import DEFAULT_RULES, axis_rules, use_mesh
    from repro_torch.models import build_model, moe as moe_mod
    from repro_torch.models.common import tree_map
    from repro_torch.training import SyntheticLMData

    mcfg = get_config("deepseek-v2-lite-16b").replace(
        **full_width("deepseek-v2-lite-16b", n_layers=2))
    mmodel = build_model(mcfg)
    mparams = mmodel.init(0)
    toks = torch.from_numpy(SyntheticLMData(mcfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
                            .next()["tokens"]).cuda()[:, :-1]
    plain_route, sm_route = [], []
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    with torch.no_grad(), moe_routing(plain_route):
        want = mmodel.forward(mparams, toks)
    plain_launch = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    sm_model = build_model(mcfg.replace(moe_dispatch="shard_map"))
    dmp = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), mparams,
                   shardings_for_mesh(sm_model, mesh, dtype=mcfg.pdtype()))
    inner, sm_calls = moe_mod.moe_mlp_shard_map, []

    def counted_sm(*a, **k):
        y = inner(*a, **k)
        sm_calls.append(y is not None)
        return y

    moe_mod.moe_mlp_shard_map = counted_sm
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    try:
        with torch.no_grad(), moe_routing(sm_route), axis_rules(DEFAULT_RULES), \
                use_mesh(mesh):
            got = sm_model.forward(dmp, toks).to_local()
    finally:
        moe_mod.moe_mlp_shard_map = inner
    moe_launch = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    same = len(plain_route) == len(sm_route) and all(
        torch.equal(a, b) for a, b in zip(plain_route, sm_route))
    err = check_close("deepseek-v2-lite (2 layers) shard_map vs gspmd logits", got, want,
                      "bfloat16")
    log(f"distributed phase: deepseek-v2-lite-16b at full width, 2 layers (bf16), "
        f"{tuple(toks.shape)} tokens: shard_map dispatch ran {sum(sm_calls)} of "
        f"{len(sm_calls)} MoE blocks, routing indices equal {same}, logits max |diff| "
        f"{err:.3e}; launches gspmd {json.dumps(plain_launch)}, shard_map on the mesh "
        f"{json.dumps(moe_launch)}")
    if not (sm_calls and all(sm_calls)) or not same:
        raise AssertionError("the shard_map MoE forward did not run, or routed otherwise")
    for name in ("flash_attention", "rmsnorm"):
        if moe_launch[name] <= 0 or moe_launch[name] != plain_launch[name]:
            raise AssertionError(f"deepseek-v2-lite: {name} launched {moe_launch[name]} "
                                 f"times on the mesh, {plain_launch[name]} in gspmd")
    del mparams, dmp, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return moe_launch


def rolling_reference_phase(torch):
    """Rolling windows of the small float32 minitron on the card against
    the CPU with the same weights: a greedy prompt that rolls while it
    prefills and a seeded one that rolls while it decodes give the same
    tokens, roll counts, pool high-water and spans handed to the
    summarizer, over float32 pages and over int8 pages with W4A16
    weights; and speculative n-gram decoding under the window equals
    plain decoding under it, on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import (ContinuousBatcher, GenerationParams, Request,
                                     ServingEngine, WindowPolicy)
    from repro_torch.serving.quantize import quantize_mlp_tree

    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64,
                                                  compute_dtype="float32")
    pol = WindowPolicy(sink_pages=1, window_pages=2, roll_pages=1)
    dense = ServingEngine(cfg, max_seq=96, device="cuda").params
    seeded = GenerationParams(max_tokens=70, temperature=0.9, seed=7)

    def serve(eng, spec="off"):
        spans = []
        submit = eng.span_summarizer.submit
        eng.span_summarizer.submit = lambda rid, ids, f=submit: (
            spans.append((rid, list(ids))), f(rid, ids))
        eng.speculative = spec
        cb = ContinuousBatcher(eng, slots=2, max_seq=96, prefix_pages=24)
        eng.speculative = "off"
        if cb.window is not pol or cb.spec_mode != spec:
            raise AssertionError(f"rolling reference: window {cb.window}, spec {cb.spec_mode}")
        done = {}
        for rid, ids, gp in (("greedy", list(range(2, 102)), None),
                             ("seeded", eng.tokenizer.encode("rolling on the card"), seeded)):
            cb.submit(Request(rid=rid, prompt_ids=ids, max_new_tokens=70, params=gp,
                              on_done=lambda r: done.update(
                                  {r.rid: (list(r.output_ids), r._rolls)})))
        cb.run_until_drained()
        eng.span_summarizer.submit = submit
        return done, cb.rolls, cb.pool_stats().high_water, sorted(spans), cb.spec_stats

    for kv_dtype in ("fp32", "int8"):
        params = dense if kv_dtype == "fp32" else quantize_mlp_tree(dense, group_size=64)
        gpu = ServingEngine(cfg, max_seq=96, device="cuda", params=params, kv_dtype=kv_dtype,
                            window_policy=pol)
        cpu = ServingEngine(cfg, max_seq=96, device="cpu", kv_dtype=kv_dtype,
                            window_policy=pol, params=tree_map(lambda t: t.cpu(), params))
        card, host = serve(gpu), serve(cpu)
        if card[:4] != host[:4]:
            raise AssertionError(f"rolling {kv_dtype}: card {card[:3]} vs CPU {host[:3]}")
        done, rolls, hw, spans, _ = card
        if done["greedy"][1] < 3 or done["seeded"][1] < 2 or hw > 2 * pol.cap_pages:
            raise AssertionError(f"rolling {kv_dtype}: rolls {rolls}, high-water {hw}")
        spec = serve(gpu, "ngram")
        if spec[0] != done or spec[4].spec_ticks == 0:
            raise AssertionError(f"rolling {kv_dtype}: speculation under the window "
                                 f"differs from plain: {spec[0]} vs {done}")
        gpu.shutdown()
        cpu.shutdown()
        log(f"reference: rolling windows (minitron smoke, float32, {kv_dtype} pages"
            f"{', W4A16 group 64' if kv_dtype != 'fp32' else ''}, cap {pol.cap_pages} pages): "
            f"greedy and seeded streams token-identical card vs CPU with {rolls} rolls "
            f"({done['greedy'][1]} + {done['seeded'][1]}), high-water {hw} pages and "
            f"{len(spans)} spans to the summarizer the same on both; n-gram speculation "
            f"under the window ({spec[4].spec_ticks} verify ticks, {spec[4].accepted}/"
            f"{spec[4].proposed} accepted) gives the plain streams")


def one_call_device(torch, fn):
    """Device time (ms) and kernel count of ONE call of ``fn``, under the
    profiler (a call that cannot be repeated as it was: a tick that
    rolls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    return sum(e.self_device_time_total for e in evs) / 1e3, sum(e.count for e in evs)


def rolling_path_phase(torch, label, hpc, n_new, must_launch):
    """Rolling windows on the full-width HPC tier: a second ServingEngine
    on the built engine's params (no second init) with
    WindowPolicy(**WINDOW), ROLL_SESSIONS concurrent sessions of
    ROLL_PROMPT-token prompts and ``n_new`` new tokens through
    ServingEngine.submit. Every session must roll and the pool's
    high-water stay at or under ROLL_SESSIONS x cap_pages; every kernel
    of ``must_launch``, its counter zeroed just before, must launch. Then
    a batcher driven tick by tick: wall and device time of a B=8 tick
    with a roll and one without, and one _shift_pages call's device time
    and kernels beside its byte bound. Returns (launches, stats)."""
    from repro_torch.serving import ContinuousBatcher, Request, ServingEngine, WindowPolicy

    pol = WindowPolicy(**WINDOW)
    cap = pol.cap_pages
    eng = ServingEngine(hpc.cfg, params=hpc.params, device=hpc.device, max_seq=MAX_SEQ,
                        page=PAGE, scheduler_slots=ROLL_SESSIONS, kv_dtype=hpc.kv_dtype,
                        prefix_cache_pages=ROLL_SESSIONS * cap + 2 * PAGE,
                        window_policy=pol)
    prompts = [[(i * 37 + j * 11) % 250 + 3 for j in range(ROLL_PROMPT)]
               for i in range(ROLL_SESSIONS)]
    torch.cuda.synchronize()
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    stamps = [[] for _ in prompts]
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=n_new,
                          on_token=lambda t, s, st=stamps[i]: st.append(time.perf_counter()))
               for i, p in enumerate(prompts)]
    res = [h.result(timeout=900) for h in handles]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    b = eng.scheduler.batcher
    hw = b.pool_stats().high_water
    if b.window is not pol or not b.paged:
        raise AssertionError(f"{label}: the window policy was not taken")
    rolls = [r.rolls for r in res]
    if min(rolls) < 1 or hw > ROLL_SESSIONS * cap or any(r.error for r in res):
        raise AssertionError(f"{label}: rolls {rolls}, high-water {hw} pages (cap "
                             f"{ROLL_SESSIONS} x {cap}), errors {[r.error for r in res]}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched on the path")
    if not eng.span_summarizer.flush(timeout=60):
        raise AssertionError(f"{label}: the span summarizer did not drain")
    rolled = sum(eng.span_summarizer.rolled_tokens(h.rid) for h in handles)
    if rolled != sum(rolls) * pol.roll_pages * PAGE:
        raise AssertionError(f"{label}: {rolled} tokens summarized for {sum(rolls)} rolls")
    # flatness over the steady span, when all sessions decode: from the
    # last session's first token (admissions that arrive after the first
    # tick prefill a chunk a tick between decode ticks) to the first
    # session's last; a session's tok/s in its first and last quarter
    lo_t, hi_t = max(st[0] for st in stamps), min(st[-1] for st in stamps)
    span = (hi_t - lo_t) / 4

    def quarter_rate(a, b):
        return sum(sum(1 for t in st if a < t <= b) for st in stamps) / len(stamps) / (b - a)

    first, last = quarter_rate(lo_t, lo_t + span), quarter_rate(hi_t - span, hi_t)
    n_gen = [r.n_generated for r in res]
    log(f"{label}: {ROLL_SESSIONS} sessions of {ROLL_PROMPT}-token prompts x {n_new} new "
        f"tokens under WindowPolicy({WINDOW}) (cap {cap} pages = {cap * PAGE} tokens, "
        f"{b.cache['k'].dtype} pages), wall {wall:.2f} s, {sum(n_gen) / wall:.1f} tok/s over "
        f"all sessions; generated {n_gen}, finish {sorted({r.finish_reason for r in res})}; "
        f"rolls per session {rolls} ({b.rolls} in all, {rolled} tokens to the summarizer); "
        f"pool high-water {hw} pages against {ROLL_SESSIONS} x {cap} = "
        f"{ROLL_SESSIONS * cap} (capacity {b.pool.capacity}); over the {hi_t - lo_t:.2f} s "
        f"all sessions decode, tok/s a session in the first quarter {first:.2f}, the last "
        f"{last:.2f}: last/first {last / first:.4f}")
    log(f"{label} launches: {json.dumps(launches)}")
    eng.shutdown()

    # tick by tick: B=8 ticks that roll against ticks that do not
    cb = ContinuousBatcher(eng, slots=ROLL_SESSIONS, max_seq=MAX_SEQ, page=PAGE,
                           prefix_pages=ROLL_SESSIONS * cap + 2 * PAGE)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=f"t{i}", prompt_ids=[(t + 1) % 250 + 3 for t in p],
                          max_new_tokens=ROLL_TICKS))
    walls = {True: [], False: []}
    dev = {}
    cap_tok = cap * PAGE
    with torch.inference_mode():
        while cb.queue or cb._adm is not None or any(r is not None for r in cb.active):
            full = (not cb.queue and cb._adm is None
                    and all(r is not None for r in cb.active))
            will = full and any(int(cb._pos[s]) - int(cb._poff[s]) + PAGE > cap_tok
                                for s in range(cb.B))
            if full and will not in dev and walls[will]:
                r0 = cb.rolls
                dev[will] = one_call_device(torch, cb.step)
                if (cb.rolls > r0) != will:
                    raise AssertionError(f"{label}: the profiled tick rolled "
                                         f"{cb.rolls - r0} times, predicted {will}")
                continue
            torch.cuda.synchronize()
            r0, t0 = cb.rolls, time.perf_counter()
            cb.step()
            torch.cuda.synchronize()
            if full:
                if (cb.rolls > r0) != will:
                    raise AssertionError(f"{label}: a tick rolled {cb.rolls - r0} times, "
                                         f"predicted {will}")
                walls[will].append((time.perf_counter() - t0) * 1e3)
    if not walls[True] or not walls[False] or len(dev) < 2:
        raise AssertionError(f"{label}: ticks with a roll {len(walls[True])}, without "
                             f"{len(walls[False])}")
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    # one _shift_pages call over a roll's kept pages (sink + roll pages out)
    kept = cap - pol.sink_pages - pol.roll_pages
    pids = list(range(1, 1 + kept))
    delta = pol.roll_pages * PAGE
    with torch.inference_mode():
        for _ in range(3):
            cb._shift_pages(pids, delta)
        shift_dev, shift_n = one_call_device(torch, lambda: cb._shift_pages(pids, delta))
        shift_ms = Timer(torch).ms(lambda: cb._shift_pages(pids, delta), n=20)
    nbytes = 0
    for key, ba in cb._rope_leaves:
        for k in (key, f"{key}_qscale"):
            if k in cb.cache:
                t = cb.cache[k]
                nbytes += 2 * kept * t.numel() // t.shape[ba] * t.element_size()
    shift_bound, _ = bound_ms(nbytes, 0, "bfloat16")
    log(f"{label} ticks (B={cb.B}, all slots decoding): with a roll median "
        f"{med[True]:.2f} ms wall over {len(walls[True])} ticks, device "
        f"{dev[True][0]:.3f} ms in {dev[True][1]} kernels (one profiled tick); without "
        f"{med[False]:.2f} ms wall over {len(walls[False])} ticks, device "
        f"{dev[False][0]:.3f} ms in {dev[False][1]} kernels; {cb.rolls} rolls")
    log(f"{label} _shift_pages over {kept} kept pages x {hpc.cfg.n_layers} layers "
        f"({cb.cache['k'].dtype} pages): device {shift_dev:.4f} ms in {shift_n} kernels, "
        f"{shift_ms:.4f} ms a call (timer, cold L2); byte bound {shift_bound:.6f} ms "
        f"({nbytes} B read and written)")
    stats = dict(roll_wall_s=wall, roll_tok_s=sum(n_gen) / wall, roll_first_q=first,
                 roll_last_q=last, roll_flat=last / first, roll_rolls=sum(rolls),
                 roll_hw=hw, roll_cap=ROLL_SESSIONS * cap, roll_tick_ms=med[True],
                 roll_tick_dev_ms=dev[True][0], roll_tick_kernels=dev[True][1],
                 plain_tick_ms=med[False], plain_tick_dev_ms=dev[False][0],
                 plain_tick_kernels=dev[False][1], shift_dev_ms=shift_dev,
                 shift_kernels=shift_n, shift_ms=shift_ms, shift_bound_ms=shift_bound)
    del cb, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def desktop_fleet_phase(torch, xlstm):
    """Desktop mode with a fleet: build_desktop_system(replicas=2) on the
    card, the local tier xlstm-125m at its published width (``xlstm``)
    on two replicas sharing params and the card, the HPC tier the smoke
    minitron. stream-local chats through the gateway (x-stream-replica
    header and fleet meta), a replica killed mid-stream, greedy and
    seeded (the failed-over stream must equal an unkilled run token for
    token), the aggregate tok/s of FLEET_SESSIONS concurrent sessions on
    two replicas and on one, the SQLite rows against the requests, the
    peak memory. rmsnorm, its counter zeroed just before, must launch.
    Returns (launches, stats); frees the system."""
    from repro_torch.core.desktop import build_desktop_system
    from repro_torch.core.sse import parse_sse
    from repro_torch.serving import EngineFleet

    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    sys_ = build_desktop_system(replicas=2, local_arch="xlstm-125m", local_overrides=xlstm,
                                max_seq=MAX_SEQ, device="cuda")
    build_s = time.perf_counter() - t0
    built = torch.cuda.memory_allocated()
    fleet = sys_.engines["local"]
    if not isinstance(fleet, EngineFleet) or len(fleet.engines) != 2 or \
            fleet.engines[1].params is not fleet.engines[0].params:
        raise AssertionError("desktop fleet: not two replicas sharing params")
    token = sys_.globus.issue_token("desktop@uic.edu")
    requests = 0
    seen = set()
    for i in range(4):
        resp = sys_.gateway.handle_chat_completions(
            {"model": "stream-local", "max_tokens": 16, "stream": True,
             "stream_options": {"include_usage": True},
             "messages": [{"role": "user", "content": f"Desktop chat {i} for the fleet."}]},
            bearer=token)
        requests += 1
        if resp.status != 200:
            raise AssertionError(f"desktop stream-local: status {resp.status}: {resp.body}")
        chunks = parse_sse("".join(resp.stream))
        meta = chunks[-1]["stream"]
        rep = resp.headers["x-stream-replica"]
        if resp.headers["x-stream-tier"] != "local" or rep not in ("0", "1") or \
                meta["replica"] != int(rep) or len(meta["fleet"]["routed"]) != 2:
            raise AssertionError(f"desktop stream-local: headers {resp.headers}, meta {meta}")
        seen.add(rep)
    rows = sys_.tracker.db_rows()
    if len(rows) != requests or any(r[1] != "local" for r in rows):
        raise AssertionError(f"desktop: {len(rows)} SQLite rows for {requests} requests")
    log(f"desktop fleet: build_desktop_system(replicas=2) {build_s:.1f} s; {requests} "
        f"stream-local chats through the gateway served by replicas {sorted(seen)}, each "
        f"with x-stream-replica and the fleet meta; {len(rows)} SQLite usage rows for "
        f"{requests} requests, no content column")

    failover = []
    for params in ({"max_tokens": 32}, {"max_tokens": 32, "seed": 1234, "temperature": 0.9}):
        prompt = f"Failover of the desktop fleet, {params.get('seed', 'greedy')}."
        want = fleet.submit(prompt, params=dict(params)).result(timeout=300)
        streamed, killed, state = [], [], {}

        def on_tok(tid, s):
            streamed.append(tid)
            if not killed and len(streamed) >= 3 and state.get("h") is not None:
                killed.append(state["h"].replica)
                fleet.engines[killed[0]].scheduler.kill("chip smoke: killed mid-stream")

        state["h"] = h = fleet.submit(prompt, params=dict(params), on_token=on_tok)
        res = h.result(timeout=300)
        if res.error or not killed or h.replica == killed[0] or \
                streamed != res.tokens or res.tokens != want.tokens:
            raise AssertionError(f"desktop failover {params}: killed {killed}, now on "
                                 f"{h.replica}, error {res.error}: {res.tokens} vs unkilled "
                                 f"{want.tokens}")
        failover.append(f"{'seeded' if 'seed' in params else 'greedy'}: replica "
                        f"{killed[0]} killed after 3 tokens, {len(res.tokens)} tokens "
                        f"token-identical on replica {h.replica} in {h.attempts} attempts")
        fleet.engines[killed[0]].shutdown()          # revive: a fresh broker
        r = fleet.replicas[killed[0]]
        r.open_until, r.dead, r.failures = 0.0, False, 0
        gc.collect()            # the killed broker's pool goes before the next one
    log("desktop fleet failover: " + "; ".join(failover))

    def ticks():
        return [e.scheduler.batcher.transfers if e.scheduler is not None else 0
                for e in fleet.engines]

    rate, tick_ms = {}, {}
    for n_rep, submit in ((2, fleet.submit), (1, fleet.engines[0].submit)):
        # prompts of their own a run: no prefix hit from the other run
        prompts = [f"Session {i} of the {n_rep}-replica run on the desktop fleet."
                   for i in range(FLEET_SESSIONS)]
        t0, k0 = time.perf_counter(), ticks()
        res = [h.result(timeout=600) for h in
               [submit(p, max_new_tokens=FLEET_TOKENS) for p in prompts]]
        wall = time.perf_counter() - t0
        rate[n_rep] = sum(r.n_generated for r in res) / wall
        # decode ticks each replica took in the run, and wall ms a tick
        tick_ms[n_rep] = [(b - a, wall * 1e3 / max(b - a, 1))
                          for a, b in zip(k0, ticks()) if b > a]
        if any(r.error or r.cancelled for r in res):
            raise AssertionError(f"desktop aggregate run on {n_rep} replica(s) failed")
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    if launches["rmsnorm"] <= 0:
        raise AssertionError("desktop fleet: rmsnorm was not launched")
    peak = torch.cuda.max_memory_allocated()
    local = fleet.engines[0]
    log(f"desktop fleet: {FLEET_SESSIONS} concurrent sessions x {FLEET_TOKENS} tokens of "
        f"{local.cfg.name} ({local.cfg.n_layers} layers, d_model {local.cfg.d_model}, "
        f"{local.cfg.param_dtype}): {rate[2]:.1f} tok/s on 2 replicas, {rate[1]:.1f} tok/s "
        f"on 1 (ratio {rate[2] / rate[1]:.4f}; both on the one card); "
        f"{built / 2**30:.2f} GiB allocated once built, peak device memory "
        f"{peak / 2**30:.2f} GiB; routed {fleet.metrics.snapshot()}; decode ticks and "
        f"wall ms a tick, per replica that ticked: 2 replicas "
        f"{[(n, round(ms, 2)) for n, ms in tick_ms[2]]}, 1 replica "
        f"{[(n, round(ms, 2)) for n, ms in tick_ms[1]]}")
    log(f"desktop fleet launches: {json.dumps(launches)}")
    stats = dict(fleet_tok_s_2=rate[2], fleet_tok_s_1=rate[1], fleet_peak_gib=peak / 2**30,
                 fleet_tick_ms_2=max(ms for _, ms in tick_ms[2]),
                 fleet_tick_ms_1=max(ms for _, ms in tick_ms[1]),
                 fleet_rows=len(sys_.tracker.db_rows()))
    free_system(sys_)
    del sys_, fleet, local
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


# ---------------------------------------------------------------- main path
def counters():
    """kernel -> (module, counter attribute) of its wrapper's launch count."""
    from repro_torch.kernels import (awq_matmul, decode_attention, flash_attention,
                                     paged_attention, rmsnorm, ssm_scan)
    return {"rmsnorm": (rmsnorm, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "launches_bwd"),
            "paged_attention": (paged_attention, "launches"),
            "paged_attention_quant": (paged_attention, "launches_quant"),
            "decode_attention": (decode_attention, "launches"),
            "awq_matmul": (awq_matmul, "launches"),
            "ssd": (ssm_scan, "launches")}


def full_width(arch, **cut):
    """hpc_overrides for ``arch`` at its published widths (every field of
    get_config(arch) but the name) in bf16, with ``cut`` (a smaller
    depth) over them."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return {**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
               if f.name != "name"},
            "param_dtype": "bfloat16", "compute_dtype": "bfloat16", **cut}


def main_path_phase(torch, label, must_launch, hpc_overrides=FULL, *, local_arch,
                    local_request=False, **system_kw):
    """build_system on the card with the full-width HPC tier, then four
    concurrent stream-hpc requests and one stream-auto request through
    the gateway (and, with ``local_request``, one stream-local request,
    which the local tier must serve). Every kernel of ``must_launch``,
    its counter zeroed just before the path, must have launched."""
    from repro_torch.core import build_system
    from repro_torch.core.sse import parse_sse
    from repro_torch.models.common import flatten
    from repro_torch.serving.quantize import weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    sys_ = build_system(device="cuda", local_arch=local_arch, max_seq=MAX_SEQ,
                        hpc_overrides=hpc_overrides, dispatch_latency_s=0.05, **system_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    build_peak = torch.cuda.max_memory_allocated()
    hpc = sys_.engines["hpc"]
    n_params = sum(t.numel() for _, t in flatten(hpc.params))
    wb = weight_bytes(hpc.params)
    log(f"{label}: build_system {build_s:.1f} s (peak {build_peak / 2**30:.2f} GiB), "
        f"HPC tier {n_params / 1e9:.2f} B stored values, weight_bytes "
        f"{wb['total'] / 1e9:.3f} GB (quantized {wb['quantized'] / 1e9:.3f} GB standing "
        f"for {wb['dense_equivalent'] / 1e9:.3f} GB at f32, dense {wb['dense'] / 1e9:.3f} GB), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()

    n_tok = 32
    token = sys_.globus.issue_token("chip-smoke@uic.edu")

    def one(alias, content, out, i):
        t_sub = time.perf_counter()
        resp = sys_.gateway.handle_chat_completions(
            {"model": alias, "messages": [{"role": "user", "content": content}],
             "max_tokens": n_tok, "stream": True,
             "stream_options": {"include_usage": True}}, bearer=token)
        if resp.status != 200:
            raise AssertionError(f"{alias}: status {resp.status}: {resp.body}")
        stamps, raw = [], []
        for piece in resp.stream:
            raw.append(piece)
            stamps.append(time.perf_counter())
        chunks = parse_sse("".join(raw))
        out[i] = dict(status=resp.status, headers=resp.headers, chunks=chunks,
                      t_sub=t_sub, stamps=stamps)

    results = [None] * 6
    threads = [threading.Thread(target=one, args=(
        "stream-hpc", f"Explain request {i} of the dual-channel relay.", results, i))
        for i in range(4)]
    t_wall = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a stream-hpc request did not finish in 600 s")
    if None in results[:4]:
        raise AssertionError("a stream-hpc request failed (traceback above)")
    wall = time.perf_counter() - t_wall
    one("stream-auto", "What is the capital of France?", results, 4)
    if local_request:
        one("stream-local", "Say hello to the local tier.", results, 5)
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    peak = torch.cuda.max_memory_allocated()
    batcher = hpc.scheduler.batcher
    pool_bytes = batcher.pool.pool_bytes
    copied = batcher.bytes_copied_per_admission()

    ttfts, rates, total_tokens = [], [], 0
    for i, r in enumerate(results):
        if r is None:
            continue
        alias = "stream-hpc" if i < 4 else "stream-auto" if i == 4 else "stream-local"
        if r["status"] != 200:
            raise AssertionError(f"{alias}: status {r['status']}")
        tier = r["headers"]["x-stream-tier"]
        if i < 4 and tier != "hpc":
            raise AssertionError(f"stream-hpc served by tier {tier!r}")
        if i == 5 and tier != "local":
            raise AssertionError(f"stream-local served by tier {tier!r}")
        chunks = r["chunks"]
        usage = chunks[-1].get("usage")
        if not usage or chunks[-1].get("choices") != []:
            raise AssertionError(f"{alias}: no usage chunk at the end")
        frames = [c for c in chunks if c.get("choices")
                  and c["choices"][0].get("finish_reason") is None]
        n = usage["completion_tokens"]
        if not (1 <= n <= n_tok) or len(frames) - 1 != n:
            raise AssertionError(f"{alias}: {n} completion tokens, "
                                 f"{len(frames) - 1} content frames")
        if i < 4:
            total_tokens += n
            # SSE pieces: role preamble first, then one per token
            ttfts.append(r["stamps"][1] - r["t_sub"])
            if n > 1:
                rates.append((n - 1) / (r["stamps"][n] - r["stamps"][1]))
        log(f"{label} {alias}: tier {tier}, {n} tokens, finish "
            f"{[c for c in chunks if c.get('choices')][-1]['choices'][0]['finish_reason']}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched on the path")
    log(f"{label} launches: {json.dumps(launches)}")
    during = {name: launches[name] - built[name] for name in launches}
    log(f"{label} launches while serving the requests (after build and warmup): "
        f"{json.dumps(during)}")
    if local_request:
        local = sys_.engines["local"]
        lb = local.scheduler.batcher
        lpool = lb.pool
        if type(local.model).__name__ != "XLSTMLM" or local.device.type != "cuda":
            raise AssertionError(f"local tier: {type(local.model).__name__} on {local.device}")
        log(f"{label} local tier: {local.cfg.name} ({local.cfg.n_layers} layers, d_model "
            f"{local.cfg.d_model}, vocab {local.cfg.vocab_size}, {local.cfg.param_dtype}) on "
            f"{local.device}, {'paged' if lb.paged else 'contiguous splice'} path; stateful "
            f"prefix pool of {lpool.capacity} pages, {lpool._state_bytes / 1e6:.2f} MB of "
            f"state a page, {lpool.pool_bytes / 1e9:.3f} GB ({lpool.pool_bytes} B); "
            f"{lb.bytes_copied_per_admission():.0f} B copied per admission")
    ttfts.sort()
    stats = dict(ttft_median_ms=ttfts[len(ttfts) // 2] * 1e3, ttft_max_ms=ttfts[-1] * 1e3,
                 tok_s_session=sum(rates) / len(rates), tok_s_all=total_tokens / wall,
                 wall_s=wall, peak_gib=peak / 2**30, build_peak_gib=build_peak / 2**30,
                 weight_gb=wb["total"] / 1e9, pool_bytes=pool_bytes,
                 bytes_copied_per_admission=copied, during=during)
    log(f"{label}: TTFT median {stats['ttft_median_ms']:.1f} ms "
        f"(max {stats['ttft_max_ms']:.1f} ms) over 4 concurrent stream-hpc requests; "
        f"decode {stats['tok_s_session']:.1f} tok/s per session, "
        f"{stats['tok_s_all']:.1f} tok/s over all 4 sessions (wall {wall:.2f} s); "
        f"peak device memory while serving {stats['peak_gib']:.2f} GiB; "
        f"HPC page pool {pool_bytes / 2**20:.1f} MiB ({pool_bytes} B, "
        f"{'paged' if batcher.paged else 'contiguous splice'} path, "
        f"{batcher.pool.capacity} pages); {copied:.0f} B copied per admission "
        f"over {batcher.admissions} admissions")

    # full-width logits are finite and of the padded vocab's width
    with torch.inference_mode():
        cache = hpc.model.init_cache(1, MAX_SEQ, hpc.device)
        logits, _ = hpc.model.prefill_chunk(
            hpc.params, torch.tensor([[0, 40, 41, 42]], device=hpc.device), cache)
    if tuple(logits.shape) != (1, hpc.cfg.padded_vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"full-width logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(logits.isfinite().all())}")
    return launches, stats, sys_


def profile_phase(torch, label, what, fn):
    """Host wall time of ``fn`` (ending in a synchronize) against the
    device time the profiler sums over its kernels; logs the top kernels
    and host ops. Returns (wall ms, device ms, kernels, host ms in ops)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
    avgs = prof.key_averages()
    evs = [e for e in avgs if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    host = [e for e in avgs if e not in evs]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in evs) / 5
    n_launch = sum(e.count for e in evs
                   if getattr(e, "self_device_time_total", 0) > 0) / 5
    # host time inside PyTorch ops and CUDA runtime calls (the profiler's
    # own cost included); the rest of the wall time is Python
    host_us = sum(e.self_cpu_time_total for e in host) / 5
    log(f"{label} breakdown: {what}: {wall_ms:.2f} ms wall, {n_launch:.0f} device kernels "
        f"taking {dev_us / 1e3:.2f} ms -> device busy {dev_us / 1e3 / wall_ms * 100:.0f}% "
        f"of it; host self time in ops and runtime calls {host_us / 1e3:.2f} ms "
        f"(under the profiler)")
    for e in sorted(evs, key=lambda e: -getattr(e, "self_device_time_total", 0))[:10]:
        log(f"  {getattr(e, 'self_device_time_total', 0) / 5 / 1e3:8.3f} ms/call "
            f"{e.count // 5:5d} calls  {e.key[:90]}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  host {e.self_cpu_time_total / 5 / 1e3:8.3f} ms/call "
            f"{e.count // 5:5d} calls  {e.key[:80]}")
    return wall_ms, dev_us / 1e3, n_launch, host_us / 1e3


def breakdown_phase(torch, label, sys_):
    """Where the time goes, on the HPC engine alone (after the main
    path's counters were read): the same 4 sessions through
    ServingEngine.submit without gateway, control plane, relay and
    encryption; then one B=8 decode step of the model (paged, or the
    splice path's contiguous slot cache) and one 16-token prefill piece,
    host wall time against the device time the profiler sums over their
    kernels. Shuts the system down."""
    hpc = sys_.engines["hpc"]
    prompts = [f"Explain request {i} of the dual-channel relay." for i in range(4)]
    t0 = time.perf_counter()
    res = [h.result(timeout=600) for h in
           [hpc.submit(p, max_new_tokens=32) for p in prompts]]
    wall = time.perf_counter() - t0
    ttft = sorted(r.ttft_s for r in res)
    out = dict(engine_tok_s=sum(r.n_generated for r in res) / wall,
               engine_ttft_median_ms=ttft[2] * 1e3)
    log(f"{label} breakdown: engine alone, 4 sessions x 32 tokens: "
        f"{out['engine_tok_s']:.1f} tok/s over all sessions "
        f"(wall {wall:.2f} s), TTFT median {ttft[2] * 1e3:.1f} ms, max {ttft[-1] * 1e3:.1f} ms")

    b = hpc.scheduler.batcher
    stop_system(sys_)
    # a synthetic B=8 step over the (now idle) slots: 40 cached tokens each
    pos = torch.full((b.B,), 40, dtype=torch.int32, device=hpc.device)
    if b.paged:
        pages = torch.arange(1, 1 + 3 * b.B, dtype=torch.int32, device=hpc.device)
        bt = torch.zeros((b.B, b.n_pages), dtype=torch.int32, device=hpc.device)
        bt[:, :3] = pages.reshape(b.B, 3)
        cache = {k: b.cache[k] for k in b._pool_keys}
        cache.update(pos=pos, block_tables=bt,
                     pos_offset=torch.zeros(b.B, dtype=torch.int32, device=hpc.device))
    else:
        cache = {**b.cache, "pos": pos}
    tok = torch.full((b.B, 1), 42, dtype=torch.int64, device=hpc.device)
    kind = "paged" if b.paged else "contiguous"
    step_ms, dev_ms, n_launch, host_ms = profile_phase(
        torch, label, f"B=8 {kind} decode step at full width",
        lambda: hpc.model.decode_step(hpc.params, tok, cache)[0])
    out.update(step_ms=step_ms, dev_ms=dev_ms, n_launch=n_launch,
               busy=dev_ms / step_ms, host_ops_ms=host_ms)
    piece = torch.arange(3, 3 + PAGE, dtype=torch.int64, device=hpc.device)[None]
    one = hpc.model.init_cache(1, MAX_SEQ, hpc.device)
    piece_ms, pdev_ms, p_launch, _ = profile_phase(
        torch, label, f"one {PAGE}-token prefill piece at full width",
        lambda: hpc.model.prefill_chunk(hpc.params, piece, one)[0])
    out.update(piece_ms=piece_ms, piece_dev_ms=pdev_ms, piece_launch=p_launch,
               piece_busy=pdev_ms / piece_ms)
    del one
    # host cost of one call, enqueue only: 200 calls do not fill the
    # device's launch queue, so the host clock sees the host's own work
    from repro_torch.models import layers
    from repro_torch.models.lm import _layer
    lp = _layer(hpc.params["blocks" if "blocks" in hpc.params else "dec_blocks"], 0)
    xs = torch.randn(b.B, 1, hpc.cfg.d_model, device=hpc.device, dtype=hpc.cfg.cdtype())
    if "mlp" in lp and "router" in lp["mlp"]:
        # an MoE block: the shared experts' w1 where there are any, else
        # the attention's output projection (grok-1: 48 x 128 = d_model)
        wname, w = (("shared w1", lp["mlp"]["shared"]["w1"]) if "shared" in lp["mlp"]
                    else ("wo", lp["attn"]["wo"]))
        ln = lp["ln1"]
    else:
        wname, w, ln = (("w1", lp["mlp"]["w1"], lp["ln1"]) if "mlp" in lp
                        else ("in_proj", lp["in_proj"], lp["ln"]))
    calls = {f"_matmul {wname} ({'awq_matmul' if isinstance(w, dict) else 'torch matmul'})":
             lambda: layers._matmul(xs, w, hpc.cfg),
             "rmsnorm": lambda: layers.rmsnorm(xs, ln, hpc.cfg),
             "torch.add": lambda: xs + xs}
    if any(k.endswith("_qscale") for k in cache):
        calls["quantize_kv"] = lambda: layers.ops.quantize_kv(xs, torch.int8)
    host_call = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_call[name] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    log(f"{label} breakdown: host us per call {json.dumps(host_call)}; "
        f"{threading.active_count()} Python threads alive: "
        f"{sorted(t.name for t in threading.enumerate())}")
    for e in sys_.engines.values():      # let the weights go, whoever holds the engine
        e.params = None
    return out


def xlstm_breakdown(torch, label, sys_):
    """The local tier's xLSTM alone at its published width: one B=8 decode
    step and one 16-token prefill piece (its time loop runs 12 layers x 16
    steps of small launches), host wall time against device time."""
    local = sys_.engines["local"]
    m, p, dev = local.model, local.params, local.device
    cache = m.init_cache(B, MAX_SEQ, dev)
    cache["pos"] = torch.full((B,), 40, dtype=torch.int32, device=dev)
    tok = torch.full((B, 1), 42, dtype=torch.int64, device=dev)
    what = f"{label} local tier ({local.cfg.name})"
    step_ms, dev_ms, n_launch, _ = profile_phase(
        torch, what, f"B={B} decode step at full width", lambda: m.decode_step(p, tok, cache)[0])
    piece = torch.arange(3, 3 + PAGE, dtype=torch.int64, device=dev)[None]
    one = m.init_cache(1, MAX_SEQ, dev)
    piece_ms, pdev_ms, p_launch, _ = profile_phase(
        torch, what, f"one {PAGE}-token prefill piece at full width",
        lambda: m.prefill_chunk(p, piece, one)[0])
    return dict(local_step_ms=step_ms, local_dev_ms=dev_ms, local_n_launch=n_launch,
                local_piece_ms=piece_ms, local_piece_dev_ms=pdev_ms,
                local_piece_launch=p_launch)


def stop_system(sys_):
    """Shut a system's engines (their broker threads), endpoint and
    gateway down."""
    for e in sys_.engines.values():
        e.shutdown()
    sys_.endpoint.shutdown()
    sys_.gateway.shutdown()


def free_system(sys_):
    """Stop a system and let its weights go (every replica's, for a fleet)."""
    stop_system(sys_)
    for e in sys_.engines.values():
        for one in getattr(e, "engines", [e]):
            one.params = None
            one.drafter = None


def forced_acceptance(torch, label, hpc):
    """On the speculative HPC engine: a plain greedy run of one prompt
    through its own batcher (a draft_hook that offers nothing makes every
    tick plain), then the same prompt with a draft_hook that replays that
    run. At least one verify tick must accept all k drafts; where the two
    streams first differ is printed (bf16 at full width: verify scores the
    window over gathered pages, a plain tick through the paged kernel, so
    a near-tie may flip) and not asserted."""
    b = hpc.scheduler.batcher
    k, W = b.spec_k, b.spec_k + 1
    prompt = "Explain the dual-channel relay of the HPC tier, step by step."
    b.draft_hook = lambda slot, req: []
    plain = hpc.submit(prompt, max_new_tokens=32).result(timeout=600).tokens
    ticks, orig = [], b._verify

    def spy(drafts, lens, rng):
        packed = orig(drafts, lens, rng)
        ticks.append([(int(lens[s]), int(packed[s, W + 2])) for s in range(b.B) if lens[s]])
        return packed

    b._verify = spy
    b.draft_hook = lambda slot, req: plain[len(req.output_ids):len(req.output_ids) + k]
    st0 = dict(vars(b.spec_stats))
    res = hpc.submit(prompt, max_new_tokens=32).result(timeout=600)
    del b._verify
    b.draft_hook = None
    st = {key: v - st0[key] for key, v in vars(b.spec_stats).items()}
    full = sum(1 for t in ticks if any(n_l == k and n_a == k for n_l, n_a in t))
    first = next((i for i, (a, c) in enumerate(zip(plain, res.tokens)) if a != c), None)
    rate = st["accepted"] / max(st["proposed"], 1)
    log(f"{label} forced acceptance: a draft_hook replays the plain greedy run "
        f"({len(plain)} tokens): {st['spec_ticks']} verify ticks, {full} accepted all {k} "
        f"drafts; acceptance {rate:.4f} ({st['accepted']}/{st['proposed']}), "
        f"{st['emitted'] / max(st['spec_ticks'], 1):.3f} tokens per verify tick; the streams "
        + ("are identical" if first is None and len(plain) == len(res.tokens) else
           f"first differ at output position {first}") + f" (lengths {len(plain)}, "
        f"{len(res.tokens)})")
    if full < 1:
        raise AssertionError(f"{label}: no verify tick accepted all {k} replayed drafts")
    return dict(forced_rate=rate, forced_full_ticks=full,
                forced_first_diff=-1 if first is None else first)


def verify_breakdown(torch, label, hpc):
    """One B=8, W=5 verify step of the HPC model over the paged pool (40
    cached tokens a slot, windows in one page): logits finite, the kernel
    launches of one call counted, host wall time against device time.
    Overwrites pool pages 1-24: runs after the path's last request."""
    b = hpc.scheduler.batcher
    W = b.spec_k + 1
    dev = hpc.device
    bt = torch.zeros((b.B, b.n_pages), dtype=torch.int32, device=dev)
    bt[:, :3] = torch.arange(1, 1 + 3 * b.B, dtype=torch.int32, device=dev).reshape(b.B, 3)
    cache = {key: b.cache[key] for key in b._pool_keys}
    cache.update(pos=torch.full((b.B,), 40, dtype=torch.int32, device=dev), block_tables=bt,
                 pos_offset=torch.zeros(b.B, dtype=torch.int32, device=dev))
    win = torch.full((b.B, W), 42, dtype=torch.int64, device=dev)
    before = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    with torch.inference_mode():
        logits, _ = hpc.model.verify_chunk(hpc.params, win, cache)
    torch.cuda.synchronize()
    per_call = {name: getattr(mod, attr) - before[name]
                for name, (mod, attr) in counters().items()
                if getattr(mod, attr) != before[name]}
    if tuple(logits.shape) != (b.B, W, hpc.cfg.padded_vocab) or not bool(
            logits.isfinite().all()):
        raise AssertionError(f"verify logits: shape {tuple(logits.shape)}")
    step_ms, dev_ms, n_launch, host_ms = profile_phase(
        torch, label, f"B={b.B} W={W} verify step at full width ({b.pool.kv_dtype} pages)",
        lambda: hpc.model.verify_chunk(hpc.params, win, cache)[0])
    log(f"{label} verify step: hand kernels a call {json.dumps(per_call)} (the window's "
        f"attention is the plain gather + chunk attention, as in the JAX package)")
    return dict(verify_ms=step_ms, verify_dev_ms=dev_ms, verify_n_launch=n_launch,
                verify_busy=dev_ms / step_ms, verify_host_ops_ms=host_ms)


def speculative_path_phase(torch, label, mode, must_grow, **kw):
    """build_system(speculative=True, spec_k=SPEC_K) on the card, the main
    path's requests through the gateway; the HPC batcher must run
    ``mode`` ("ngram" beside a recurrent local tier, which runs plain
    decode; "model" beside a dense one). Then (the n-gram path) the
    forced-acceptance run, whose plain run takes plain ticks: every kernel
    of ``must_grow`` must have launched after the build and warmup, in the
    requests or that run, which the path's launches include. Then the
    verify step's breakdown. Frees the system; returns (launches, stats)."""
    launches, stats, sys_ = main_path_phase(torch, label, (), speculative=True,
                                            spec_k=SPEC_K, **kw)
    at_build = {name: launches[name] - stats["during"][name] for name in launches}
    hpc = sys_.engines["hpc"]
    b = hpc.scheduler.batcher
    lb = sys_.engines["local"]._get_broker().batcher
    if b.spec_mode != mode or b.spec_k != SPEC_K or (
            mode == "ngram" and lb.spec_mode != "off"):
        raise AssertionError(f"{label}: HPC spec_mode {b.spec_mode} (k {b.spec_k}), local "
                             f"{lb.spec_mode}")
    top = max(stats["peak_gib"], stats["build_peak_gib"]) * 2**30
    if top > CARD_BYTES:
        raise AssertionError(f"{label}: peak {top / 1e9:.2f} GB, over the card's "
                             f"{CARD_BYTES / 1e9:.0f} GB")
    st = b.spec_stats
    stats.update(spec_ticks=st.spec_ticks, plain_ticks=st.plain_ticks, proposed=st.proposed,
                 accepted=st.accepted, acceptance=st.acceptance_rate,
                 tokens_per_tick=st.tokens_per_tick)
    log(f"{label}: HPC spec_mode {b.spec_mode}, local tier {lb.spec_mode} "
        f"({type(sys_.engines['local'].model).__name__}); SpecStats over the requests: "
        f"{st.spec_ticks} verify ticks, {st.plain_ticks} plain ticks, {st.proposed} drafts "
        f"proposed, {st.accepted} accepted (acceptance {st.acceptance_rate:.4f}), "
        f"{st.tokens_per_tick:.3f} tokens per verify tick")
    if mode == "ngram":
        stats.update(forced_acceptance(torch, label, hpc))
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    grew = {name: launches[name] - at_build[name] for name in launches}
    log(f"{label} launches after build and warmup, requests"
        f"{' and forced-acceptance run' if mode == 'ngram' else ''}: {json.dumps(grew)}; "
        f"the path's count (the kernels line's share): {json.dumps(launches)}")
    for name in must_grow:
        if grew[name] <= 0:
            raise AssertionError(f"{label}: {name} did not launch while serving")
    stats.update(verify_breakdown(torch, label, hpc))
    held = torch.cuda.memory_allocated()
    free_system(sys_)
    del sys_, hpc, b, lb
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label} system freed: {held / 2**30:.2f} GiB -> "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return launches, stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build (nvcc, sources in parallel): {time.perf_counter() - t0:.1f} s")
    for name in ("awq_matmul", "rmsnorm", "flash_attention_bwd", "ssd"):
        for line in ptxas_lines(_build.build_log(name)):
            log(f"ptxas {name}: {line}")
    n_hmma = sass_count(_build._target("awq_matmul"), "HMMA")
    log(f"awq_matmul.cu SASS: {n_hmma} HMMA (tensor-core) instructions")
    if n_hmma == 0:
        raise AssertionError("awq_matmul's bf16 body does not run on tensor cores")

    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    since(t0, "kernel phase")
    reference_phase(torch)
    crossattn_reference_phase(torch)
    xlstm_reference_phase(torch)
    speculative_reference_phase(torch)
    rolling_reference_phase(torch)
    training_reference_phase(torch)
    for arch, must in FAMILY_SMOKES:
        training_reference_phase(torch, arch, must)
    since(t0, "reference phases")

    paths, rolling = {}, {}
    dense_must = ("rmsnorm", "paged_attention", "decode_attention")
    log(f"deepseek path: deepseek-67b at full width cut to {DEEPSEEK_LAYERS} of its 95 "
        "layers (95 bf16 layers, 134 GB, cannot exist on one card before the W4A16 "
        "quantization)")
    xlstm = {**full_width("xlstm-125m"), "name": "xlstm-125m"}
    log(f"dense path: the local tier is the reference's default, xlstm-125m at its "
        f"published width ({xlstm['n_layers']} layers, d_model {xlstm['d_model']}, "
        f"vocab {xlstm['vocab_size']}, bf16); the other paths keep minitron-8b at smoke "
        f"size there, as in earlier runs")
    for label, must, kw in (
            ("dense", dense_must, dict(local_arch="xlstm-125m", local_overrides=xlstm,
                                       local_request=True)),
            ("quantized", ("rmsnorm", "paged_attention_quant", "awq_matmul"),
             dict(kv_dtype="int8", quantize_mlp=True, local_arch="minitron-8b")),
            ("hybrid", ("ssd", "decode_attention", "rmsnorm"),
             dict(hpc_arch="zamba2-7b", hpc_overrides=ZAMBA_FULL,
                  prefix_cache_pages=ZAMBA_POOL_PAGES, local_arch="minitron-8b")),
            ("gemma", dense_must,
             dict(hpc_arch="gemma-7b", hpc_overrides=full_width("gemma-7b"),
                  local_arch="minitron-8b")),
            ("granite", dense_must,
             dict(hpc_arch="granite-20b", hpc_overrides=full_width("granite-20b"),
                  local_arch="minitron-8b")),
            ("deepseek", ("rmsnorm", "paged_attention_quant", "awq_matmul", "decode_attention"),
             dict(hpc_arch="deepseek-67b", kv_dtype="int8", quantize_mlp=True,
                  hpc_overrides=full_width("deepseek-67b", n_layers=DEEPSEEK_LAYERS),
                  local_arch="minitron-8b")),
            ("mla", ("rmsnorm", "decode_attention"),
             dict(hpc_arch="deepseek-v2-lite-16b",
                  hpc_overrides=full_width("deepseek-v2-lite-16b"), local_arch="minitron-8b")),
            ("mla-quantized", ("rmsnorm", "decode_attention", "awq_matmul"),
             dict(hpc_arch="deepseek-v2-lite-16b", kv_dtype="int8", quantize_mlp=True,
                  hpc_overrides=full_width("deepseek-v2-lite-16b", n_layers=MLA_Q_LAYERS),
                  local_arch="minitron-8b")),
            ("grok", ("rmsnorm", "paged_attention"),
             dict(hpc_arch="grok-1-314b",
                  hpc_overrides=full_width("grok-1-314b", n_layers=GROK_LAYERS),
                  local_arch="minitron-8b")),
            ("whisper", ("decode_attention", "flash_attention"),
             dict(hpc_arch="whisper-medium", hpc_overrides=full_width("whisper-medium"),
                  prefix_cache_pages=CROSS_POOL_PAGES, local_arch="minitron-8b")),
            ("vision", ("rmsnorm", "decode_attention", "flash_attention"),
             dict(hpc_arch="llama-3.2-vision-11b",
                  hpc_overrides=full_width("llama-3.2-vision-11b"),
                  prefix_cache_pages=CROSS_POOL_PAGES, local_arch="minitron-8b"))):
        launches, stats, sys_ = main_path_phase(torch, f"{label} path", must, **kw)
        if label.startswith("mla"):
            # the naive MLA decode: one decode_attention launch a layer a
            # tick, at D = 192 over the gathered latent view
            hcfg = sys_.engines["hpc"].cfg
            log(f"{label} path: decode_attention launches while serving "
                f"{stats['during']['decode_attention']} over {hcfg.n_layers} layers "
                f"({stats['during']['decode_attention'] / hcfg.n_layers:.1f} decode ticks), "
                f"D = {hcfg.qk_nope_head_dim + hcfg.qk_rope_head_dim}, "
                f"{hcfg.n_heads}/{hcfg.n_heads} heads; kv_lora_rank {hcfg.kv_lora_rank}")
        if label in ("dense", "gemma", "granite", "mla"):
            prefill_check(torch, sys_.engines["hpc"], label)
        if label in ("whisper", "vision"):
            crossattn_served_check(stats, sys_.engines["hpc"], label, must)
            extras_check(torch, sys_.engines["hpc"], label)
        if label == "dense":
            stats.update(xlstm_breakdown(torch, f"{label} path", sys_))
        if label in ("dense", "quantized"):
            # the same HPC tier's params under a rolling window
            rolling[label] = rolling_path_phase(
                torch, f"rolling {label} path", sys_.engines["hpc"],
                ROLL_NEW if label == "dense" else ROLL_NEW // 2,
                ("rmsnorm", "paged_attention") if label == "dense"
                else ("rmsnorm", "paged_attention_quant", "awq_matmul"))
        held = torch.cuda.memory_allocated()
        top = max(stats["peak_gib"], stats["build_peak_gib"]) * 2**30
        if top > CARD_BYTES:
            raise AssertionError(f"{label} path: peak {top / 1e9:.2f} GB, over the card's "
                                 f"{CARD_BYTES / 1e9:.0f} GB")
        stats.update(breakdown_phase(torch, f"{label} path", sys_))
        paths[label] = (launches, stats)
        since(t0, f"{label} path")
        # the next path builds only once this one's memory went back
        del sys_
        gc.collect()
        torch.cuda.empty_cache()
        freed = torch.cuda.memory_allocated()
        if freed > held - 5 * 2**30:
            raise AssertionError(f"the {label} system was not freed: {held / 2**30:.2f} "
                                 f"GiB -> {freed / 2**30:.2f} GiB allocated")
        log(f"{label} system freed: {held / 2**30:.2f} GiB -> {freed / 2**30:.2f} GiB "
            f"allocated")

    specs = {"ngram": speculative_path_phase(
                 torch, "speculative n-gram path", "ngram", ("rmsnorm", "paged_attention"),
                 local_arch="xlstm-125m", local_overrides=xlstm),
             "model": speculative_path_phase(
                 torch, "speculative model-drafting path", "model",
                 ("rmsnorm", "decode_attention"),
                 local_arch="minitron-8b", local_overrides={**FULL, "n_layers": 4})}
    log(f"{card}: speculative paths, HPC tier full-width minitron-8b (bf16 pages), "
        f"spec_k {SPEC_K}: n-gram drafts beside the xlstm-125m local tier | the local "
        f"tier's minitron-8b at full width cut to 4 layers drafting; the same 4 + 1 requests")
    for key, what in (("ttft_median_ms", "TTFT median ms"), ("ttft_max_ms", "TTFT max ms"),
                      ("tok_s_session", "decode tok/s per session"),
                      ("tok_s_all", "tok/s over all 4 sessions"),
                      ("spec_ticks", "verify ticks"), ("plain_ticks", "plain ticks"),
                      ("proposed", "drafts proposed"), ("accepted", "drafts accepted"),
                      ("acceptance", "acceptance rate"),
                      ("tokens_per_tick", "tokens per verify tick"),
                      ("verify_ms", "B=8 W=5 verify step wall ms"),
                      ("verify_dev_ms", "B=8 W=5 verify step device ms"),
                      ("verify_n_launch", "B=8 W=5 verify step device kernels"),
                      ("verify_busy", "B=8 W=5 verify step device busy share"),
                      ("peak_gib", "peak device memory while serving GiB"),
                      ("build_peak_gib", "peak device memory building GiB")):
        log(f"compare {what:38s} " + "  ".join(
            f"{label} {stats[key]:14.4f}" for label, (_, stats) in specs.items()))

    since(t0, "speculative paths")
    fleet = desktop_fleet_phase(torch, xlstm)
    since(t0, "desktop fleet")
    log(f"{card}: rolling paths (HPC tier full-width minitron-8b; WindowPolicy({WINDOW}), "
        f"{ROLL_SESSIONS} sessions of {ROLL_PROMPT}-token prompts): bf16 pages x {ROLL_NEW} "
        f"new tokens | int8 pages + W4A16 x {ROLL_NEW // 2}")
    for key, what in (("roll_tok_s", "tok/s over all sessions"),
                      ("roll_first_q", "tok/s a session, steady first quarter"),
                      ("roll_last_q", "tok/s a session, steady last quarter"),
                      ("roll_flat", "last quarter / first quarter"),
                      ("roll_rolls", "rolls over all sessions"),
                      ("roll_hw", "pool high-water pages"), ("roll_cap", "8 x cap_pages"),
                      ("roll_tick_ms", "B=8 tick with a roll, wall ms"),
                      ("roll_tick_dev_ms", "B=8 tick with a roll, device ms"),
                      ("roll_tick_kernels", "B=8 tick with a roll, kernels"),
                      ("plain_tick_ms", "B=8 tick without, wall ms"),
                      ("plain_tick_dev_ms", "B=8 tick without, device ms"),
                      ("plain_tick_kernels", "B=8 tick without, kernels"),
                      ("shift_dev_ms", "_shift_pages device ms"),
                      ("shift_kernels", "_shift_pages kernels"),
                      ("shift_bound_ms", "_shift_pages byte bound ms")):
        log(f"compare {what:38s} " + "  ".join(
            f"{label} {stats[key]:14.4f}" for label, (_, stats) in rolling.items()))

    trains = {arch: training_phase(torch, arch) for arch in ("minitron-8b", "gemma-7b")}
    since(t0, "dense training paths")
    for arch, n_layers, seq, must in FAMILY_TRAINS:
        trains[arch] = training_phase(torch, arch, n_layers, seq, must)
        since(t0, f"training path {arch}")
    dist_launch = distributed_phase(torch, card)
    since(t0, "distributed phase")
    dryrun_phase(card)
    since(t0, "dry-run phase")
    driver_phase(torch)
    since(t0, "training driver")

    log(f"{card}: dense bf16 minitron-8b | int8 pages + W4A16 (group 64) minitron-8b | "
        f"bf16 zamba2-7b (splice path) | bf16 gemma-7b | bf16 granite-20b | int8 pages + "
        f"W4A16 deepseek-67b ({DEEPSEEK_LAYERS} layers) | mla: bf16 deepseek-v2-lite-16b "
        f"(27 layers) | mla-quantized: int8 latent pages + W4A16 deepseek-v2-lite-16b "
        f"({MLA_Q_LAYERS} layers) | grok: bf16 grok-1-314b ({GROK_LAYERS} layers) | whisper: "
        f"bf16 whisper-medium (24 + 24 layers, splice path) | vision: bf16 "
        f"llama-3.2-vision-11b (40 + 8 cross layers, splice path), the same 4 + 1 requests")
    for key, what in (("ttft_median_ms", "TTFT median ms"), ("ttft_max_ms", "TTFT max ms"),
                      ("tok_s_session", "decode tok/s per session"),
                      ("tok_s_all", "tok/s over all 4 sessions"),
                      ("peak_gib", "peak device memory while serving GiB"),
                      ("build_peak_gib", "peak device memory building GiB"),
                      ("weight_gb", "HPC weight_bytes GB"),
                      ("pool_bytes", "HPC pool_bytes"),
                      ("bytes_copied_per_admission", "bytes copied per admission"),
                      ("engine_tok_s", "engine alone tok/s"),
                      ("engine_ttft_median_ms", "engine alone TTFT median ms"),
                      ("step_ms", "B=8 step wall ms"), ("dev_ms", "B=8 step device ms"),
                      ("host_ops_ms", "B=8 step host ms in ops (profiled)"),
                      ("n_launch", "B=8 step device kernels"),
                      ("busy", "B=8 step device busy share"),
                      ("piece_ms", "16-token prefill piece wall ms"),
                      ("piece_dev_ms", "16-token prefill piece device ms"),
                      ("piece_launch", "16-token prefill piece device kernels"),
                      ("piece_busy", "16-token prefill piece device busy share")):
        log(f"compare {what:38s} " + "  ".join(
            f"{label} {stats[key]:14.4f}" for label, (_, stats) in paths.items()))

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(l[name] for l, _ in paths.values())
                        + sum(l[name] for l, _ in specs.values())
                        + sum(l[name] for l, _ in rolling.values()) + fleet[0][name]
                        + sum(l[name] for l, _ in trains.values()) + dist_launch[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **({"shapes": r["shapes"]} if "shapes" in r else {})})
    for arch, (_, train) in trains.items():
        log(f"{card}: training path ({arch}, batch {TRAIN_BATCH}): step "
            f"{train['step_ms']:.1f} ms, {train['tok_s']:.0f} tokens/s, device "
            f"{train['dev_ms']:.1f} ms, busy {train['busy'] * 100:.0f}%, peak "
            f"{train['peak_gib']:.2f} GiB, losses {[round(x, 4) for x in train['losses']]}"
            + (f", ssd gradients {train['ssd_grad_share']:.1%} of the step's device time"
               if "ssd_grad_share" in train else ""))
    log(f"{card}: flash_attention backward at minitron-8b's training shape "
        f"{rows['flash_attention_bwd']['ms']:.4f} ms (SDPA's "
        f"{rows['flash_attention_bwd']['library_ms']:.4f} ms, bound "
        f"{rows['flash_attention_bwd']['bound_ms']:.5f} ms)")
    if not all(math.isfinite(k[key]) for k in kernels
               for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
        raise AssertionError("a kernel figure is not finite")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
